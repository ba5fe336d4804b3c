"""Gate fusion: collapse runs of gates into <= f-qubit unitaries.

TPU adaptation (DESIGN.md §2): instead of SV-Sim's scattered
thread-per-pair updates, a stage's gates are greedily fused into dense
``2^f x 2^f`` unitaries.  With f = 7 the unitary is 128 x 128 — exactly
one MXU tile — and applying it to a group becomes a plain GEMM over the
(transposed) group tensor, which is what ``kernels/gate_apply.py`` runs.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .circuit import Gate

__all__ = ["FusedGate", "fuse_gates", "embed_unitary", "gates_to_unitary"]


@dataclass(frozen=True)
class FusedGate:
    """A fused unitary on ``qubits`` (ascending; qubits[j] = matrix bit j)."""

    qubits: tuple[int, ...]
    matrix: np.ndarray  # (2^k, 2^k) complex128

    @property
    def k(self) -> int:
        return len(self.qubits)

    @property
    def is_diagonal(self) -> bool:
        off = self.matrix - np.diag(np.diag(self.matrix))
        return bool(np.allclose(off, 0.0, atol=1e-12))


def _apply_on_rows(unitary: np.ndarray, mat: np.ndarray,
                   pos: list[int], k: int) -> np.ndarray:
    """Left-multiply ``mat`` acting on bits ``pos`` of the ROW index of a
    (2^k, C) array (C arbitrary columns)."""
    kk = len(pos)
    cols = unitary.shape[1]
    t = unitary.reshape((2,) * k + (cols,))
    axes = [k - 1 - p for p in pos]              # tensor axis of each bit
    rest = [a for a in range(k) if a not in axes]
    perm = rest + [axes[j] for j in range(kk - 1, -1, -1)] + [k]
    t = t.transpose(perm).reshape(-1, 2 ** kk, cols)
    t = np.einsum("ij,ajc->aic", mat, t)
    inv = np.argsort(np.asarray(perm))
    return t.reshape([2] * k + [cols]).transpose(list(inv)).reshape(2 ** k, cols)


def embed_unitary(mat: np.ndarray, gate_qubits: tuple[int, ...],
                  union_qubits: tuple[int, ...]) -> np.ndarray:
    """Embed a gate unitary into the space of ``union_qubits`` (with
    identity on the extra qubits)."""
    k = len(union_qubits)
    pos = [union_qubits.index(q) for q in gate_qubits]
    return _apply_on_rows(np.eye(2 ** k, dtype=np.complex128), mat, pos, k)


def gates_to_unitary(gates: list[Gate],
                     union_qubits: tuple[int, ...]) -> np.ndarray:
    """Product of a gate run as one unitary over ``union_qubits``."""
    k = len(union_qubits)
    u = np.eye(2 ** k, dtype=np.complex128)
    for g in gates:
        pos = [union_qubits.index(q) for q in g.qubits]
        u = _apply_on_rows(u, g.matrix, pos, k)
    return u


def fuse_gates(gates: list[Gate], max_fused_qubits: int = 7) -> list[FusedGate]:
    """Greedy in-order fusion: grow a run while the union support stays
    within ``max_fused_qubits``; flush into one dense unitary otherwise."""
    fused: list[FusedGate] = []
    run: list[Gate] = []
    support: set[int] = set()

    def flush() -> None:
        nonlocal run, support
        if not run:
            return
        union = tuple(sorted(support))
        fused.append(FusedGate(union, gates_to_unitary(run, union)))
        run, support = [], set()

    for g in gates:
        new_support = support | g.support
        if len(new_support) > max_fused_qubits and run:
            flush()
            new_support = set(g.support)
        if len(new_support) > max_fused_qubits:
            raise ValueError(
                f"gate {g.name} spans {len(g.support)} qubits > fusion limit"
            )
        run.append(g)
        support = new_support
    flush()
    return fused
