"""Dense (uncompressed) state-vector engine — the reference oracle.

``simulate_dense`` keeps the full state in one tensor and applies the
circuit gate by gate (transpose-to-minor + GEMM).  The compressed engine
and the fidelity numbers are validated against it.  Everything runs on the
device the state lives on: ``cuda:0`` unless the caller passes ``device``
(or an ``initial`` state) elsewhere.

The sharded baseline (``simulate_dense_sharded``) is not ported yet.
"""
from __future__ import annotations

import numpy as np
import torch

from .circuit import Circuit, Gate
from .devices import resolve_device

__all__ = [
    "apply_gate_dense",
    "apply_matrix",
    "initial_state",
    "simulate_dense",
]


def initial_state(n: int, dtype=torch.complex64, device=None) -> torch.Tensor:
    """|0...0> as a flat 2^n vector."""
    state = torch.zeros((2 ** n,), dtype=dtype, device=resolve_device(device))
    state[0] = 1.0
    return state


def apply_matrix(state: torch.Tensor, mat, qubits: tuple[int, ...],
                 n: int) -> torch.Tensor:
    """Apply a 2^k x 2^k unitary to ``qubits`` of a flat 2^n state.

    Little-endian: qubit q is bit q of the flat index; ``qubits[j]`` is bit j
    of the matrix row/column index.  Implementation: view the state as an
    n-dim (2,)*n tensor whose axis a holds qubit (n-1-a), transpose the
    target qubits to the minor-most axes (qubits[0] last), GEMM, undo.
    """
    k = len(qubits)
    mat = torch.as_tensor(mat, device=state.device).to(state.dtype)
    axes = [n - 1 - q for q in qubits]          # tensor axis of each target
    rest = [a for a in range(n) if a not in axes]
    # new axis order: rest ... then qubits[k-1] ... qubits[0]
    perm = rest + [axes[j] for j in range(k - 1, -1, -1)]
    t = state.reshape((2,) * n).permute(perm).reshape(-1, 2 ** k)
    t = t @ mat.T
    inv = np.argsort(np.asarray(perm)).tolist()
    return t.reshape([2] * n).permute(inv).reshape(-1)


def apply_gate_dense(state: torch.Tensor, gate: Gate, n: int) -> torch.Tensor:
    return apply_matrix(state, gate.matrix, gate.qubits, n)


def simulate_dense(circuit: Circuit, dtype=torch.complex64,
                   initial: torch.Tensor | None = None,
                   device=None) -> torch.Tensor:
    """Reference simulation: returns the final flat 2^n state (on
    ``initial``'s device when given, else on ``device``)."""
    n = circuit.n_qubits
    if initial is None:
        state = initial_state(n, dtype, device)
    else:
        state = torch.as_tensor(initial).to(dtype)
    with torch.no_grad():
        for gate in circuit.gates:
            state = apply_matrix(state, gate.matrix, gate.qubits, n)
    return state
