"""Dense (uncompressed) state-vector engine — the reference oracle.

``simulate_dense`` keeps the full state in one tensor and applies the
circuit gate by gate (transpose-to-minor + GEMM).  The compressed engine
and the fidelity numbers are validated against it.  Everything runs on the
device the state lives on: ``cuda:0`` unless the caller passes ``device``
(or an ``initial`` state) elsewhere.

``simulate_dense_sharded`` is the SV-Sim-like baseline: the state split
over several devices, with explicit exchanges where a gate touches a
sharded qubit.
"""
from __future__ import annotations

import numpy as np
import torch

from .circuit import Circuit, Gate
from .devices import full_f32_products, resolve_device

__all__ = [
    "apply_gate_dense",
    "apply_matrix",
    "initial_state",
    "simulate_dense",
    "simulate_dense_sharded",
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
    target qubits to the minor-most axes (qubits[0] last), GEMM (in full
    f32 on CUDA whatever the caller's TF32 flags), undo.
    """
    k = len(qubits)
    mat = torch.as_tensor(mat, device=state.device).to(state.dtype)
    axes = [n - 1 - q for q in qubits]          # tensor axis of each target
    rest = [a for a in range(n) if a not in axes]
    # new axis order: rest ... then qubits[k-1] ... qubits[0]
    perm = rest + [axes[j] for j in range(k - 1, -1, -1)]
    t = state.reshape((2,) * n).permute(perm).reshape(-1, 2 ** k)
    with full_f32_products(state.device):
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


def simulate_dense_sharded(circuit: Circuit, devices,
                           dtype=torch.complex64) -> list[torch.Tensor]:
    """SV-Sim-like baseline: the state split over ``devices``.

    D = ``len(devices)`` must divide 2^n (a power of two, at most 2^n).
    The D slices shard the most significant log2(D) qubits: slice d, on
    ``devices[d]`` (which may repeat), holds amplitudes [d·2^n/D,
    (d+1)·2^n/D).  A gate on local qubits applies to every slice in place
    of the whole state.  A gate touching j sharded qubits exchanges
    explicitly: each group of 2^j slices that differ only in those qubits
    moves to the device of its first slice, the gate applies there to the
    group as one state of n - log2(D) + j qubits, and the slices move back
    (for one sharded target, slice pairs): the communication that BMQSIM's
    independent SV groups avoid.  Products run in full f32 as
    :func:`simulate_dense`'s do.  Returns the D slices in order;
    ``torch.cat`` of them (on one device) is the flat 2^n state.
    """
    n = circuit.n_qubits
    devs = [torch.device(d) for d in devices]
    D = len(devs)
    if D < 1 or D & (D - 1) or D > 2 ** n:
        raise ValueError(f"{D} devices do not divide a state of 2^{n} "
                         "amplitudes (want a power of two <= 2^n)")
    nl = n - (D.bit_length() - 1)              # qubits local to a slice
    slices = []
    for d, dev in enumerate(devs):
        x = torch.zeros((2 ** nl,), dtype=dtype, device=dev)
        if d == 0:
            x[0] = 1.0
        slices.append(x)
    with torch.no_grad():
        for gate in circuit.gates:
            hi = [q for q in gate.qubits if q >= nl]
            if not hi:
                slices = [apply_matrix(x, gate.matrix, gate.qubits, nl)
                          for x in slices]
                continue
            # sharded target i becomes local qubit nl + i of the group
            bits = [q - nl for q in hi]
            mask = sum(1 << b for b in bits)
            local = tuple(nl + hi.index(q) if q in hi else q
                          for q in gate.qubits)
            out = list(slices)
            for base in range(D):
                if base & mask:
                    continue
                members = [base | sum(((c >> i) & 1) << b
                                      for i, b in enumerate(bits))
                           for c in range(2 ** len(bits))]
                home = devs[base]
                group = torch.cat([slices[d].to(home) for d in members])
                group = apply_matrix(group, gate.matrix, local,
                                     nl + len(bits))
                for c, d in enumerate(members):
                    out[d] = group[c * 2 ** nl:(c + 1) * 2 ** nl].to(devs[d])
            slices = out
    return slices
