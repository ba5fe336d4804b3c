"""Circuit partitioning — the paper's Algorithm 1 (§4.1).

Given a state-vector layout with ``b`` local bits (block size ``2^b``) and
``c = n - b`` global bits (block count ``2^c``), split the gate list into
*stages* such that the set of **global** qubits targeted inside a stage
(the stage's *inner indices*) never exceeds ``max(inner_size, 2)``.

Within a stage every SV *group* — the ``2^m`` blocks that share the same
*outer* global bits (``m`` = #inner indices) — can be processed with ONE
decompress + ONE recompress, and groups are mutually independent.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from .circuit import Circuit, Gate

__all__ = ["Stage", "Partition", "partition_circuit"]


@dataclass
class Stage:
    """One stage: a run of gates plus its inner (global) index set."""

    gates: list[Gate] = field(default_factory=list)
    inner: list[int] = field(default_factory=list)  # sorted global qubits used

    def global_support(self, b: int) -> set[int]:
        return {q for g in self.gates for q in g.qubits if q >= b}


@dataclass
class Partition:
    n_qubits: int
    local_bits: int            # b
    inner_size: int            # user limit on #inner indices per stage
    stages: list[Stage]

    @property
    def global_bits(self) -> int:
        return self.n_qubits - self.local_bits

    @property
    def n_stages(self) -> int:
        return len(self.stages)

    def compression_count(self) -> int:
        """Number of (de)compression passes over the state vector = #stages
        (vs. #gates for the SC19-Sim per-gate baseline)."""
        return len(self.stages)

    def validate(self) -> None:
        """Invariants: gates partition the circuit in order; per-stage
        global support == recorded inner set and within threshold."""
        thr = max(self.inner_size, 2)
        total = 0
        for st in self.stages:
            sup = st.global_support(self.local_bits)
            assert sup == set(st.inner), (sup, st.inner)
            assert len(sup) <= thr, f"stage global support {sup} > {thr}"
            total += len(st.gates)


def partition_circuit(circuit: Circuit, local_bits: int,
                      inner_size: int = 2) -> Partition:
    """Algorithm 1.  ``local_bits`` = b (SV block size = 2^b amplitudes);
    ``inner_size`` = max #global indices per stage (min 2, for 2-qubit
    gates whose targets both land in the global part)."""
    b = local_bits
    n = circuit.n_qubits
    if not 0 <= b <= n:
        raise ValueError(f"local_bits {b} out of range for n={n}")
    threshold = max(inner_size, 2)
    if threshold > n - b:
        # fewer global bits than the threshold: everything fits in one stage
        threshold = max(n - b, 0)

    stages: list[Stage] = []
    cur = Stage()
    cur_glob: set[int] = set()
    for gate in circuit.gates:
        gate_glob = {q for q in gate.qubits if q >= b}
        merged = cur_glob | gate_glob
        if len(merged) > max(threshold, len(gate_glob)):
            # would exceed — flush current stage (Lines 7-9)
            if cur.gates:
                cur.inner = sorted(cur_glob)
                stages.append(cur)
            cur = Stage()
            cur_glob = set(gate_glob)
        else:
            cur_glob = merged
        cur.gates.append(gate)
    if cur.gates:
        cur.inner = sorted(cur_glob)
        stages.append(cur)

    part = Partition(n_qubits=n, local_bits=b, inner_size=inner_size,
                     stages=stages)
    part.validate()
    return part
