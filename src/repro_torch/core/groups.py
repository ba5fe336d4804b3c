"""SV block / SV group index arithmetic (paper §3 + §4.1, Figs. 1/2/4).

Layout (little-endian): a flat 2^n state splits into 2^c SV blocks of 2^b
amplitudes; block id = the high c bits (*global index*), offset inside a
block = the low b bits (*local index*).

For a stage whose inner set is ``inner = [s_0 < ... < s_{m-1}]`` (global
qubits, each >= b), an *SV group* is the set of 2^m blocks sharing the
same *outer* global bits.  A group is processed as one flat array of
2^(b+m) amplitudes in which:

* local qubit  q (< b)       -> virtual bit  q
* inner qubit  s_j           -> virtual bit  b + j

so every gate in the stage acts entirely inside the group — this is the
paper's Insight, and the reason one (de)compression per stage suffices.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["GroupLayout", "expand_bits"]


def expand_bits(vals: np.ndarray, positions: list[int]) -> np.ndarray:
    """Scatter bit j of each value into bit ``positions[j]`` (vectorized)."""
    vals = np.asarray(vals, dtype=np.int64)
    out = np.zeros_like(vals)
    for j, p in enumerate(positions):
        out |= ((vals >> j) & 1) << p
    return out


@dataclass(frozen=True)
class GroupLayout:
    """Index plumbing for one stage."""

    n_qubits: int
    local_bits: int                 # b
    inner: tuple[int, ...]          # sorted inner global qubits

    @property
    def b(self) -> int:
        return self.local_bits

    @property
    def c(self) -> int:
        return self.n_qubits - self.local_bits

    @property
    def m(self) -> int:
        return len(self.inner)

    @property
    def n_blocks(self) -> int:
        return 1 << self.c

    @property
    def n_groups(self) -> int:
        return 1 << (self.c - self.m)

    @property
    def blocks_per_group(self) -> int:
        return 1 << self.m

    @property
    def group_size(self) -> int:
        """Amplitudes per group = 2^(b+m)."""
        return 1 << (self.b + self.m)

    # -- positions within the c-bit global index ----------------------------
    @property
    def inner_positions(self) -> list[int]:
        return [q - self.b for q in self.inner]

    @property
    def outer_positions(self) -> list[int]:
        inner = set(self.inner_positions)
        return [p for p in range(self.c) if p not in inner]

    # -- block membership ----------------------------------------------------
    def group_block_ids(self) -> np.ndarray:
        """(n_groups, 2^m) array: block id of member i of group g.

        Member order is the inner-assignment order, i.e. member i holds the
        amplitudes whose inner global bits spell the integer i — so simply
        concatenating a group's member blocks yields the flat group array
        with the virtual-bit layout documented above.
        """
        outer_vals = np.arange(self.n_groups, dtype=np.int64)
        inner_vals = np.arange(self.blocks_per_group, dtype=np.int64)
        outer_part = expand_bits(outer_vals, self.outer_positions)  # (G,)
        inner_part = expand_bits(inner_vals, self.inner_positions)  # (M,)
        return outer_part[:, None] | inner_part[None, :]

    # -- gate remapping --------------------------------------------------------
    def virtual_qubit(self, q: int) -> int:
        """Physical qubit -> virtual bit inside the flat group array."""
        if q < self.b:
            return q
        try:
            j = self.inner.index(q)
        except ValueError:
            raise ValueError(
                f"qubit {q} is an outer global index for inner={self.inner}"
            ) from None
        return self.b + j

    def remap_qubits(self, qubits: tuple[int, ...]) -> tuple[int, ...]:
        return tuple(self.virtual_qubit(q) for q in qubits)
