"""Deterministic, checkpointable data pipeline.

Production shape: each host draws its own disjoint shard of the global
batch from a seeded stateless generator (step -> batch is a pure
function), so (1) restart-after-failure replays the exact stream from the
checkpointed step with no iterator state to persist beyond an int, and
(2) elastic re-sharding (host count change) re-partitions the SAME global
stream.  A file-backed source (memory-mapped token file) slots in behind
the same interface.

A copy of ``repro/train/data.py`` (numpy only): both packages draw the same
batches for the same seed, step and shard.  :class:`BatchRows` is the
port's own: a data-parallel rank's rows of the global batch, which is what
``repro``'s jitted step over a mesh trains on (``n_shards``/``shard`` draw
other data).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["SyntheticTokens", "FileTokens", "BatchRows", "make_batches"]


@dataclass(frozen=True)
class SyntheticTokens:
    """Stateless synthetic LM stream: batch = f(seed, step, shard)."""

    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_shards: int = 1
    shard: int = 0

    @property
    def shard_batch(self) -> int:
        assert self.global_batch % self.n_shards == 0
        return self.global_batch // self.n_shards

    def batch(self, step: int) -> np.ndarray:
        """(shard_batch, seq_len) int32 — a Zipf-ish mixture so losses move."""
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.shard]))
        b = self.shard_batch
        # mixture: local n-gram structure + global skew -> learnable signal
        base = rng.zipf(1.3, size=(b, self.seq_len)).astype(np.int64)
        toks = base % (self.vocab - 3)
        # inject copy structure: second half repeats first half shifted
        half = self.seq_len // 2
        toks[:, half:half * 2] = toks[:, :half]
        return toks.astype(np.int32)


@dataclass(frozen=True)
class FileTokens:
    """Memory-mapped flat token file (uint16/uint32), random-access crops."""

    path: str
    vocab: int
    seq_len: int
    global_batch: int
    dtype: str = "uint16"
    seed: int = 0
    n_shards: int = 1
    shard: int = 0

    @property
    def shard_batch(self) -> int:
        return self.global_batch // self.n_shards

    def batch(self, step: int) -> np.ndarray:
        data = np.memmap(self.path, dtype=self.dtype, mode="r")
        n = data.shape[0] - self.seq_len - 1
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.shard]))
        starts = rng.integers(0, n, size=self.shard_batch)
        out = np.stack([data[s:s + self.seq_len] for s in starts])
        return (out.astype(np.int64) % self.vocab).astype(np.int32)


@dataclass(frozen=True)
class BatchRows:
    """Rows ``[block·b, (block+1)·b)`` of ``source``'s batch, b its rows
    over ``n_blocks``: a data-parallel rank's share of the global batch,
    so a sharded step trains on the one-device step's data."""

    source: object
    n_blocks: int
    block: int

    def batch(self, step: int) -> np.ndarray:
        full = self.source.batch(step)
        if full.shape[0] % self.n_blocks:
            raise ValueError(f"a batch of {full.shape[0]} rows does not "
                             f"split over {self.n_blocks} data ranks")
        b = full.shape[0] // self.n_blocks
        return full[self.block * b:(self.block + 1) * b]


def make_batches(source, start_step: int = 0):
    """Infinite iterator of (step, batch) resuming at ``start_step``."""
    step = start_step
    while True:
        yield step, source.batch(step)
        step += 1
