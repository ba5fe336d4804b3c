"""Measurement readout from a COMPRESSED state — legacy free functions.

.. deprecated::
    These engine-taking wrappers predate the session API; the
    implementation lives in :mod:`repro_torch.core.result` and is reachable as
    :class:`SimResult` methods (``result.sample(...)``,
    ``result.expectation(...)``, ``result.block_probabilities()``), which
    is the stable surface.  Kept for callers holding a bare
    :class:`BMQSimEngine`.

All readers stream the store block-by-block: peak extra memory is one
decoded SV block, matching the engine's working set.  When the lossy
tail drifts the total probability mass beyond tolerance, the readout
renormalizes and emits a ``RuntimeWarning``.
"""
from __future__ import annotations

import numpy as np

from .engine import BMQSimEngine
from .result import (stream_block_masses, stream_expectation,
                     stream_sample)

__all__ = ["sample_counts", "block_probabilities", "expect_diagonal"]


def block_probabilities(engine: BMQSimEngine) -> np.ndarray:
    """(2^c,) probability mass per SV block (one streaming pass)."""
    return stream_block_masses(engine.backend, engine.n, engine.b)


def sample_counts(engine: BMQSimEngine, n_shots: int,
                  seed: int = 0) -> dict[int, int]:
    """Sample ``n_shots`` computational-basis outcomes -> {index: count}."""
    return stream_sample(engine.backend, engine.n, engine.b, n_shots,
                         seed=seed)


def expect_diagonal(engine: BMQSimEngine, diag_fn) -> float:
    """<psi| D |psi> for a diagonal observable, streamed per block.

    ``diag_fn(indices) -> values``: vectorized diagonal entries for global
    basis indices (e.g. a QAOA MaxCut cost function).
    """
    return stream_expectation(engine.backend, engine.n, engine.b, diag_fn)
