"""SimResult: a readout handle over the final COMPRESSED state.

The engine exists so states too big to materialize can be simulated;
reading results out must honor the same constraint.  Every reader here
streams the two-level store block-by-block — peak extra memory is ~one
decoded SV block (2^b amplitudes), never the 2^n state:

    sample(shots)        two-pass: block-mass CDF, then decode only the
                         blocks that received shots (multinomial)
    expectation(diag_fn) <psi|D|psi> for diagonal observables, one pass
    probabilities(qs)    marginal distribution over a qubit subset
    amplitudes(indices)  decode only the blocks containing the indices
    statevector()        the explicit opt-in: materializes 2^n

The module-level ``stream_*`` functions are the implementation and take a
bare ``(backend, n, b)`` triple, so they serve both :class:`SimResult`
and the legacy free functions in :mod:`repro_torch.core.measure`.

A :class:`SimResult` is a *live handle*: it reads the owning session's
store in place (zero-copy).  The next ``Simulator.run()`` overwrites that
store, which invalidates the handle — stale reads raise; call
:meth:`SimResult.save` first to persist a result across runs.
"""
from __future__ import annotations

import warnings
from typing import Sequence

import numpy as np

__all__ = ["SimResult", "BatchResult", "stream_block_masses",
           "stream_sample", "stream_expectation", "stream_marginal",
           "gather_amplitudes", "collect_statevector"]

#: lossy-tail tolerance: beyond this drift of the total probability mass
#: from 1.0 the readout warns (the b_r bound should keep drift tiny)
NORM_DRIFT_TOL = 1e-2

# above this the opt-in statevector() materialization refuses without
# force=True (2^28 complex64 = 2 GiB — defeats the engine's entire point)
_STATEVECTOR_GUARD_QUBITS = 27


def _normalized_masses(masses: np.ndarray, what: str) -> np.ndarray:
    """Renormalize block masses, warning when the lossy tail drifted."""
    total = masses.sum()
    if total <= 0.0:
        raise ValueError(f"{what}: compressed state has zero norm")
    if not np.isclose(total, 1.0, atol=NORM_DRIFT_TOL):
        warnings.warn(
            f"{what}: total probability mass of the compressed state is "
            f"{total:.6f} (codec error drifted beyond {NORM_DRIFT_TOL}); "
            "renormalizing — consider a tighter b_r",
            RuntimeWarning, stacklevel=3)
    return masses / total


def stream_block_masses(backend, n: int, b: int) -> np.ndarray:
    """(2^(n-b),) probability mass per SV block (one streaming pass)."""
    n_blocks = 2 ** (n - b)
    masses = np.empty(n_blocks, np.float64)
    for blk in range(n_blocks):
        amps = backend.decode_host_block(blk)
        masses[blk] = float(np.sum(np.abs(amps) ** 2))
    return masses


def stream_sample(backend, n: int, b: int, n_shots: int,
                  seed: int = 0) -> dict[int, int]:
    """Sample ``n_shots`` computational-basis outcomes -> {index: count}.

    Pass 1 builds the block-level CDF; pass 2 decodes ONLY the blocks the
    multinomial assigned shots to.
    """
    rng = np.random.default_rng(seed)
    masses = _normalized_masses(stream_block_masses(backend, n, b),
                                "sample")
    per_block = rng.multinomial(n_shots, masses)
    counts: dict[int, int] = {}
    bsz = 2 ** b
    for blk in np.nonzero(per_block)[0]:
        amps = backend.decode_host_block(int(blk))
        p = np.abs(amps) ** 2
        p = p / p.sum()
        idx = rng.choice(bsz, size=int(per_block[blk]), p=p)
        base = int(blk) << b
        for i in idx:
            key = base | int(i)
            counts[key] = counts.get(key, 0) + 1
    return counts


def stream_expectation(backend, n: int, b: int, diag_fn) -> float:
    """<psi| D |psi> for a diagonal observable, streamed per block.

    ``diag_fn(indices) -> values``: vectorized diagonal entries for global
    basis indices (e.g. a QAOA MaxCut cost function).
    """
    bsz = 2 ** b
    n_blocks = 2 ** (n - b)
    local = np.arange(bsz, dtype=np.int64)
    acc = 0.0
    norm = 0.0
    for blk in range(n_blocks):
        amps = backend.decode_host_block(blk)
        p = np.abs(amps) ** 2
        vals = diag_fn((blk << b) | local)
        acc += float(np.sum(p * vals))
        norm += float(p.sum())
    _normalized_masses(np.asarray([norm]), "expectation")  # drift warning
    return acc / norm


def stream_marginal(backend, n: int, b: int,
                    qubits: Sequence[int]) -> np.ndarray:
    """Marginal probability distribution over ``qubits`` (streamed).

    Bit ``j`` of the returned index is the basis value of ``qubits[j]``;
    the accumulator is 2^len(qubits) float64 — keep the subset small.
    """
    qubits = list(qubits)
    if len(set(qubits)) != len(qubits):
        raise ValueError(f"duplicate qubits in {qubits}")
    for q in qubits:
        if not 0 <= q < n:
            raise ValueError(f"qubit {q} out of range for n={n}")
    bsz = 2 ** b
    n_blocks = 2 ** (n - b)
    local = np.arange(bsz, dtype=np.int64)
    # the local-qubit part of each amplitude's marginal index is
    # block-invariant — precompute it once
    local_part = np.zeros(bsz, dtype=np.int64)
    for j, q in enumerate(qubits):
        if q < b:
            local_part |= ((local >> q) & 1) << j
    out = np.zeros(2 ** len(qubits), np.float64)
    for blk in range(n_blocks):
        amps = backend.decode_host_block(blk)
        gidx = blk << b
        base = 0
        for j, q in enumerate(qubits):
            if q >= b:
                base |= ((gidx >> q) & 1) << j
        np.add.at(out, base | local_part, np.abs(amps) ** 2)
    return _normalized_masses(out, "probabilities")


def gather_amplitudes(backend, n: int, b: int,
                      indices: Sequence[int]) -> np.ndarray:
    """Amplitudes at global basis ``indices``, decoding each needed block
    once (complex64, in input order)."""
    idx = np.asarray(indices, dtype=np.int64)
    if idx.size and (idx.min() < 0 or idx.max() >= 2 ** n):
        raise ValueError(f"index out of range for n={n}")
    out = np.empty(idx.shape, np.complex64)
    blocks = idx >> b
    local = idx & ((1 << b) - 1)
    for blk in np.unique(blocks):
        amps = backend.decode_host_block(int(blk))
        sel = blocks == blk
        out[sel] = amps[local[sel]]
    return out


def collect_statevector(backend, n: int, b: int) -> np.ndarray:
    """Decode every block into the full 2^n complex64 state."""
    n_blocks = 2 ** (n - b)
    parts = [backend.decode_host_block(blk) for blk in range(n_blocks)]
    return np.concatenate(parts)


class SimResult:
    """Handle over one run's final compressed state (see module docs).

    Obtained from :meth:`Simulator.run` / :meth:`Simulator.result`; all
    readers stream the store block-by-block.  The handle stays valid until
    the owning session runs again or closes; :meth:`save` persists it.
    """

    def __init__(self, backend, n_qubits: int, local_bits: int, stats=None,
                 owner=None, generation: int = 0):
        self._backend = backend
        self.n_qubits = n_qubits
        self.local_bits = local_bits
        self.stats = stats
        self._owner = owner
        self._generation = generation

    def __repr__(self) -> str:
        return (f"SimResult(n_qubits={self.n_qubits}, "
                f"local_bits={self.local_bits}, "
                f"n_blocks={2 ** (self.n_qubits - self.local_bits)})")

    # -- liveness --------------------------------------------------------------
    def _live(self):
        """The handle reads the session's store in place; a newer run has
        overwritten it -> this result no longer exists."""
        if self._owner is not None and \
                self._owner._generation != self._generation:
            raise RuntimeError(
                "stale SimResult: the owning Simulator ran again and "
                "overwrote the compressed store this handle reads; call "
                "result.save(path) before the next run to keep a result")
        return self._backend

    # -- streaming readers -----------------------------------------------------
    def sample(self, n_shots: int, seed: int = 0) -> dict[int, int]:
        """Sample computational-basis bitstrings -> {basis index: count}."""
        return stream_sample(self._live(), self.n_qubits, self.local_bits,
                             n_shots, seed=seed)

    def expectation(self, diag_fn) -> float:
        """<psi|D|psi> for a diagonal observable ``diag_fn(indices)->vals``."""
        return stream_expectation(self._live(), self.n_qubits,
                                  self.local_bits, diag_fn)

    def probabilities(self, qubits: Sequence[int] | None = None) -> np.ndarray:
        """Measurement distribution over ``qubits`` (default: all).

        Streamed block-by-block; the accumulator is 2^len(qubits)
        float64, so pass a subset at large n.  ``qubits=None`` allocates
        the full 2^n distribution (8 bytes/entry — as large as the
        complex64 state) and is therefore guarded like
        :meth:`statevector`; passing an explicit ``qubits=range(n)`` is
        the opt-in.
        """
        if qubits is None:
            if self.n_qubits > _STATEVECTOR_GUARD_QUBITS:
                raise MemoryError(
                    f"probabilities() over all {self.n_qubits} qubits "
                    f"materializes {2 ** (self.n_qubits + 3) / 2**30:.1f} "
                    "GiB; pass a qubit subset (or an explicit "
                    "qubits=range(n) if you really mean it)")
            qubits = range(self.n_qubits)
        return stream_marginal(self._live(), self.n_qubits, self.local_bits,
                               qubits)

    def block_probabilities(self) -> np.ndarray:
        """Raw (un-normalized) probability mass per SV block."""
        return stream_block_masses(self._live(), self.n_qubits,
                                   self.local_bits)

    def amplitudes(self, indices: Sequence[int]) -> np.ndarray:
        """Amplitudes at the given global basis indices (complex64)."""
        return gather_amplitudes(self._live(), self.n_qubits,
                                 self.local_bits, indices)

    def statevector(self, force: bool = False) -> np.ndarray:
        """Materialize the full 2^n complex64 state — the explicit opt-in
        that defeats the memory budget; refuses above
        2^{_STATEVECTOR_GUARD_QUBITS} amplitudes unless ``force=True``."""
        if self.n_qubits > _STATEVECTOR_GUARD_QUBITS and not force:
            raise MemoryError(
                f"statevector() at n={self.n_qubits} materializes "
                f"{2 ** (self.n_qubits + 3) / 2**30:.1f} GiB; pass "
                "force=True if you really mean it")
        return collect_statevector(self._live(), self.n_qubits,
                                   self.local_bits)

    # -- persistence -----------------------------------------------------------
    def save(self, path: str) -> None:
        """Checkpoint the compressed blocks + layout to ``path`` (see
        :meth:`Simulator.resume`)."""
        self._live()
        if self._owner is None:
            raise RuntimeError("this SimResult has no owning session to "
                               "serialize from")
        self._owner._save_checkpoint(path)


class _LaneView:
    """Read-only decode view over one batch lane's key range: lane ``j``
    of a batched run stores its blocks under keys offset by
    ``j * 2^(n-b)``, and every streaming reader only needs
    ``decode_host_block`` — so a thin key-shifting shim turns the shared
    backend into lane ``j``'s."""

    def __init__(self, backend, offset: int):
        self._backend = backend
        self._offset = offset

    def decode_host_block(self, key: int) -> np.ndarray:
        return self._backend.decode_host_block(self._offset + key)


class BatchResult:
    """Readout handle over a batched run's K final compressed states.

    Obtained from :meth:`Simulator.run_batch` /
    ``Simulator.run(trajectories=K)``.  ``result[j]`` (or
    ``result.lanes[j]``) is lane j's full :class:`SimResult` view —
    sampling, expectations, amplitudes, all streaming the shared store
    through a key-shifted lane window.  :meth:`expectation` averages a
    diagonal observable across lanes: for noise trajectories that is the
    Monte-Carlo estimate of the noisy expectation value.

    Like :class:`SimResult`, the handle is live — the owning session's
    next run invalidates it (including every lane view).
    """

    def __init__(self, backend, n_qubits: int, local_bits: int,
                 n_lanes: int, stats=None, owner=None, generation: int = 0):
        self.n_qubits = n_qubits
        self.local_bits = local_bits
        self.stats = stats
        n_blocks = 2 ** (n_qubits - local_bits)
        self.lanes = [
            SimResult(_LaneView(backend, lane * n_blocks), n_qubits,
                      local_bits, stats=stats, owner=owner,
                      generation=generation)
            for lane in range(n_lanes)
        ]

    def __repr__(self) -> str:
        return (f"BatchResult(n_qubits={self.n_qubits}, "
                f"local_bits={self.local_bits}, n_lanes={len(self.lanes)})")

    def __len__(self) -> int:
        return len(self.lanes)

    def __getitem__(self, lane: int) -> SimResult:
        return self.lanes[lane]

    def __iter__(self):
        return iter(self.lanes)

    def expectations(self, diag_fn) -> np.ndarray:
        """Per-lane ``<psi_j|D|psi_j>`` for a diagonal observable."""
        return np.asarray([lane.expectation(diag_fn) for lane in self.lanes])

    def expectation(self, diag_fn) -> float:
        """Lane-averaged diagonal expectation — the trajectory estimate
        of the noisy observable (for a parameter sweep it is just the
        mean over bindings)."""
        return float(self.expectations(diag_fn).mean())
