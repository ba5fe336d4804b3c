"""Stage pipeline: load/decode → compute → encode/store (paper §4.1/§4.2).

One stage of the partitioned simulation processes every SV group through
three phases:

    1. load/decode   — fetch the group's 2^m blocks from the two-level
                       store and produce the flat 2^(b+m) device array
    2. compute       — apply the stage's fused unitaries on-device
    3. encode/store  — compress the updated blocks back into the store

:class:`StagePipeline` owns the phase orchestration; a
:class:`CodecBackend` decides *where the codec runs*.  This port has the
host backend (:class:`HostCodecBackend`): blocks are fully decompressed on
the host and the **raw** 2^(b+m) complex64 group array crosses the
host↔device boundary (8 bytes/amplitude each way).  The device-resident
codec (``codec_backend="device"``) comes with the codec kernels and raises
until then.

The pipeline is **wave-coalesced and double-buffered**, as in the JAX
package:

* ``pipeline_depth`` is the *wave width*: ``depth`` consecutive groups are
  coalesced into one wave that flows through the backend's ``*_batch``
  hooks — one stacked boundary crossing and one stage-function call per
  phase cover the whole wave.
* the device work of a wave is queued on the current CUDA stream: the
  h2d copy comes from pinned host memory with ``non_blocking=True``, the
  kernels follow in stream order, and the d2h copy lands in a pinned
  buffer behind a recorded event.  Nothing blocks until
  ``await_result_batch`` waits on that event — the only blocking point —
  and it sits in a bounded **in-flight window**: wave *w*'s result is
  awaited only after wave *w+1*'s compute has been queued.
* the host codec halves run on small worker pools behind a completion
  **ready-queue** (fetches submitted ahead, consumed in completion order;
  stores drain through one worker and are barriered per stage).

``depth=1`` degenerates to a strictly sequential
fetch→stage→compute→await→store loop on the caller's thread.  On a
single-core host depth>1 keeps the wave coalescing but also runs on the
caller's thread, unless ``fetch_workers`` asks for pools.
"""
from __future__ import annotations

import os
import queue
import threading
import time
import warnings
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..compression.codec import decode_block_host, encode_block_host
from ..compression.pwrel import PwRelParams
from ..compression.store import BlockStore
from ..errors import BlockCorruptionError, StoreIOError
from .faults import fault_point

__all__ = ["CodecBackend", "HostCodecBackend", "StagePipeline",
           "make_backend", "complex_to_planes", "planes_to_complex"]


def complex_to_planes(amps: torch.Tensor) -> torch.Tensor:
    """(..., n) complex64 -> (..., 2, n) f32 re/im plane stacks."""
    return torch.view_as_real(amps).movedim(-1, -2).contiguous()


def planes_to_complex(planes: torch.Tensor) -> torch.Tensor:
    """(..., 2, n) f32 plane stacks -> (..., n) complex64."""
    return torch.complex(planes[..., 0, :], planes[..., 1, :])


class CodecBackend:
    """Where the block codec runs, as phase hooks over row batches.

    ``fetch_group_batch`` / ``store_group_batch`` are the *host* halves
    (called from worker threads; numpy/zlib and CPU torch only — they
    never touch the card).  The *device* halves run on the dispatch
    thread and are split at the blocking boundary:

    * ``stage_to_device_batch`` — host staging -> device planes; queues
      the copy, never blocks.
    * ``dispatch_result_batch`` — device planes -> an opaque in-flight
      *ticket* (the plane→complex conversion and the d2h copy are
      queued here); never blocks.
    * ``await_result_batch`` — ticket -> host result object; the ONLY
      blocking device wait in the pipeline.

    ``key_rows`` is an (R, 2^m) store-key table: one row of block keys per
    group of the wave.

    Byte counters ``h2d_bytes`` / ``d2h_bytes`` accumulate the size of
    every array that crosses the host↔device boundary.  Phase hooks run
    concurrently on worker threads, so ALL counter updates go through
    :meth:`add_bytes` / :meth:`add_counts` under ``_count_lock``.

    Args:
        store: the two-level block store.
        params: pwrel bound shared by both codec halves.
        bsz: amplitudes per SV block (2^b, engine-constant).
        compression: False = raw complex64 blocks (Fig. 11 baseline).
        prescan: bitmap pre-scan RLE in the lossless stage (§4.3).
        pin_memory: stage host buffers in page-locked memory so the
            boundary copies run asynchronously (set for CUDA devices).
    """

    name: str = "abstract"

    def __init__(self, store: BlockStore, params: PwRelParams, bsz: int,
                 compression: bool = True, prescan: bool = True,
                 *, pin_memory: bool = False):
        self.store = store
        self.params = params
        self.bsz = bsz
        self.compression = compression
        self.prescan = prescan
        self.pin_memory = pin_memory
        # phase hooks run in concurrent worker threads; counter updates
        # are read-modify-write, so the fields below may only be touched
        # inside 'with self._count_lock:' — mutate through add_counts /
        # add_bytes
        self.h2d_bytes = 0                     # guarded-by: _count_lock
        self.d2h_bytes = 0                     # guarded-by: _count_lock
        self.n_decompressions = 0              # guarded-by: _count_lock
        self.n_compressions = 0                # guarded-by: _count_lock
        self._count_lock = threading.Lock()

    def add_counts(self, decompressions: int = 0,
                   compressions: int = 0) -> None:
        with self._count_lock:
            self.n_decompressions += decompressions
            self.n_compressions += compressions

    def add_bytes(self, h2d: int = 0, d2h: int = 0) -> None:
        """Locked accumulation of the boundary byte ledger."""
        with self._count_lock:
            self.h2d_bytes += h2d
            self.d2h_bytes += d2h

    # -- host block codec (also used for init/collect outside the pipeline) --
    def encode_host_block(self, key: int, amps: np.ndarray) -> None:
        """Compress one np block on the host and store it under ``key``."""
        fault_point("codec.encode")
        if not self.compression:
            self.store.put(key, np.asarray(amps, np.complex64).tobytes())
        else:
            self.store.put_block(
                key, encode_block_host(amps, self.params,
                                       prescan=self.prescan))

    def decode_host_block(self, key: int) -> np.ndarray:
        """Fetch the block under ``key`` and decompress it on the host."""
        fault_point("codec.decode")
        if not self.compression:
            return np.frombuffer(self.store.get(key), dtype=np.complex64)
        return decode_block_host(self.store.get_block(key), self.params)

    # -- row-batched phase hooks ---------------------------------------------
    def fetch_group_batch(self, key_rows: np.ndarray):
        """Worker thread: store -> host staging for all rows."""
        raise NotImplementedError

    def stage_to_device_batch(self, staged, device) -> torch.Tensor:
        """Dispatch thread: host staging -> (R, 2, 2^(b+m)) f32 plane
        stacks on ``device`` (queued, never blocks)."""
        raise NotImplementedError

    def dispatch_result_batch(self, planes_dev: torch.Tensor, n_blocks: int):
        """Dispatch thread: (R, 2, N) device planes -> in-flight ticket
        (queued; MUST NOT block)."""
        raise NotImplementedError

    def await_result_batch(self, ticket):
        """Dispatch thread: ticket -> per-row host result objects (the
        pipeline's blocking boundary wait)."""
        raise NotImplementedError

    def store_group_batch(self, key_rows: np.ndarray, results) -> None:
        """Worker thread: per-row host results -> store."""
        raise NotImplementedError


class HostCodecBackend(CodecBackend):
    """Baseline: the full codec runs on the host.

    Raw 2^(b+m) complex64 group arrays cross the host↔device boundary in
    both directions.  Also the only backend usable with
    ``compression=False``.
    """

    name = "host"

    def _host_buffer(self, shape) -> torch.Tensor:
        return torch.empty(shape, dtype=torch.complex64,
                           pin_memory=self.pin_memory)

    def fetch_group_batch(self, key_rows):
        # decode straight into one (pinned) host buffer for the wave — no
        # per-group concatenate, and the h2d copy can run asynchronously
        rows, n_blocks = key_rows.shape
        buf = self._host_buffer((rows, n_blocks * self.bsz))
        flat = buf.numpy()
        for r, row in enumerate(key_rows):
            for i, bid in enumerate(row):
                flat[r, i * self.bsz:(i + 1) * self.bsz] = \
                    self.decode_host_block(int(bid))
        self.add_counts(decompressions=key_rows.size)
        return buf

    def stage_to_device_batch(self, staged, device):
        self.add_bytes(h2d=staged.nbytes)
        return complex_to_planes(staged.to(device, non_blocking=True))

    def dispatch_result_batch(self, planes_dev, n_blocks):
        amps = planes_to_complex(planes_dev)
        if amps.device.type == "cpu":
            return amps, None
        out = self._host_buffer(tuple(amps.shape))
        out.copy_(amps, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(amps.device))
        return out, done

    def await_result_batch(self, ticket):
        out, done = ticket
        if done is not None:
            done.synchronize()                    # blocking wait
        arr = out.numpy()
        self.add_bytes(d2h=arr.nbytes)
        return arr                     # (R, 2^(b+m)) complex64

    def store_group_batch(self, key_rows, results):
        for block_ids, result in zip(key_rows, results):
            blocks = np.asarray(result).reshape(len(block_ids), self.bsz)
            for i, bid in enumerate(block_ids):
                self.encode_host_block(int(bid), blocks[i])
            self.add_counts(compressions=len(block_ids))


def make_backend(name: str, store: BlockStore, params: PwRelParams,
                 bsz: int, compression: bool = True, prescan: bool = True,
                 *, pin_memory: bool = False) -> CodecBackend:
    """Resolve an ``EngineConfig.codec_backend`` name to a backend.

    ``"device"`` with compression needs the device codec kernels, which
    this port does not have yet: it raises ``NotImplementedError``.
    Without compression it degrades to ``"host"`` with a
    ``RuntimeWarning``, as in the JAX package — there is no device half to
    a raw byte copy.
    """
    if name == "device" and compression:
        raise NotImplementedError(
            "codec_backend='device' needs the device codec kernels "
            "(quantize/pack/unpack/dequantize), which come in the next "
            "slice of the port (ROADMAP A6); use codec_backend='host'")
    if name == "device":
        warnings.warn(
            "codec_backend='device' requires compression=True; "
            "falling back to the host codec backend",
            RuntimeWarning, stacklevel=2)
    if name in ("host", "device"):
        return HostCodecBackend(store, params, bsz, compression, prescan,
                                pin_memory=pin_memory)
    raise ValueError(f"unknown codec backend {name!r} "
                     "(expected 'host' or 'device')")


#: fetch lookahead beyond the wave being computed (waves, not groups):
#: one decoding while one is staged is the double buffer; more only adds
#: host staging memory without hiding additional latency
_FETCH_LOOKAHEAD = 2

#: in-flight results: wave w's blocking await runs only after wave w+1's
#: compute has been queued (the double-buffered boundary)
_INFLIGHT_WINDOW = 2


class StagePipeline:
    """Orchestrates the per-group load → compute → store loop of a stage.

    ``depth`` is the wave width: ``depth`` consecutive groups coalesce
    into one row-batched call through the backend's ``*_batch`` hooks, and
    up to two waves are in flight at once — wave *w*'s blocking wait
    (``await_result_batch``) runs *after* wave *w+1*'s compute is queued,
    so it hides under device work, while the host codec halves run on the
    fetch/store worker pools behind a completion ready-queue.  ``depth=1``
    is the strictly sequential reference schedule.

    Use as a context manager (owns the worker pools); call
    :meth:`run_stage` once per partition stage, then read the counters off
    ``backend`` and the ``t_*`` attributes:

    ``t_load``    host fetch/decode time (worker threads)
    ``t_compute`` h2d staging + compute + d2h *queueing* time — never a
                  device wait
    ``t_fetch``   blocking ``await_result_batch`` wait at the d2h boundary
    ``t_store``   host encode/store time (worker threads)

    ``n_group_phases`` counts group×stage phase executions — the
    denominator of the planner's per-group calibration.
    """

    def __init__(self, backend: CodecBackend, depth: int = 2,
                 device: torch.device | None = None,
                 fetch_workers: int | None = None):
        self.backend = backend
        self.depth = max(1, depth)
        self.device = torch.device("cpu") if device is None else device
        # fetch pool width.  None = adaptive: one worker per spare core,
        # capped at the lookahead — and NO pools on a single-core host.
        # An explicit >= 1 forces the threaded overlap scheduler; an
        # explicit 0 forces the coalescing-only wave loop.
        self.fetch_workers = fetch_workers
        #: in-flight result window (double buffer); the pressure ladder
        #: shrinks it to 1 between stages
        self.inflight_window = _INFLIGHT_WINDOW
        # t_load/t_store accumulate inside concurrent worker threads and
        # may only be touched under _t_lock; t_compute/t_fetch belong to
        # the dispatch thread alone
        self.t_load = 0.0                      # guarded-by: _t_lock
        self.t_compute = 0.0     # h2d staging + compute queueing
        self.t_fetch = 0.0       # blocking result wait at the d2h boundary
        self.t_store = 0.0                     # guarded-by: _t_lock
        self.n_group_phases = 0
        self._t_lock = threading.Lock()
        self._dec_pool: ThreadPoolExecutor | None = None
        self._com_pool: ThreadPoolExecutor | None = None
        self._entered = False

    def __enter__(self) -> "StagePipeline":
        if self.depth > 1:
            nw = self.fetch_workers
            if nw is None and (os.cpu_count() or 1) > 1:
                nw = min(_FETCH_LOOKAHEAD, os.cpu_count() - 1)
            if nw:
                self._dec_pool = ThreadPoolExecutor(max_workers=nw)
                self._com_pool = ThreadPoolExecutor(max_workers=1)
        self._entered = True
        return self

    def __exit__(self, *exc) -> None:
        if self._dec_pool is not None:
            self._dec_pool.shutdown(wait=True)
            self._com_pool.shutdown(wait=True)
        self._dec_pool = self._com_pool = None
        self._entered = False

    # -- timed phase wrappers (run inside worker threads) ---------------------
    @staticmethod
    def _key_span(keys) -> str:
        flat = np.asarray(keys).reshape(-1)
        if flat.size == 0:
            return "no keys"
        return (f"keys [{int(flat.min())}..{int(flat.max())}] "
                f"({flat.size} blocks)")

    def _load(self, fetch, keys):
        t0 = time.perf_counter()
        try:
            fault_point("pipeline.fetch")
            staged = fetch(keys)
        except (StoreIOError, BlockCorruptionError):
            raise                   # already typed with key/blob context
        except OSError as e:
            raise StoreIOError("pipeline fetch",
                               detail=self._key_span(keys)) from e
        dt = time.perf_counter() - t0
        with self._t_lock:
            self.t_load += dt
        return staged

    def _store(self, store, keys, result):
        t0 = time.perf_counter()
        try:
            fault_point("pipeline.store")
            store(keys, result)
        except (StoreIOError, BlockCorruptionError):
            raise
        except OSError as e:
            raise StoreIOError("pipeline store",
                               detail=self._key_span(keys)) from e
        dt = time.perf_counter() - t0
        with self._t_lock:
            self.t_store += dt

    def run_stage(self, block_ids: np.ndarray, wave_fn, mats) -> None:
        """Run one stage: ``block_ids`` is the (n_groups, 2^m) layout
        table, ``wave_fn`` the row-batched stage update ((R, 2, 2^(b+m))
        planes -> same, updated in place) and ``mats`` its operands."""
        assert self._entered, "use StagePipeline as a context manager"
        n_groups, n_blocks = block_ids.shape
        self.n_group_phases += n_groups
        items = self._wave_items(block_ids)
        if self._dec_pool is None:
            self._run_waves(items, wave_fn, mats, n_blocks)
            return
        self._run_overlapped(items, wave_fn, mats, n_blocks)

    def _wave_items(self, block_ids) -> list[np.ndarray]:
        """Cut one stage into depth-wide key tables (one per wave)."""
        n_groups, _ = block_ids.shape
        W = min(self.depth, n_groups)
        return [block_ids[lo:lo + W] for lo in range(0, n_groups, W)]

    # -- sequential wave loop (depth 1 / coalescing-only hosts) ---------------
    def _run_waves(self, items, wave_fn, mats, n_blocks) -> None:
        """Caller's-thread wave loop: no pools, no lookahead, window 1 —
        the strictly sequential reference schedule."""
        back = self.backend
        for keys in items:
            staged = self._load(back.fetch_group_batch, keys)
            t0 = time.perf_counter()
            planes = back.stage_to_device_batch(staged, self.device)
            out = wave_fn(planes, *mats)
            ticket = back.dispatch_result_batch(out, n_blocks)
            self.t_compute += time.perf_counter() - t0
            t0 = time.perf_counter()
            result = back.await_result_batch(ticket)
            self.t_fetch += time.perf_counter() - t0
            self._store(back.store_group_batch, keys, result)

    # -- the double-buffered wave loop ---------------------------------------
    def _run_overlapped(self, items, wave_fn, mats, n_blocks) -> None:
        back = self.backend
        n_waves = len(items)
        window = self.inflight_window
        ready: queue.SimpleQueue = queue.SimpleQueue()
        outstanding: dict[int, object] = {}
        submitted = 0

        def submit_next():
            nonlocal submitted
            if submitted < n_waves:
                w = submitted
                submitted += 1
                fut = self._dec_pool.submit(self._load,
                                            back.fetch_group_batch,
                                            items[w])
                outstanding[w] = fut
                fut.add_done_callback(lambda _f, w=w: ready.put(w))

        in_flight: deque = deque()     # (wave, ticket) queued, unawaited
        pending_save = []

        def drain_one():
            ow, oticket = in_flight.popleft()
            t0 = time.perf_counter()
            result = back.await_result_batch(oticket)
            self.t_fetch += time.perf_counter() - t0
            pending_save.append(self._com_pool.submit(
                self._store, back.store_group_batch, items[ow], result))

        try:
            for _ in range(min(1 + _FETCH_LOOKAHEAD, n_waves)):
                submit_next()
            for _ in range(n_waves):
                # completion-order ready-queue: take whichever lookahead
                # fetch finished first
                w = ready.get()
                staged = outstanding.pop(w).result()
                t0 = time.perf_counter()
                planes = back.stage_to_device_batch(staged, self.device)
                out = wave_fn(planes, *mats)
                ticket = back.dispatch_result_batch(out, n_blocks)
                self.t_compute += time.perf_counter() - t0
                submit_next()          # keep the fetch lookahead full
                in_flight.append((w, ticket))
                if len(in_flight) >= window:
                    # double buffer: wave w computes on the card while
                    # this (older) wave's blocking wait drains
                    drain_one()
            while in_flight:           # drain the window
                drain_one()
        except BaseException:
            # fail fast without deadlocking the pools: drop queued
            # fetches, let running ones finish (shutdown waits), and
            # surface the ORIGINAL error over any secondary store failure
            for fut in outstanding.values():
                fut.cancel()
            for fut in pending_save:
                try:
                    fut.result()
                except Exception:  # keep the original error
                    pass
            raise
        for fut in pending_save:       # stage barrier (§4.1 semantics)
            fut.result()
