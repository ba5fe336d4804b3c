"""Stage pipeline: load/decode → compute → encode/store (paper §4.1/§4.2).

One stage of the partitioned simulation processes every SV group through
three phases:

    1. load/decode   — fetch the group's 2^m blocks from the two-level
                       store and produce the flat 2^(b+m) device array
    2. compute       — apply the stage's fused unitaries on-device
    3. encode/store  — compress the updated blocks back into the store

:class:`StagePipeline` owns the phase orchestration; a
:class:`CodecBackend` decides *where the codec runs*:

``host``   (:class:`HostCodecBackend`)   — the correctness baseline: blocks
    are fully decompressed on the host and the **raw** 2^(b+m) complex64
    group array crosses the host↔device boundary (8 bytes/amplitude each
    way).

``device`` (:class:`DeviceCodecBackend`) — the paper's design: only the
    **compressed wire representation** (u16 codes + ballot sign words +
    ``l_max`` scalars, ~4.25 bytes/amplitude) crosses the boundary; the
    CUDA codec kernels (``csrc/codec.cu``) quantize/dequantize next to the
    compute, one launch per wave each way, and the host keeps only the
    lossless zlib/prescan stage and the store.

Both backends read and write the same stored :class:`BlockSegments`
format, so they are interchangeable mid-simulation.

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

A stage without a row-batched update (the per-gate path,
``gate_schedule=False``) runs strictly sequentially, one group at a time,
through the backends' single-group hooks.

Placement over several devices (:meth:`StagePipeline.run_stage`'s
``lane_shards`` / ``group_devices``) cuts a stage into wave items of
``(keys, device, operands)``, each staged, computed and encoded on its
own device; devices compare by equality, so groups placed on repeats of
one device run exactly the one-device waves (the engine merges the lane
shards of one device before they get here).
"""
from __future__ import annotations

import os
import queue
import threading
import time
import warnings
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple

import numpy as np
import torch

from ..compression.codec import decode_block_host, encode_block_host
from ..compression.device_codec import (PlaneWire, decode_wave, encode_wave,
                                        segments_to_wire, sign_wire_bytes,
                                        wire_to_segments)
from ..compression.pwrel import PwRelParams
from ..compression.store import BlockStore
from ..errors import BlockCorruptionError, StoreIOError
from .devices import resolve_device
from .faults import fault_point

__all__ = ["CodecBackend", "HostCodecBackend", "DeviceCodecBackend",
           "StagePipeline",
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

    # -- single-group phase hooks --------------------------------------------
    #
    # One group is a wave of one row: each hook is the row-batched hook
    # below on a one-row key table, so both paths cross the boundary, count
    # bytes and launch the codec kernels alike (one decode and one encode
    # launch a group on the device codec).

    def fetch_group(self, block_ids: np.ndarray):
        """Worker thread: store -> host staging object for one group."""
        return self.fetch_group_batch(np.asarray(block_ids)[None, :])

    def stage_to_device(self, staged, device) -> torch.Tensor:
        """Dispatch thread: host staging -> (2, 2^(b+m)) f32 device plane
        stack (queued, never blocks)."""
        return self.stage_to_device_batch(staged, device)[0]

    def dispatch_result(self, planes_dev: torch.Tensor, n_blocks: int):
        """Dispatch thread: (2, N) device planes -> in-flight ticket
        (queued; MUST NOT block)."""
        return self.dispatch_result_batch(planes_dev.unsqueeze(0), n_blocks)

    def await_result(self, ticket):
        """Dispatch thread: ticket -> host result object (blocks)."""
        return self.await_result_batch(ticket)[0]

    def store_group(self, block_ids: np.ndarray, result) -> None:
        """Worker thread: host result object -> store."""
        self.store_group_batch(np.asarray(block_ids)[None, :], [result])

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


class _DeviceStaged(NamedTuple):
    """A wave's wire in (pinned) host staging buffers: the first
    ``n_wire`` planes of ``codes``/``sign_bytes``/``l_max`` are filled;
    ``plane_map`` (None when every block is wire) names each one's stack
    plane; ``raws`` holds (row, block, complex64 buffer) per RAW block."""

    codes: torch.Tensor            # (P, n) int16 [u16 bits]
    sign_bytes: torch.Tensor       # (P, 4*ceil(n/32)) uint8
    l_max: torch.Tensor            # (P,) f32
    n_wire: int
    plane_map: torch.Tensor | None  # (n_wire,) int32
    raws: list
    rows: int
    n_blocks: int


class DeviceCodecBackend(CodecBackend):
    """Device-resident lossy codec: compressed wire crosses the boundary.

    Requires ``compression=True`` (the raw-block toggle has no device
    half — use :func:`make_backend`, which falls back to the host
    backend).  A wave's wire crosses in three copies each way and is
    decoded / encoded in one kernel launch each; RAW-escape blocks
    (incompressible data) cross as raw complex64, that block only.
    """

    name = "device"

    def __init__(self, store, params, bsz, compression=True, prescan=True,
                 *, pin_memory: bool = False):
        if not compression:
            raise ValueError("the device codec backend requires "
                             "compression=True")
        super().__init__(store, params, bsz, compression, prescan,
                         pin_memory=pin_memory)

    def _host_buffer(self, shape, dtype) -> torch.Tensor:
        return torch.empty(shape, dtype=dtype, pin_memory=self.pin_memory)

    def fetch_group_batch(self, key_rows):
        # inflate every block's segments straight into one set of (pinned)
        # staging buffers for the wave
        rows, n_blocks = key_rows.shape
        n = self.bsz
        P = 2 * key_rows.size
        codes = self._host_buffer((P, n), torch.int16)
        sign_bytes = self._host_buffer((P, sign_wire_bytes(n)), torch.uint8)
        l_max = self._host_buffer((P,), torch.float32)
        c_np, s_np, l_np = (codes.numpy().view("<u2"), sign_bytes.numpy(),
                            l_max.numpy())
        where, raws = [], []
        for r, row in enumerate(key_rows):
            for i, bid in enumerate(row):
                fault_point("codec.decode")
                seg = self.store.get_block(int(bid))
                if seg.is_raw:
                    raw = self._host_buffer((n,), torch.complex64)
                    raw.numpy()[:] = np.frombuffer(
                        seg.raw, dtype=np.complex64, count=seg.n_amps)
                    raws.append((r, i, raw))
                    continue
                for c, w in enumerate(segments_to_wire(seg)):
                    j = len(where)
                    c_np[j], s_np[j], l_np[j] = w.codes, w.sign_bytes, \
                        w.l_max.reshape(())
                    where.append(2 * (r * n_blocks + i) + c)
        self.add_counts(decompressions=key_rows.size)
        plane_map = None
        if raws and where:
            plane_map = self._host_buffer((len(where),), torch.int32)
            plane_map.numpy()[:] = where
        return _DeviceStaged(codes, sign_bytes, l_max, len(where), plane_map,
                             raws, rows, n_blocks)

    # the wire staged here was fetched through fetch_group_batch, whose
    # per-block fault_point covers the path
    def stage_to_device_batch(self, staged, device):
        n = self.bsz
        out = torch.empty((staged.rows, 2, staged.n_blocks * n),
                          dtype=torch.float32, device=device)
        k = staged.n_wire
        if k:
            wire = [t[:k] for t in (staged.codes, staged.sign_bytes,
                                    staged.l_max)]
            self.add_bytes(h2d=sum(t.nbytes for t in wire))
            codes, sign_bytes, l_max = (t.to(device, non_blocking=True)
                                        for t in wire)
            plane_map = (None if staged.plane_map is None else
                         staged.plane_map.to(device, non_blocking=True))
            decode_wave(codes, sign_bytes, l_max, n, self.params, out,
                        plane_map)
        for r, i, raw in staged.raws:
            self.add_bytes(h2d=raw.nbytes)
            amps = raw.to(device, non_blocking=True)
            out[r, :, i * n:(i + 1) * n] = torch.view_as_real(amps).T
        return out

    def dispatch_result_batch(self, planes_dev, n_blocks):
        # the encode kernel and the d2h copies are queued here; only the
        # event wait in await_result_batch blocks
        rows = planes_dev.shape[0]
        wire = encode_wave(planes_dev, self.bsz, self.params)
        if planes_dev.device.type == "cpu":
            return wire, None, rows, n_blocks
        host = tuple(self._host_buffer(tuple(t.shape), t.dtype)
                     for t in wire)
        for h, t in zip(host, wire):
            h.copy_(t, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(planes_dev.device))
        return host, done, rows, n_blocks

    def await_result_batch(self, ticket):
        (codes, sign_bytes, l_max), done, rows, n_blocks = ticket
        if done is not None:
            done.synchronize()                    # blocking wait
        codes = codes.numpy().view("<u2")
        sign_bytes, l_max = sign_bytes.numpy(), l_max.numpy()
        self.add_bytes(d2h=codes.nbytes + sign_bytes.nbytes + l_max.nbytes)
        pairs = [tuple(PlaneWire(codes[q], sign_bytes[q],
                                 l_max[q:q + 1].reshape(1, 1))
                       for q in (2 * b, 2 * b + 1))
                 for b in range(rows * n_blocks)]
        return [pairs[r * n_blocks:(r + 1) * n_blocks] for r in range(rows)]

    def store_group_batch(self, key_rows, results):
        for block_ids, pairs in zip(key_rows, results):
            for pair, bid in zip(pairs, block_ids):
                fault_point("codec.encode")
                self.store.put_block(
                    int(bid), wire_to_segments(pair, self.bsz,
                                               prescan=self.prescan,
                                               params=self.params))
            self.add_counts(compressions=len(block_ids))


def make_backend(name: str, store: BlockStore, params: PwRelParams,
                 bsz: int, compression: bool = True, prescan: bool = True,
                 *, pin_memory: bool = False) -> CodecBackend:
    """Resolve an ``EngineConfig.codec_backend`` name to a backend.

    ``"device"`` degrades to ``"host"`` (with a ``RuntimeWarning``) when
    ``compression`` is off — there is no device half to a raw byte copy.
    """
    if name == "device" and compression:
        return DeviceCodecBackend(store, params, bsz, compression, prescan,
                                  pin_memory=pin_memory)
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
                 devices: list | None = None,
                 fetch_workers: int | None = None):
        self.backend = backend
        self.depth = max(1, depth)
        #: the devices waves round-robin over (default ``[cuda:0]``)
        self.devices = ([torch.device(d) for d in devices] if devices
                        else [resolve_device(None)])
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

    def _device_for(self, w: int) -> torch.device:
        return self.devices[w % len(self.devices)]

    def run_stage(self, block_ids: np.ndarray, fn, mats,
                  lane_offsets: np.ndarray | None = None,
                  wave_fn=None, lane_shards=None,
                  group_devices=None) -> None:
        """Run one stage: ``block_ids`` is the (n_groups, 2^m) layout
        table, ``fn`` the single-group stage update ((2, 2^(b+m)) planes
        -> same) and ``mats`` its operands.

        ``wave_fn`` is the row-batched form of the update ((R, 2,
        2^(b+m)) planes -> same, updated in place): it enables the
        wave-coalesced scheduler.  Without it (the per-gate path has no
        batched form) the stage runs strictly sequentially through the
        single-group hooks.

        ``lane_offsets`` switches on the lane-batched path: each wave's
        key table stacks ``lane_offsets[:, None] + block_ids[g]`` for the
        wave's groups (groups-major: row ``g_local * L + l``), and
        ``wave_fn`` updates the (depth·L, 2, 2^(b+m)) row stack in one
        call, row ``w`` against lane ``w % L``'s operands.

        Placement over several devices (one of):

        * ``lane_shards``, ``[(device, lanes), ...]`` (``lanes`` a slice
          or an array of lane indices): each wave splits into one item a
          shard, carrying that shard's lane rows (keys from
          ``lane_offsets[lanes]``) and its rows of the lane-stacked
          operands, placed on the shard's device once a stage.  Shards touch disjoint store-key ranges, so nothing is
          exchanged.
        * ``group_devices``, a device a group (the plan's ``device_slot``
          placement): the stage's groups are bucketed by device, chunked
          into depth-wide waves and interleaved one chunk a device, so
          consecutive calls land on different devices.  The engine
          accounts the blocks whose owner changed since the previous
          stage (compressed-wire exchange).

        Without either, wave ``w`` runs on ``devices[w % D]``."""
        assert self._entered, "use StagePipeline as a context manager"
        n_groups, n_blocks = block_ids.shape
        self.n_group_phases += n_groups
        if wave_fn is None:
            # the per-gate path has no batched form to shard a wave with;
            # group g runs on devices[g % D], the round-robin the plan's
            # device_slot records
            self._run_sequential_single(block_ids, fn, mats, lane_offsets)
            return
        items = self._wave_items(block_ids, mats, lane_offsets,
                                 lane_shards, group_devices)
        if self._dec_pool is None:
            self._run_waves(items, wave_fn, n_blocks)
            return
        self._run_overlapped(items, wave_fn, n_blocks)

    # -- wave item construction ----------------------------------------------
    @staticmethod
    def _placed(mats, dev: torch.device, cache: dict) -> tuple:
        """``mats`` on ``dev``, moved once a stage (a tensor already there
        is itself)."""
        if dev not in cache:
            cache[dev] = tuple(m.to(dev) for m in mats)
        return cache[dev]

    def _wave_items(self, block_ids, mats, lane_offsets=None,
                    lane_shards=None, group_devices=None) -> list[tuple]:
        """Cut one stage into ``(keys, device, operands)`` wave items, the
        unit both schedulers consume: depth-wide key tables (with
        ``lane_offsets``, each group's row repeated once a lane, shifted
        by the lane's key offset, groups-major), each with its device and
        the operands placed there once a stage."""
        n_groups, _ = block_ids.shape
        W = min(self.depth, n_groups)
        offs = (None if lane_offsets is None
                else np.asarray(lane_offsets)[:, None])

        def keys_of(gids, o=offs):
            if o is None:
                return gids
            return np.concatenate([o + row[None, :] for row in gids])

        placed: dict = {}
        items = []
        if lane_shards:
            # the shard's lanes of the lane-stacked operands (the first L
            # rows of operands tiled for a full wave are the L lanes),
            # tiled once to a full wave of the shard's rows
            L = offs.shape[0]
            shard_ops = []
            for dev, sl in lane_shards:
                ops = []
                for m in mats:
                    m = m[:L][sl if isinstance(sl, slice)
                              else torch.as_tensor(sl, device=m.device)]
                    if W > 1:
                        m = m.repeat((W,) + (1,) * (m.dim() - 1))
                    ops.append(m.to(dev))
                shard_ops.append((torch.device(dev), offs[sl], tuple(ops)))
            for lo in range(0, n_groups, W):
                gids = block_ids[lo:lo + W]
                for dev, o, ops in shard_ops:
                    items.append((keys_of(gids, o), dev, ops))
            return items
        if group_devices is not None:
            # bucket groups by their slot's device (by equality: repeats
            # of one device are one bucket, the one-device waves), chunk
            # each bucket into depth-wide waves, and interleave one chunk
            # a device
            buckets: dict = {}
            for g, dev in enumerate(group_devices):
                buckets.setdefault(torch.device(dev), []).append(g)
            chunks = {dev: [gs[i:i + W] for i in range(0, len(gs), W)]
                      for dev, gs in buckets.items()}
            while any(chunks.values()):
                for dev, cs in chunks.items():
                    if cs:
                        gids = block_ids[np.asarray(cs.pop(0))]
                        items.append((keys_of(gids), dev,
                                      self._placed(mats, dev, placed)))
            return items
        for w, lo in enumerate(range(0, n_groups, W)):
            dev = self._device_for(w)
            items.append((keys_of(block_ids[lo:lo + W]), dev,
                          self._placed(mats, dev, placed)))
        return items

    @staticmethod
    def _window_for(items, base: int) -> int:
        """In-flight window of a wave-item schedule: at least one item a
        distinct device, so a multi-device stage keeps every device busy
        while older waves drain at the boundary."""
        n_dev = len({dev for _, dev, _ in items})
        if n_dev <= 1:
            return base
        return max(base, min(n_dev, len(items)))

    # -- sequential wave loop (depth 1 / coalescing-only hosts) ---------------
    def _run_waves(self, items, wave_fn, n_blocks) -> None:
        """Caller's-thread wave loop: no pools, no lookahead.  On one
        device the window is 1, the strictly sequential reference
        schedule.  With several devices it widens to the device count:
        each device's compute is queued before any older wave's blocking
        boundary wait."""
        back = self.backend
        window = self._window_for(items, 1)
        in_flight: deque = deque()

        def drain():
            okeys, oticket = in_flight.popleft()
            t0 = time.perf_counter()
            result = back.await_result_batch(oticket)
            self.t_fetch += time.perf_counter() - t0
            self._store(back.store_group_batch, okeys, result)

        for keys, dev, imats in items:
            staged = self._load(back.fetch_group_batch, keys)
            t0 = time.perf_counter()
            planes = back.stage_to_device_batch(staged, dev)
            out = wave_fn(planes, *imats)
            ticket = back.dispatch_result_batch(out, n_blocks)
            self.t_compute += time.perf_counter() - t0
            in_flight.append((keys, ticket))
            if len(in_flight) >= window:
                drain()
        while in_flight:
            drain()

    # -- strictly sequential single-group loop (no batched stage fn) ----------
    def _run_sequential_single(self, block_ids, fn, mats,
                               lane_offsets=None) -> None:
        """The per-gate path: one group per call, in order, on the
        caller's thread — load, stage, compute, dispatch, await, store.
        With ``lane_offsets`` a call covers every lane of one group (an
        (L, 2^m) key table through the row-batched hooks)."""
        back = self.backend
        n_groups, n_blocks = block_ids.shape
        if lane_offsets is None:
            fetch, to_dev = back.fetch_group, back.stage_to_device
            dispatch, await_ = back.dispatch_result, back.await_result
            store = back.store_group
            group_keys = [block_ids[g] for g in range(n_groups)]
        else:
            fetch, to_dev = back.fetch_group_batch, back.stage_to_device_batch
            dispatch, await_ = (back.dispatch_result_batch,
                                back.await_result_batch)
            store = back.store_group_batch
            offs = np.asarray(lane_offsets)[:, None]
            group_keys = [offs + block_ids[g][None, :]
                          for g in range(n_groups)]
        placed: dict = {}
        for g, keys in enumerate(group_keys):
            staged = self._load(fetch, keys)
            t0 = time.perf_counter()
            dev = self._device_for(g)
            planes = to_dev(staged, dev)
            out = fn(planes, *self._placed(mats, dev, placed))
            ticket = dispatch(out, n_blocks)
            self.t_compute += time.perf_counter() - t0
            t0 = time.perf_counter()
            result = await_(ticket)
            self.t_fetch += time.perf_counter() - t0
            self._store(store, keys, result)

    # -- the double-buffered wave loop ---------------------------------------
    def _run_overlapped(self, items, wave_fn, n_blocks) -> None:
        back = self.backend
        n_waves = len(items)
        window = self._window_for(items, self.inflight_window)
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
                                            items[w][0])
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
                self._store, back.store_group_batch, items[ow][0], result))

        try:
            for _ in range(min(1 + _FETCH_LOOKAHEAD, n_waves)):
                submit_next()
            for _ in range(n_waves):
                # completion-order ready-queue: take whichever lookahead
                # fetch finished first
                w = ready.get()
                staged = outstanding.pop(w).result()
                keys, dev, imats = items[w]
                t0 = time.perf_counter()
                planes = back.stage_to_device_batch(staged, dev)
                out = wave_fn(planes, *imats)
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
                except Exception:  # lint: disable=typed-errors -- keep original error
                    pass
            raise
        for fut in pending_save:       # stage barrier (§4.1 semantics)
            fut.result()
