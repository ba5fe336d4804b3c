"""The BMQSIM engine (paper §4): compressed, staged state-vector simulation.

Execution model per stage (from the §4.1 partition):

    for each SV group (independent):
        load/decode  2^m member blocks -> flat 2^(b+m) group array
        compute      the stage's fused unitaries              (device)
        encode/store the 2^m blocks -> two-level store

Phase orchestration lives in :mod:`repro_torch.core.pipeline`: host phases
of *different* groups overlap through worker threads while the device work
of a wave is queued on the CUDA stream (§4.2's transfer-concealed
workflow).  The codec runs on the host (``codec_backend="host"``: raw
group arrays cross the host↔device boundary) or next to the compute
(``codec_backend="device"``: the CUDA codec kernels quantize and
dequantize on the card, and only the compressed wire crosses).

On the device the group is *planes-resident*: it lives as a (2, 2^(b+m))
f32 re/im plane stack from decode through every fused gate to encode, and
each stage's gate list is compiled into a transpose-minimizing schedule
(:mod:`repro_torch.core.schedule`) whose dense minor-most gates run in the
hand-written ``gemm_planes_batch`` kernel, a wave of groups at a time.
``gate_schedule=False`` keeps the per-gate path instead (a complex64
round-trip and a transpose pair per fused gate, one group at a time,
through ``kernels/ops.py::apply_fused_gate`` and its ``gemm_planes`` /
``diag_apply`` kernels).

A batch of lanes (parameter-sweep points or noise trajectories,
:meth:`BMQSimEngine.run_batch`) shares every wave: a wave of ``d``
groups is ``d·L`` rows, groups-major, and each ``GemmOp`` is one
``gemm_planes_batch`` launch with one operand per lane.

Several devices (paper §4.2, multi-GPU; ``config.devices`` or
``mesh_shape``): a batched run lane-shards over them, each device taking a
contiguous slice of the lanes, and a single run block-shards its groups by
the plan's ``device_slot`` round-robin, with an exchange ledger of the
encoded blocks that change owners at each stage boundary
(:mod:`repro_torch.distributed.lanes`).  A list may repeat a device: D
slots on one card.

This is the PyTorch port of ``repro.core.engine``.
"""
from __future__ import annotations

import time
import warnings
from collections import OrderedDict
from dataclasses import dataclass, field, replace
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from ..compression.pwrel import PwRelParams
from ..compression.store import BlockStore
from ..distributed.lanes import (device_slots, make_lane_mesh,
                                 make_lane_shards)
from .circuit import Circuit, Gate
from .dense_engine import apply_matrix
from .devices import resolve_device
from .faults import fault_point
from .fusion import FusedGate
from .groups import GroupLayout
from .partition import Partition, Stage, partition_circuit
from .pipeline import (StagePipeline, complex_to_planes, make_backend,
                       planes_to_complex)
from .plan import ExecutionPlan, circuit_fingerprint, plan_fingerprint
from .planner import (assemble_plan, estimate_bytes_per_amp, fuse_stage,
                      fuse_stage_lanes, max_feasible_lanes, resolve_config)
from .pressure import PressureMonitor
from .result import collect_statevector
from .schedule import (StageSchedule, compile_schedule, execute_schedule,
                       execute_schedule_batched)

__all__ = ["EngineConfig", "SimStats", "BMQSimEngine", "simulate_bmqsim"]

#: parameter bindings whose fused operands stay resident per engine
_BOUND_CACHE_SIZE = 8


@dataclass
class EngineConfig:
    """Knobs of one BMQSIM run (paper defaults unless noted).

    Attributes:
        local_bits: ``b`` — an SV block holds 2^b amplitudes; the state
            splits into 2^(n-b) blocks (§3).  ``None`` means **auto**:
            the planner (:mod:`repro_torch.core.planner`) chooses it — under
            ``memory_budget_bytes`` when set, by heuristic otherwise.
        inner_size: max inner global indices per stage — Algorithm 1's
            threshold; a group is 2^inner_size blocks.  ``None`` = auto
            (planner default 2, searched when ``local_bits`` is auto and
            a budget is set).
        memory_budget_bytes: total working-set budget the planner tunes
            the knobs against (predicted compressed state + pipeline
            staging).  Always also flows into the store's
            ``ram_budget_bytes`` backstop unless one was given, so the
            run honors the budget even when the compression-ratio
            estimate was optimistic (spilling to disk instead).
        b_r: point-wise relative error bound of the lossy quantizer (§4.3).
        max_fused_qubits: gate-fusion width (7 => 128x128 MXU tiles on TPU).
        compression: False stores raw complex64 blocks (Fig. 11 baseline).
        prescan: bitmap pre-scan RLE in the lossless stage (§4.3).
        pipeline_depth: decode-ahead / encode-behind worker count (§4.2;
            the paper's CUDA stream count).  ``None`` = auto (default 2,
            reduced when the staging working set would break the budget).
        codec_backend: ``"host"`` runs the whole codec on the host and
            moves raw 2^(b+m) complex64 group arrays across the
            host↔device boundary; ``"device"`` runs the lossy half on the
            device (the fused encode/decode kernels of ``csrc/codec.cu``,
            their plain versions on the CPU) so only the compressed wire
            (~4.25 bytes/amplitude) crosses.  Without compression
            ``"device"`` falls back to ``"host"`` with a warning.
        ram_budget_bytes: primary-tier budget of the two-level store (§4.4);
            overflow spills to disk.
        spill_dir: secondary-tier directory (default: a temp dir).
        use_kernel: apply gates through the hand-written gate kernels
            (``kernels/gate_apply.py``) instead of plain torch products
            (default: on; on the CPU the kernel wrappers run their plain
            versions).
        gate_schedule: compile each stage's gate list into a
            transpose-minimizing schedule over f32 re/im planes
            (:mod:`repro_torch.core.schedule`).  False restores the
            per-gate path (transpose -> apply -> inverse transpose per
            fused unitary, complex64 round-trip per gate, one group at a
            time) — kept for the side-by-side comparison.
        devices: round-robin group placement targets, a list of
            :class:`torch.device` (default: ``[cuda:0]``, which must
            exist; pass ``[torch.device("cpu")]`` to run the kernels'
            plain versions on the CPU).  Devices compare by equality, and
            a list may repeat one (``[cuda:0] * D``: D slots on one
            card); it may not mix CUDA and CPU devices.
        mesh_shape: build the run's device list from a 1-D simulation
            placement over the visible cards instead (``(N,)`` or a bare
            ``N``; see :func:`repro_torch.distributed.lanes.make_lane_mesh`,
            which clamps to the visible count with a warning).  A batched
            run lane-shards over the devices (nothing exchanged); a single
            run block-shards its groups per the plan's ``device_slot``
            with compressed-wire exchange at stage boundaries.  An
            explicit ``devices`` list wins over ``mesh_shape``.
        per_gate: SC19-Sim baseline — one stage per gate, i.e. a full
            decompress+recompress sweep per gate (§3).
        batch: the batch factor K the *planner* provisions for — a
            ``run_batch``/trajectory run keeps K compressed state copies
            and K-lane group stacks resident, so the budget search scales
            its working-set model by this before picking
            ``local_bits``/``pipeline_depth``.  Runtime batches larger
            than the budget allows are chunked into feasible sub-batches
            (see :meth:`BMQSimEngine.feasible_lanes`).
        integrity_checks: stamp/verify crc32 content checksums on every
            serialized blob (disk spill tier + checkpoint snapshots); a
            mismatch raises a typed
            :class:`~repro_torch.errors.BlockCorruptionError` instead of
            silently decoding corrupt data.  Default on (overhead is a
            gated ``bench_pipeline`` row).
        io_retries / io_backoff_s: bounded exponential-backoff retry of
            transient spill/checkpoint I/O errors before the store gives
            up with a typed :class:`~repro_torch.errors.StoreIOError`.
        pressure_monitor: check measured ``bytes_per_amp`` against the
            planner's prediction at every stage boundary and walk the
            degradation ladder (shrink in-flight window -> wave depth 1
            -> proactive spill -> typed abort) when compression
            underdelivers; see :mod:`repro_torch.core.pressure`.
        pressure_headroom: measured/predicted ratio that counts as
            pressure (the entropy model is deliberately loose).
        disk_budget_bytes: optional byte budget of the disk spill tier;
            overflowing it is the ladder's terminal rung — a
            :class:`~repro_torch.errors.MemoryPressureError` abort at the next
            stage boundary (resumable when checkpointing is active).
            ``None`` (default) never aborts: incompressible-but-
            spillable runs degrade and complete.
    """

    local_bits: int | None = None
    inner_size: int | None = None
    b_r: float = 1e-3
    max_fused_qubits: int = 5
    compression: bool = True
    prescan: bool = True
    pipeline_depth: int | None = None
    codec_backend: str = "host"
    memory_budget_bytes: int | None = None
    ram_budget_bytes: int | None = None
    spill_dir: str | None = None
    use_kernel: bool = True
    gate_schedule: bool = True
    devices: list | None = None
    mesh_shape: tuple | int | None = None
    per_gate: bool = False
    batch: int = 1
    integrity_checks: bool = True
    io_retries: int = 3
    io_backoff_s: float = 0.01
    pressure_monitor: bool = True
    pressure_headroom: float = 1.5
    disk_budget_bytes: int | None = None


@dataclass
class SimStats:
    """Counters and timings of one run (see the paper's Figs. 9-12).

    ``h2d_bytes`` / ``d2h_bytes`` count every byte that crossed the
    host↔device boundary through the stage pipeline — the quantity the
    device codec backend shrinks; ``per_stage_boundary_bytes`` records the
    per-stage (h2d, d2h) pairs for the boundary-traffic benchmarks.  The
    list is **reset at the start of every run** (it describes the latest
    run only — a sweep must not grow it without bound); the scalar byte
    counters keep accumulating lifetime totals across runs.

    ``bytes_per_amp_measured`` is the achieved stored compression after
    the first encoded stage of the latest run — the run-time calibration
    of the planner's ``predicted.bytes_per_amp`` estimate.

    ``t_compute`` is dispatch + kernel time only; the blocking wait at the
    d2h boundary is ``t_fetch`` (previously misattributed to compute).
    ``n_transposes_naive`` / ``n_transposes_scheduled`` count full-group
    transposes (per group execution) under the per-gate scheme vs the
    compiled stage schedule — both are recorded whichever path ran.

    ``n_stagefn_compiles`` counts stage structures this engine
    instantiated for the first time; ``n_stagefn_cache_hits`` counts
    stage executions that reused one.  A parameter sweep on one session
    must show zero new compiles after the first run (the Simulator API's
    reuse contract); counters accumulate across ``n_runs`` runs.  (The
    stage functions additionally dedup across engines via a
    process-global cache — these counters are deliberately per-engine.)
    """

    n_qubits: int = 0
    n_gates: int = 0
    n_stages: int = 0
    n_runs: int = 0
    #: lane count of the latest run (1 for a plain run(); K for run_batch)
    n_lanes: int = 1
    #: sub-batches the latest run_batch was chunked into to honor the
    #: memory budget (0 until the first batched run)
    n_batch_chunks: int = 0
    n_stagefn_compiles: int = 0
    n_stagefn_cache_hits: int = 0
    n_fused_unitaries: int = 0
    n_block_compressions: int = 0
    n_block_decompressions: int = 0
    peak_ram_bytes: int = 0
    peak_total_bytes: int = 0
    disk_bytes: int = 0
    n_spills: int = 0
    h2d_bytes: int = 0
    d2h_bytes: int = 0
    per_stage_boundary_bytes: list = field(default_factory=list)
    #: bytes of *encoded wire* (stored blob sizes) that changed owning
    #: device between consecutive stages of a block-sharded run — the
    #: device↔device analogue of the h2d/d2h ledger.  Only compressed
    #: blobs ever cross (the store holds nothing else), so this divided
    #: by ``n_exchanged_blocks * 2^local_bits * 8`` is the interconnect
    #: saving over shipping raw amplitudes.  Lifetime total; the
    #: per-stage list resets per run like per_stage_boundary_bytes.
    exchange_bytes: int = 0
    n_exchanged_blocks: int = 0
    per_stage_exchange_bytes: list = field(default_factory=list)
    bytes_per_amp_measured: float = 0.0
    n_transposes_naive: int = 0
    n_transposes_scheduled: int = 0
    t_decompress: float = 0.0
    t_compute: float = 0.0
    t_fetch: float = 0.0
    t_compress: float = 0.0
    t_partition: float = 0.0
    t_total: float = 0.0
    #: group x stage phase executions behind the t_* pipeline timings —
    #: the denominator for the planner's per-group calibration
    n_group_phases: int = 0
    # -- resilience counters (see repro_torch.core.pressure / repro_torch.errors) -----
    #: transient spill/checkpoint I/O errors absorbed by retry-with-backoff
    n_io_retries: int = 0
    #: blobs moved RAM -> disk by the pressure ladder's spill rung
    n_proactive_spills: int = 0
    #: checksum mismatches detected (every one raised a typed error)
    n_corruptions_detected: int = 0
    #: automatic replays-from-checkpoint after a detected corruption
    n_replays: int = 0
    #: emergency checkpoints flushed at a pressure abort
    n_emergency_checkpoints: int = 0
    #: degradation-ladder escalations across the session
    n_pressure_events: int = 0
    #: "stage{k}:{rung}" per escalation, in firing order
    pressure_rungs: list = field(default_factory=list)

    @property
    def standard_bytes(self) -> int:
        """The paper's 2^(n+4) standard (complex128 full state)."""
        return 2 ** (self.n_qubits + 4)

    @property
    def standard_bytes_c64(self) -> int:
        return 2 ** (self.n_qubits + 3)

    @property
    def memory_reduction(self) -> float:
        return self.standard_bytes / max(1, self.peak_total_bytes)

    @property
    def boundary_bytes(self) -> int:
        """Total host↔device traffic (both directions)."""
        return self.h2d_bytes + self.d2h_bytes

    def pipeline_calibration(self):
        """Measured per-group phase costs of this engine's runs, in the
        form the planner's depth model consumes
        (:class:`~repro_torch.core.planner.PipelineCalibration`) — feed it back
        through ``resolve_config(..., calibration=...)`` so the next
        plan's ``pipeline_depth`` choice rests on measurements instead of
        the default profile."""
        from .planner import PipelineCalibration
        g = max(1, self.n_group_phases)
        return PipelineCalibration(
            t_load=self.t_decompress / g, t_compute=self.t_compute / g,
            t_fetch=self.t_fetch / g, t_store=self.t_compress / g)


# --------------------------------------------------------------------------
# stage compute: fused unitaries applied to a planes-resident group
# --------------------------------------------------------------------------
#
# The group lives as a (2, 2^(b+m)) f32 re/im plane stack from the codec
# backend's decode output through every fused gate to the encode input.
# The default path executes the stage's compiled transpose-minimizing
# schedule over a wave of groups at once (_stage_fn_wave);
# gate_schedule=False keeps the per-gate path (complex64 round-trip + a
# transpose pair per gate), which the pipeline runs one group at a time
# through _stage_fn.

def _apply_fused(amps: torch.Tensor, mats, plan, nv: int) -> torch.Tensor:
    for mat, (vqubits, diag) in zip(mats, plan):
        if diag:
            # diagonal fast path: elementwise multiply, no GEMM
            k = len(vqubits)
            axes = [nv - 1 - q for q in vqubits]
            rest = [a for a in range(nv) if a not in axes]
            perm = rest + [axes[j] for j in range(k - 1, -1, -1)]
            t = amps.reshape((2,) * nv).permute(perm).reshape(-1, 2 ** k)
            t = t * mat[None, :].to(t.dtype)
            inv = np.argsort(np.asarray(perm)).tolist()
            amps = t.reshape((2,) * nv).permute(inv).reshape(-1)
        else:
            amps = apply_matrix(amps, mat, vqubits, nv)
    return amps


@lru_cache(maxsize=512)
def _stage_fn(plan: tuple[tuple[tuple[int, ...], bool], ...], nv: int,
              use_kernel: bool, gate_schedule: bool):
    """Single-group (2, 2^nv) -> (2, 2^nv) planes update, cached on the
    stage *structure* so stages with identical access patterns share one
    function.  The scheduled form updates the planes in place (the
    decoded input is dead once the stage consumes it)."""
    if gate_schedule:
        sched = compile_schedule(plan, nv)

        def fn(planes, *mats):
            return execute_schedule(sched, planes, mats,
                                    use_kernel=use_kernel)
    elif use_kernel:
        from ..kernels import ops as kops

        def fn(planes, *mats):
            amps = planes_to_complex(planes)
            for mat, (vqubits, diag) in zip(mats, plan):
                amps = kops.apply_fused_gate(amps, mat, vqubits, nv, diag)
            return complex_to_planes(amps)
    else:
        def fn(planes, *mats):
            amps = planes_to_complex(planes)
            amps = _apply_fused(amps, mats, plan, nv)
            return complex_to_planes(amps)
    return fn


@lru_cache(maxsize=256)
def _stage_fn_wave(plan: tuple[tuple[tuple[int, ...], bool], ...], nv: int,
                   use_kernel: bool):
    """Wave-coalesced (W, 2, 2^nv) -> (W, 2, 2^nv) group update for a
    single-lane run: every row is a different SV group of the same stage,
    so the one set of stage operands is expanded over the rows with
    stride 0 (never copied).  The planes are updated in place — the
    decoded input is dead once the stage consumes it.  Cached on the
    stage *structure*, so stages with identical access patterns share
    one compiled schedule."""
    sched = compile_schedule(plan, nv)

    def fn(planes, *mats):
        w = planes.shape[0]
        bmats = [m.unsqueeze(0).expand((w,) + tuple(m.shape)) for m in mats]
        return execute_schedule_batched(sched, planes, bmats,
                                        use_kernel=use_kernel)
    return fn


def _stage_mats(vgates: list[FusedGate],
                plan: tuple[tuple[tuple[int, ...], bool], ...],
                device: torch.device,
                gate_schedule: bool) -> list[torch.Tensor]:
    """Per-gate operands on ``device`` in the form the selected stage path
    consumes: stacked (2, K, K) f32 planes of U (or (2, K) diagonal
    planes) for the scheduled path, complex64 matrices (or diagonals) for
    the per-gate path."""
    mats = []
    for fg, (_, diag) in zip(vgates, plan):
        m = np.diag(fg.matrix) if diag else fg.matrix
        if gate_schedule:
            m = np.stack([m.real, m.imag]).astype(np.float32)
        else:
            m = np.asarray(m, np.complex64)
        mats.append(torch.as_tensor(m, device=device))
    return mats


def _lane_rows(mat: torch.Tensor, rows: int) -> torch.Tensor:
    """Lane-stacked operand -> one row per wave row (row ``w`` is lane
    ``w % L``'s).  An operand already tiled for a full wave (see
    :meth:`BMQSimEngine._bind_stages_batch`) is sliced, a view; an
    (L, ...) one is tiled groups-major."""
    if mat.shape[0] >= rows:
        return mat[:rows]
    return mat.repeat((rows // mat.shape[0],) + (1,) * (mat.dim() - 1))


@lru_cache(maxsize=256)
def _stage_fn_batch(plan: tuple[tuple[tuple[int, ...], bool], ...], nv: int,
                    use_kernel: bool):
    """Lane-batched (R, 2, 2^nv) -> (R, 2, 2^nv) group update: one call
    covers every lane of a parameter-sweep / trajectory batch (lane l's
    planes contract against lane l's operands).  Cached on stage
    structure like :func:`_stage_fn`.

    Wave-aware: when the pipeline coalesces ``d`` consecutive groups of
    an L-lane batch into one (d·L)-row wave, row ``w`` takes lane ``w %
    L``'s operands (groups-major) — sliced from operands the engine tiled
    once for a full wave, or tiled here from (L, ...) ones."""
    sched = compile_schedule(plan, nv)

    def fn(planes, *mats):
        rows = planes.shape[0]
        mats = [_lane_rows(m, rows) for m in mats]
        return execute_schedule_batched(sched, planes, mats,
                                        use_kernel=use_kernel)
    return fn


def _stage_mats_batch(lane_vgates, plan, device: torch.device
                      ) -> list[torch.Tensor]:
    """Per-gate lane-stacked operands for the batched scheduled path on
    ``device``: (L, 2, K, K) stacked re/im planes of each lane's U for
    dense fused gates, (L, 2, K) diagonal planes when every lane's
    realization is diagonal."""
    mats = []
    for i, (_, diag) in enumerate(plan):
        per_lane = []
        for vgates in lane_vgates:
            m = np.diag(vgates[i].matrix) if diag else vgates[i].matrix
            per_lane.append(np.stack([m.real, m.imag]))
        mats.append(torch.as_tensor(np.stack(per_lane).astype(np.float32),
                                    device=device))
    return mats


class _BoundStage(NamedTuple):
    """One stage, fully compiled for one parameter binding: everything
    :meth:`BMQSimEngine.run` needs — built once at bind/plan time, never
    inside the run loop."""

    layout: GroupLayout
    plan: tuple                       # ((vqubits, is_diagonal), ...)
    mats: list                        # binding-specific operands
    key: tuple                        # stage-fn cache key
    fn: object                        # single-group planes -> planes update
    sched: StageSchedule | None       # compiled schedule (None if empty)
    wave_fn: object = None            # row-batched update (wave scheduler)


def _lanes_by_device(shards) -> list | None:
    """The lanes of ``shards`` (:func:`make_lane_shards`) merged per
    distinct device, by equality: ``[(device, lane indices), ...]``, or None
    where one device holds them all, which then runs the one-device waves
    (``[cuda:0] * D`` is D slots of one card, not D half-width waves)."""
    lanes: dict = {}
    for s in shards:
        lanes.setdefault(s.device, []).append(
            np.arange(s.lanes.start, s.lanes.stop))
    if len(lanes) == 1:
        return None
    return [(dev, np.concatenate(ix)) for dev, ix in lanes.items()]


class BMQSimEngine:
    """Executor of one circuit's :class:`ExecutionPlan` (§4).

    Construction *plans*: it resolves auto knobs through the planner's
    cost model (``local_bits=None`` + ``memory_budget_bytes``), performs
    the §4.1 partition, and — per parameter binding, cached — fuses the
    gates, compiles the transpose-minimizing schedules and builds the
    stage-function cache keys.  :meth:`run` is a plain plan walk.
    :meth:`compile` freezes the current binding's decisions into the
    inspectable :class:`ExecutionPlan` artifact; passing such a plan back
    via ``plan=`` skips planning and executes it verbatim.

    The run's devices are ``config.devices`` (default ``[cuda:0]``);
    ``self.device``, the first, holds the stage operands.  On the CPU the
    kernels' plain versions run and the plan records ``interpret=True``;
    on CUDA the kernels launch and it records False.

    Use :class:`~repro_torch.core.simulator.Simulator` unless you need to
    poke at engine internals between construction and run.
    """

    def __init__(self, circuit: Circuit, config: EngineConfig,
                 *, store: BlockStore | None = None,
                 plan: ExecutionPlan | None = None):
        self.circuit = circuit
        self._circuit_fp = circuit_fingerprint(circuit)
        self.n = circuit.n_qubits
        # lanes or block slots lay out along this list (distributed.lanes);
        # torch.device objects are not singletons, so the pipeline finds
        # repeats by equality: [cuda:0] * D is D slots on one card
        if config.devices:
            self._devices = [torch.device(d) for d in config.devices]
        elif config.mesh_shape is not None:
            self._devices = list(make_lane_mesh(config.mesh_shape).devices)
        else:
            self._devices = [resolve_device(None)]
        kinds = sorted({d.type for d in self._devices})
        if len(kinds) > 1:
            raise ValueError(
                f"devices {self._devices} mix {' and '.join(kinds)}: one "
                "run's devices come from one platform")
        #: the first device: it holds the stage operands
        self.device = self._devices[0]
        #: True where the kernels' plain versions run (the plan's
        #: ``interpret`` field, kept so plans compare across packages)
        self._interpret = self.device.type == "cpu"
        if plan is not None:
            if plan.circuit_fp != self._circuit_fp:
                raise ValueError(
                    "ExecutionPlan was compiled for a different circuit "
                    "(structural fingerprint mismatch)")
            # verbatim execution: every knob the plan records wins over
            # the config's (devices stay config-side — the plan only
            # records their count)
            config = replace(
                config, local_bits=plan.local_bits,
                inner_size=plan.inner_size,
                pipeline_depth=plan.pipeline_depth,
                b_r=plan.b_r, compression=plan.compression,
                prescan=plan.prescan, codec_backend=plan.codec_backend,
                use_kernel=plan.use_kernel,
                gate_schedule=plan.gate_schedule,
                max_fused_qubits=plan.max_fused_qubits,
                batch=plan.batch,
                memory_budget_bytes=plan.memory_budget_bytes,
                ram_budget_bytes=(config.ram_budget_bytes
                                  if config.ram_budget_bytes is not None
                                  else plan.memory_budget_bytes))
            self.auto_tuned = plan.auto_tuned
        pre_part = None
        if plan is None:
            config, self.auto_tuned, pre_part = resolve_config(
                circuit, config, n_devices=len(self._devices))
        self.cfg = config
        self.b = min(config.local_bits, self.n)
        self.params = PwRelParams(b_r=config.b_r)
        self.store = store if store is not None else BlockStore(
            ram_budget_bytes=config.ram_budget_bytes,
            spill_dir=config.spill_dir,
            checksums=config.integrity_checks,
            io_retries=config.io_retries,
            io_backoff_s=config.io_backoff_s)
        self.backend = make_backend(
            config.codec_backend, self.store, self.params, 2 ** self.b,
            compression=config.compression, prescan=config.prescan,
            pin_memory=self.device.type == "cuda")
        self.stats = SimStats(n_qubits=self.n, n_gates=len(circuit))

        t0 = time.perf_counter()
        if plan is not None:
            # the slices must tile the gate list exactly — a truncated or
            # overlapping slice (corrupt/hand-edited plan JSON) would
            # silently simulate a different circuit than circuit_fp attests
            expect = 0
            for sp in plan.stages:
                lo, hi = sp.gate_slice
                if lo != expect or hi < lo:
                    raise ValueError(
                        f"ExecutionPlan stage {sp.index} gate_slice "
                        f"{sp.gate_slice} does not tile the gate list "
                        f"(expected start {expect})")
                expect = hi
            if expect != len(circuit.gates):
                raise ValueError(
                    f"ExecutionPlan covers {expect} gates but the circuit "
                    f"has {len(circuit.gates)}")
            stages = [Stage(gates=list(circuit.gates[lo:hi]),
                            inner=sorted(sp.layout.inner))
                      for sp in plan.stages
                      for lo, hi in (sp.gate_slice,)]
            self.partition = Partition(self.n, self.b, config.inner_size,
                                       stages)
            self.partition.validate()
        elif config.per_gate:
            stages = [Stage(gates=[g],
                            inner=sorted({q for q in g.qubits if q >= self.b}))
                      for g in circuit.gates]
            self.partition = Partition(self.n, self.b, config.inner_size,
                                       stages)
        elif pre_part is not None:
            self.partition = pre_part  # the budget search already built it
        else:
            self.partition = partition_circuit(
                circuit, self.b, config.inner_size)
        self.stats.t_partition = time.perf_counter() - t0
        self.stats.n_stages = self.partition.n_stages

        # per-stage: layout + the stage's (possibly parameterized) gate
        # templates; fusion, schedule compilation and operand staging
        # happen per parameter binding in _bind_stages and are cached per
        # binding, so a sweep revisits neither the partition nor
        # previously-bound unitaries
        self._stages: list[tuple[GroupLayout, list[Gate]]] = []
        for st in self.partition.stages:
            layout = GroupLayout(self.n, self.b, tuple(st.inner))
            self._stages.append((layout, st.gates))
        self._free_params = circuit.free_parameters
        self._stochastic = circuit.is_stochastic
        # LRU-bounded: an optimizer loop feeding ever-new angles must not
        # grow the session's memory with one operand set per evaluation
        self._bound: OrderedDict[tuple, list[_BoundStage]] = OrderedDict()
        self._bound_batch: OrderedDict[tuple, list[_BoundStage]] = \
            OrderedDict()
        self._seen_stagefns: set[tuple] = set()
        #: lanes currently materialized in the store (run_batch leaves K
        #: final states resident; the next run clears the surplus)
        self._stored_lanes = 1
        # compiled ExecutionPlans, keyed on the binding's stage structure
        # (parameter *values* don't change it, so a sweep shares one plan)
        self._plans: dict[tuple, ExecutionPlan] = {}
        if not self._free_params and not self._stochastic:
            self._bind_stages(None)   # eager, like the pre-session engine

    # -- parameter binding -----------------------------------------------------
    @staticmethod
    def _params_key(params: dict | None) -> tuple:
        if not params:
            return ()
        return tuple(sorted((str(k), float(v)) for k, v in params.items()))

    def _check_params(self, params: dict | None) -> None:
        given = set(params or {})
        missing = self._free_params - given
        if missing:
            raise ValueError(
                f"circuit has unbound parameters {sorted(missing)}; "
                "pass values via run(params={...})")
        unknown = given - self._free_params
        if unknown:
            raise KeyError(f"unknown parameter(s) {sorted(unknown)}; "
                           f"circuit has {sorted(self._free_params)}")

    def _bind_stages(self, params: dict | None) -> list[_BoundStage]:
        """Compile one parameter binding: fuse + remap the gates, stage
        the operands on the device, compile the schedule and build the
        stage-fn cache key per stage — the plan-time work.  Cached, so
        :meth:`run` only ever walks the result."""
        if self._stochastic:
            raise ValueError(
                "circuit contains stochastic Pauli channels; sample "
                "trajectories via run_batch / run(trajectories=K) instead "
                "of a single deterministic run")
        key = self._params_key(params)
        cached = self._bound.get(key)
        if cached is not None:
            self._bound.move_to_end(key)
            return cached
        self._check_params(params)
        bound = []
        for layout, gates in self._stages:
            vgates, plan = fuse_stage(layout, gates,
                                      self.cfg.max_fused_qubits, params)
            mats = _stage_mats(vgates, plan, self.device,
                               self.cfg.gate_schedule)
            self.stats.n_fused_unitaries += len(vgates)
            nv = layout.b + layout.m
            fkey = (plan, nv, self.cfg.use_kernel, self.cfg.gate_schedule,
                    self._interpret)
            fn = (_stage_fn(plan, nv, self.cfg.use_kernel,
                            self.cfg.gate_schedule) if plan else None)
            # the scheduled path gets the row-batched wave form too (the
            # per-gate path has none — the pipeline runs it sequentially)
            wave_fn = (_stage_fn_wave(plan, nv, self.cfg.use_kernel)
                       if plan and self.cfg.gate_schedule else None)
            sched = compile_schedule(plan, nv) if plan else None
            bound.append(_BoundStage(layout, plan, mats, fkey, fn, sched,
                                     wave_fn))
        self._bound[key] = bound
        while len(self._bound) > _BOUND_CACHE_SIZE:
            self._bound.popitem(last=False)
        return bound

    # -- batched parameter/trajectory binding ----------------------------------
    def _validate_bindings(self, bindings) -> None:
        """Cheap pre-flight of a batch: every lane's params must bind and
        a stochastic circuit needs a trajectory seed per lane — run
        BEFORE any state is invalidated."""
        if not bindings:
            raise ValueError("run_batch needs at least one lane")
        if not self.cfg.gate_schedule or self.cfg.per_gate:
            raise ValueError(
                "run_batch requires the scheduled stage compute "
                "(gate_schedule=True, per_gate=False)")
        for params, seed in bindings:
            self._check_params(params)
            if self._stochastic and seed is None:
                raise ValueError(
                    "stochastic circuit: every batch lane needs a "
                    "trajectory seed (pass seeds=... / trajectories=K)")

    def _bind_stages_batch(self, bindings: tuple) -> list[_BoundStage]:
        """Compile one *batch* binding — ``bindings`` is a tuple of
        ``(params, trajectory_seed)`` per lane.  Fusion/schedules are
        shared across lanes (structure depends only on gate supports);
        the operands are lane-stacked, tiled once to a full wave's rows
        (groups-major), and the stage fns lane-batched, so
        :meth:`run_batch` makes one call per (stage, wave) for the whole
        batch.  Cached like :meth:`_bind_stages`."""
        key = tuple((self._params_key(p), s) for p, s in bindings)
        cached = self._bound_batch.get(key)
        if cached is not None:
            self._bound_batch.move_to_end(key)
            return cached
        self._validate_bindings(bindings)
        # one rng per lane, threaded through the stages in circuit order:
        # a lane's realization is identical to circuit.realize(seed)'s
        rngs = [np.random.default_rng(s) if s is not None else None
                for _, s in bindings]
        params_list = [p for p, _ in bindings]
        bound = []
        for layout, gates in self._stages:
            lane_vgates, plan = fuse_stage_lanes(
                layout, gates, self.cfg.max_fused_qubits, params_list, rngs)
            mats = _stage_mats_batch(lane_vgates, plan, self.device)
            # the full wave's operand rows, built here once: every wave
            # slices them (a view), the last, shorter one included
            width = min(self.cfg.pipeline_depth, layout.n_groups)
            if width > 1:
                mats = [_lane_rows(m, width * len(bindings)) for m in mats]
            self.stats.n_fused_unitaries += len(plan) * len(bindings)
            nv = layout.b + layout.m
            fkey = (plan, nv, self.cfg.use_kernel, "batch", self._interpret)
            fn = (_stage_fn_batch(plan, nv, self.cfg.use_kernel)
                  if plan else None)
            sched = compile_schedule(plan, nv) if plan else None
            # the batched stage fn is already row-batched
            bound.append(_BoundStage(layout, plan, mats, fkey, fn, sched,
                                     fn))
        self._bound_batch[key] = bound
        while len(self._bound_batch) > _BOUND_CACHE_SIZE:
            self._bound_batch.popitem(last=False)
        return bound

    # -- the plan artifact -----------------------------------------------------
    def compile(self, params: dict | None = None) -> ExecutionPlan:
        """Freeze this engine's compile-time decisions for one binding
        into an :class:`ExecutionPlan` (cached per stage structure —
        parameter values don't change it).  A stochastic circuit compiles
        the seed-0 trajectory's realization (the layout/partition half —
        what ``--explain`` inspects — is realization-independent)."""
        if self._stochastic:
            bound = self._bind_stages_batch(((params, 0),))
        else:
            bound = self._bind_stages(params)
        skey = tuple(bs.plan for bs in bound)
        pkey = self._params_key(params)
        plan = self._plans.get(skey)
        if plan is None:
            plan = assemble_plan(
                self._circuit_fp, self.cfg, self.partition,
                [(bs.layout, bs.plan) for bs in bound],
                n_devices=len(self._devices), interpret=self._interpret,
                params_key=pkey, auto_tuned=self.auto_tuned)
            self._plans[skey] = plan
        elif plan.params_key != pkey:
            # same structure, different binding: the artifact must name
            # the binding it was asked for, not the first one cached
            plan = replace(plan, params_key=pkey)
        return plan

    def plan_fingerprint(self) -> str:
        """State-layout fingerprint of this engine's plan, computable
        without a parameter binding (partition + codec knobs only) —
        identical to ``compile(...).fingerprint``."""
        return plan_fingerprint(
            self._circuit_fp, self.n, self.b, self.cfg.inner_size,
            self.cfg.b_r, self.cfg.compression, self.cfg.prescan,
            [(tuple(st.inner), len(st.gates))
             for st in self.partition.stages])

    # -- initialization (§4.2 trick) -----------------------------------------
    @property
    def n_blocks(self) -> int:
        return 2 ** (self.n - self.b)

    def _init_state(self) -> None:
        self._init_lanes(0, 1)

    def _init_lanes(self, lane_base: int, lanes: int) -> None:
        """|0..0> in every lane of ``[lane_base, lane_base + lanes)``:
        the §4.2 trick generalizes — the one-hot first block and the zero
        block are each encoded once and aliased across blocks AND lanes."""
        bsz = 2 ** self.b
        n_blocks = self.n_blocks
        base_key = lane_base * n_blocks
        first = np.zeros(bsz, dtype=np.complex64)
        first[0] = 1.0
        self.backend.encode_host_block(base_key, first)
        if n_blocks > 1:
            self.backend.encode_host_block(base_key + 1,
                                           np.zeros(bsz, np.complex64))
        for lane in range(lanes):
            off = (lane_base + lane) * n_blocks
            for blk in range(n_blocks):
                key = off + blk
                if key == base_key or (n_blocks > 1 and key == base_key + 1):
                    continue
                self.store.put_alias(key,
                                     base_key if blk == 0 else base_key + 1)
        self.stats.n_block_compressions += min(n_blocks, 2)

    def _make_monitor(self, lanes: int = 1) -> PressureMonitor | None:
        """Arm the degradation ladder for one run (None when disabled)."""
        if not self.cfg.pressure_monitor:
            return None
        return PressureMonitor(
            predicted_bpa=estimate_bytes_per_amp(self.cfg.b_r,
                                                 self.cfg.compression),
            n_qubits=self.n, lanes=lanes,
            headroom=self.cfg.pressure_headroom,
            ram_budget=self.cfg.ram_budget_bytes,
            disk_budget=self.cfg.disk_budget_bytes)

    def _exchange_ledger(self, owners: dict, gids: np.ndarray,
                         slots: np.ndarray) -> int:
        """Account the compressed-wire exchange one stage boundary of a
        block-sharded run implies: every block whose owning device slot
        changed since the previous stage moves as its stored encoded blob
        (the store holds nothing rawer: both codec backends persist the
        same compressed BlockSegments format), so the bytes tallied here
        are exactly what would cross the interconnect.  ``owners`` maps
        block key -> previous slot and is updated in place; returns the
        bytes moved at this boundary."""
        moved = 0
        for g, row in enumerate(gids):
            slot = int(slots[g])
            for key in row:
                k = int(key)
                prev = owners.get(k)
                if prev is not None and prev != slot:
                    fault_point("pipeline.exchange")
                    moved += self.store.nbytes_of(k)
                    self.stats.n_exchanged_blocks += 1
                owners[k] = slot
        self.stats.exchange_bytes += moved
        return moved

    def _clear_lanes(self, new_lanes: int) -> None:
        """Drop the final states of lanes a previous (larger) batch left
        in the store — their keys would otherwise leak RAM forever."""
        n_blocks = self.n_blocks
        for lane in range(new_lanes, self._stored_lanes):
            for blk in range(n_blocks):
                self.store.delete(lane * n_blocks + blk)
        self._stored_lanes = new_lanes

    # -- main loop -------------------------------------------------------------
    def run(self, collect_state: bool = True, params: dict | None = None,
            start_stage: int = 0, on_stage_done=None) -> np.ndarray | None:
        """Execute the circuit through the staged pipeline.

        Repeated ``run()`` calls on one engine re-execute from |0...0>,
        reusing the partition, the compiled stage functions, and (per
        distinct ``params``) the fused unitaries; stats accumulate.

        Args:
            collect_state: decompress and return the final 2^n state
                (set False for memory benchmarks at large n).
            params: values for the circuit's free :class:`Parameter`
                placeholders (required iff the circuit is parameterized).
            start_stage: first stage index to execute — nonzero only when
                resuming from a checkpoint whose store already holds the
                state after ``start_stage`` stages (skips |0..0> init).
            on_stage_done: optional ``callback(stage_idx)`` invoked after
                each stage's store barrier (checkpoint hook).

        Returns:
            The final complex64 state vector (numpy, on the host), or None.
        """
        t_start = time.perf_counter()
        bound = self._bind_stages(params)
        self.stats.n_runs += 1
        self.stats.n_lanes = 1
        # per-run, not lifetime: a parameter sweep must not grow this
        # list without bound (scalar byte counters keep the totals)
        self.stats.per_stage_boundary_bytes = []
        self.stats.per_stage_exchange_bytes = []
        if start_stage == 0:
            self._clear_lanes(1)
            self._init_state()
        pipe = StagePipeline(self.backend, depth=self.cfg.pipeline_depth,
                             devices=self._devices)
        monitor = self._make_monitor()
        # snapshot the backend's lifetime counters so repeated run() calls
        # on one engine accumulate deltas, not running totals
        back = self.backend
        h2d0, d2h0 = back.h2d_bytes, back.d2h_bytes
        dec0, com0 = back.n_decompressions, back.n_compressions
        first_done = False
        # block sharding (D > 1): groups follow the plan's device_slot
        # round-robin; `owners` tracks each block's slot so stage
        # boundaries account exactly the blocks that change hands
        D = len(self._devices)
        owners: dict[int, int] = {}
        with pipe, torch.no_grad():
            for idx, bs in enumerate(bound):
                if idx < start_stage or not bs.plan:
                    continue
                # stage-function reuse accounting: a sweep must show zero
                # new compiles after its first run
                if bs.key in self._seen_stagefns:
                    self.stats.n_stagefn_cache_hits += 1
                else:
                    self._seen_stagefns.add(bs.key)
                    self.stats.n_stagefn_compiles += 1
                # transpose accounting: both counters are recorded
                # whichever path executes, so the scheduled/naive ratio is
                # always reportable
                self.stats.n_transposes_naive += \
                    bs.sched.n_transposes_naive * bs.layout.n_groups
                self.stats.n_transposes_scheduled += \
                    bs.sched.n_transposes * bs.layout.n_groups
                sh2d, sd2h = back.h2d_bytes, back.d2h_bytes
                gids = bs.layout.group_block_ids()
                group_devices = None
                if D > 1:
                    slots = device_slots(gids.shape[0], D)
                    self.stats.per_stage_exchange_bytes.append(
                        self._exchange_ledger(owners, gids, slots))
                    group_devices = [self._devices[int(s)] for s in slots]
                else:
                    self.stats.per_stage_exchange_bytes.append(0)
                pipe.run_stage(gids, bs.fn, bs.mats, wave_fn=bs.wave_fn,
                               group_devices=group_devices)
                self.stats.per_stage_boundary_bytes.append(
                    (back.h2d_bytes - sh2d, back.d2h_bytes - sd2h))
                if not first_done:
                    # calibrate the planner's compression-ratio estimate
                    # against the first encoded stage (§4.4)
                    first_done = True
                    self.stats.bytes_per_amp_measured = \
                        self.store.total_bytes / 2 ** self.n
                if on_stage_done is not None:
                    on_stage_done(idx)
                if monitor is not None:
                    # after on_stage_done: a periodic checkpoint for this
                    # stage lands on disk before an abort can reference it
                    monitor.check(self.store, pipe, self.stats, idx + 1)
        self.stats.t_decompress += pipe.t_load
        self.stats.t_compute += pipe.t_compute
        self.stats.t_fetch += pipe.t_fetch
        self.stats.t_compress += pipe.t_store
        self.stats.n_group_phases += pipe.n_group_phases
        self.stats.h2d_bytes += back.h2d_bytes - h2d0
        self.stats.d2h_bytes += back.d2h_bytes - d2h0
        self.stats.n_block_decompressions += back.n_decompressions - dec0
        self.stats.n_block_compressions += back.n_compressions - com0
        self.stats.t_total += time.perf_counter() - t_start
        self._snap_store_stats()
        if collect_state:
            return self._collect()
        return None

    # -- batched execution -----------------------------------------------------
    def feasible_lanes(self, lanes: int) -> int:
        """Largest sub-batch the memory budget admits (== ``lanes`` when
        no budget is set); :meth:`run_batch` chunks to this size."""
        budget = self.cfg.memory_budget_bytes
        if budget is None or lanes <= 1:
            return max(1, lanes)
        max_m = max((layout.m for layout, _ in self._stages), default=0)
        return max_feasible_lanes(
            self.n, self.b, max_m, self.cfg.pipeline_depth,
            estimate_bytes_per_amp(self.cfg.b_r, self.cfg.compression),
            budget, lanes, n_devices=len(self._devices))

    def run_batch(self, bindings) -> None:
        """Execute the circuit for a whole batch of bindings at once.

        ``bindings`` is a sequence of ``(params, trajectory_seed)`` pairs
        — one lane per parameter-sweep point or noise trajectory.  Every
        lane flows through the staged pipeline together: per (stage,
        wave), ONE lane-batched stage call (one ``gemm_planes_batch``
        launch per ``GemmOp``, one encode and one decode launch on the
        device codec), ONE boundary crossing, and one store barrier
        cover all K lanes.

        Lane ``j``'s final compressed state lands under store keys
        ``[j * n_blocks, (j+1) * n_blocks)``; read it back through a
        :class:`~repro_torch.core.result.BatchResult` lane view.  When a
        memory budget is set and the K-lane working set would break it,
        the batch executes in chunked sub-batches of
        :meth:`feasible_lanes` lanes (with a ``RuntimeWarning``) — the
        result is identical, the staging peak smaller.
        """
        t_start = time.perf_counter()
        bindings = tuple(bindings)
        self._validate_bindings(bindings)
        lanes = len(bindings)
        chunk = self.feasible_lanes(lanes)
        if chunk < lanes:
            warnings.warn(
                f"batch of {lanes} lanes exceeds the memory budget "
                f"({self.cfg.memory_budget_bytes} B); executing "
                f"{-(-lanes // chunk)} chunked sub-batches of <= {chunk}",
                RuntimeWarning, stacklevel=2)
        self.stats.n_runs += 1
        self.stats.n_lanes = lanes
        self.stats.n_batch_chunks = -(-lanes // chunk)
        self.stats.per_stage_boundary_bytes = []
        self.stats.per_stage_exchange_bytes = []
        # every lane re-initializes below, but chunk c's init only touches
        # chunk c's keys — drop ALL previous-run states up front so a
        # chunked batch never carries stale lanes through its first
        # sub-batches (inflating peak RAM and the first-chunk calibration)
        self._clear_lanes(0)
        self._stored_lanes = lanes
        monitor = self._make_monitor(lanes)
        for base in range(0, lanes, chunk):
            self._run_lane_chunk(bindings[base:base + chunk], base, monitor)
        self.stats.t_total += time.perf_counter() - t_start
        self._snap_store_stats()

    def _run_lane_chunk(self, bindings: tuple, lane_base: int,
                        monitor: PressureMonitor | None = None) -> None:
        """One feasible sub-batch: bind, init its lanes, walk the plan
        with lane-batched pipeline stages."""
        bound = self._bind_stages_batch(bindings)
        lanes = len(bindings)
        self._init_lanes(lane_base, lanes)
        if monitor is not None:
            # bpa denominator: lanes materialized so far (finished
            # chunks' final states stay resident in the store)
            monitor.lanes = lane_base + lanes
        offsets = (lane_base + np.arange(lanes, dtype=np.int64)) \
            * self.n_blocks
        # lane sharding (D > 1): contiguous near-even lane slices, one a
        # slot, merged per distinct device.  Each shard owns a disjoint
        # store-key range, so lanes never change hands: exchange bytes stay
        # 0 and the only gather is the readout
        shards = None
        if len(self._devices) > 1 and lanes > 1:
            shards = _lanes_by_device(make_lane_shards(self._devices, lanes))
        pipe = StagePipeline(self.backend, depth=self.cfg.pipeline_depth,
                             devices=self._devices)
        back = self.backend
        h2d0, d2h0 = back.h2d_bytes, back.d2h_bytes
        dec0, com0 = back.n_decompressions, back.n_compressions
        first_done = False
        with pipe, torch.no_grad():
            for stage_no, bs in enumerate(bound):
                if not bs.plan:
                    continue
                if bs.key in self._seen_stagefns:
                    self.stats.n_stagefn_cache_hits += 1
                else:
                    self._seen_stagefns.add(bs.key)
                    self.stats.n_stagefn_compiles += 1
                # one batched schedule execution transposes the whole
                # (L, ...) lane stack in a single pass — count per group,
                # not per lane (that is the point)
                self.stats.n_transposes_naive += \
                    bs.sched.n_transposes_naive * bs.layout.n_groups * lanes
                self.stats.n_transposes_scheduled += \
                    bs.sched.n_transposes * bs.layout.n_groups
                sh2d, sd2h = back.h2d_bytes, back.d2h_bytes
                pipe.run_stage(bs.layout.group_block_ids(), bs.fn, bs.mats,
                               lane_offsets=offsets, wave_fn=bs.wave_fn,
                               lane_shards=shards)
                self.stats.per_stage_boundary_bytes.append(
                    (back.h2d_bytes - sh2d, back.d2h_bytes - sd2h))
                self.stats.per_stage_exchange_bytes.append(0)
                if not first_done and lane_base == 0:
                    # calibrate on the first chunk only: later chunks'
                    # store totals include finished lanes' final states
                    first_done = True
                    self.stats.bytes_per_amp_measured = \
                        self.store.total_bytes / (2 ** self.n * lanes)
                if monitor is not None:
                    monitor.check(self.store, pipe, self.stats,
                                  stage_no + 1)
        self.stats.t_decompress += pipe.t_load
        self.stats.t_compute += pipe.t_compute
        self.stats.t_fetch += pipe.t_fetch
        self.stats.t_compress += pipe.t_store
        self.stats.n_group_phases += pipe.n_group_phases
        self.stats.h2d_bytes += back.h2d_bytes - h2d0
        self.stats.d2h_bytes += back.d2h_bytes - d2h0
        self.stats.n_block_decompressions += back.n_decompressions - dec0
        self.stats.n_block_compressions += back.n_compressions - com0

    def _snap_store_stats(self) -> None:
        s = self.store.stats
        self.stats.peak_ram_bytes = s.peak_ram_bytes
        self.stats.peak_total_bytes = s.peak_total_bytes
        self.stats.disk_bytes = s.disk_bytes
        self.stats.n_spills = s.n_spills
        self.stats.n_io_retries = s.n_io_retries
        self.stats.n_proactive_spills = s.n_proactive_spills
        self.stats.n_corruptions_detected = s.n_corruptions_detected

    def _collect(self) -> np.ndarray:
        return collect_statevector(self.backend, self.n, self.b)

    def close(self) -> None:
        self.store.close()


def simulate_bmqsim(circuit: Circuit, config: EngineConfig,
                    collect_state: bool = True):
    """Simulate ``circuit`` with the compressed staged engine (one-shot
    compat wrapper; prefer :class:`~repro_torch.core.simulator.Simulator`).

    Returns:
        ``(state, stats)`` — the final complex64 state vector (numpy, or
        None) and the run's :class:`SimStats`.
    """
    eng = BMQSimEngine(circuit, config)
    try:
        state = eng.run(collect_state=collect_state)
        return state, eng.stats
    finally:
        eng.close()
