"""The BMQSIM engine (paper §4): compressed, staged state-vector simulation.

Execution model per stage (from the §4.1 partition):

    for each SV group (independent):
        load/decode  2^m member blocks -> flat 2^(b+m) group array
        compute      the stage's fused unitaries              (device)
        encode/store the 2^m blocks -> two-level store

Phase orchestration lives in :mod:`repro_torch.core.pipeline`: host phases
of *different* groups overlap through worker threads while the device work
of a wave is queued on the CUDA stream (§4.2's transfer-concealed
workflow).  The codec runs on the host (``codec_backend="host"``): raw
group arrays cross the host↔device boundary.

On the device the group is *planes-resident*: it lives as a (2, 2^(b+m))
f32 re/im plane stack from decode through every fused gate to encode, and
each stage's gate list is compiled into a transpose-minimizing schedule
(:mod:`repro_torch.core.schedule`) whose dense minor-most gates run in the
hand-written ``gemm_planes_batch`` kernel.

This is the PyTorch port of ``repro.core.engine``: one circuit, one device,
one lane.  Batched runs, several devices and the per-gate path raise
``NotImplementedError`` until they are ported.
"""
from __future__ import annotations

import time
from collections import OrderedDict
from dataclasses import dataclass, field, replace
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from ..compression.pwrel import PwRelParams
from ..compression.store import BlockStore
from .circuit import Circuit, Gate
from .devices import resolve_device
from .fusion import FusedGate
from .groups import GroupLayout
from .partition import Partition, Stage, partition_circuit
from .pipeline import StagePipeline, make_backend
from .plan import ExecutionPlan, circuit_fingerprint, plan_fingerprint
from .planner import (assemble_plan, estimate_bytes_per_amp, fuse_stage,
                      resolve_config)
from .pressure import PressureMonitor
from .result import collect_statevector
from .schedule import StageSchedule, compile_schedule, execute_schedule_batched

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
            host↔device boundary; ``"device"`` (the device-resident
            codec) is not ported yet and raises ``NotImplementedError``
            with compression on.
        ram_budget_bytes: primary-tier budget of the two-level store (§4.4);
            overflow spills to disk.
        spill_dir: secondary-tier directory (default: a temp dir).
        use_kernel: apply every dense minor-most gate through the
            hand-written ``gemm_planes_batch`` kernel instead of plain
            torch products (default: on; on the CPU the kernel wrapper
            runs its plain version).
        gate_schedule: compile each stage's gate list into a
            transpose-minimizing schedule over f32 re/im planes
            (:mod:`repro_torch.core.schedule`).  False (the per-gate
            path) is not ported yet and raises ``NotImplementedError``.
        devices: the run's device, as a one-element list of
            :class:`torch.device` (default: ``cuda:0``, which must
            exist; pass ``[torch.device("cpu")]`` to run the kernels'
            plain versions on the CPU).  More than one device is not
            ported yet and raises ``NotImplementedError``.
        mesh_shape: a 1-D simulation mesh; not ported yet (raises
            ``NotImplementedError``).
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
# stage compute: fused unitaries applied to a planes-resident wave
# --------------------------------------------------------------------------

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
                device: torch.device) -> list[torch.Tensor]:
    """Per-gate operands of the scheduled path on ``device``: stacked
    (2, K, K) f32 planes of U, or (2, K) diagonal planes."""
    mats = []
    for fg, (_, diag) in zip(vgates, plan):
        m = np.diag(fg.matrix) if diag else fg.matrix
        mats.append(torch.as_tensor(
            np.stack([m.real, m.imag]).astype(np.float32), device=device))
    return mats


class _BoundStage(NamedTuple):
    """One stage, fully compiled for one parameter binding: everything
    :meth:`BMQSimEngine.run` needs — built once at bind/plan time, never
    inside the run loop."""

    layout: GroupLayout
    plan: tuple                       # ((vqubits, is_diagonal), ...)
    mats: list                        # binding-specific operands
    key: tuple                        # stage-fn cache key
    sched: StageSchedule | None       # compiled schedule (None if empty)
    wave_fn: object = None            # row-batched update (wave scheduler)


def _not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP {item})")


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

    The run's device is ``config.devices[0]`` (default ``cuda:0``).  On
    the CPU the kernels' plain versions run and the plan records
    ``interpret=True``; on CUDA the kernels launch and it records False.

    Use :class:`~repro_torch.core.simulator.Simulator` unless you need to
    poke at engine internals between construction and run.
    """

    def __init__(self, circuit: Circuit, config: EngineConfig,
                 *, store: BlockStore | None = None,
                 plan: ExecutionPlan | None = None):
        if config.mesh_shape is not None:
            raise _not_ported("a simulation mesh (mesh_shape)", "A10")
        if config.devices and len(config.devices) > 1:
            raise _not_ported("multi-device placement", "A10")
        if not config.gate_schedule:
            raise _not_ported("the per-gate path (gate_schedule=False)",
                              "A9")
        self.circuit = circuit
        self._circuit_fp = circuit_fingerprint(circuit)
        self.n = circuit.n_qubits
        self.device = resolve_device(config.devices[0] if config.devices
                                     else None)
        self._devices = [self.device]
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
                circuit, config, n_devices=1)
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
        self._seen_stagefns: set[tuple] = set()
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
            raise _not_ported("stochastic trajectories (run_batch)", "A7")
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
            mats = _stage_mats(vgates, plan, self.device)
            self.stats.n_fused_unitaries += len(vgates)
            nv = layout.b + layout.m
            fkey = (plan, nv, self.cfg.use_kernel, self.cfg.gate_schedule,
                    self._interpret)
            wave_fn = (_stage_fn_wave(plan, nv, self.cfg.use_kernel)
                       if plan else None)
            sched = compile_schedule(plan, nv) if plan else None
            bound.append(_BoundStage(layout, plan, mats, fkey, sched,
                                     wave_fn))
        self._bound[key] = bound
        while len(self._bound) > _BOUND_CACHE_SIZE:
            self._bound.popitem(last=False)
        return bound

    # -- the plan artifact -----------------------------------------------------
    def compile(self, params: dict | None = None) -> ExecutionPlan:
        """Freeze this engine's compile-time decisions for one binding
        into an :class:`ExecutionPlan` (cached per stage structure —
        parameter values don't change it)."""
        bound = self._bind_stages(params)
        skey = tuple(bs.plan for bs in bound)
        pkey = self._params_key(params)
        plan = self._plans.get(skey)
        if plan is None:
            plan = assemble_plan(
                self._circuit_fp, self.cfg, self.partition,
                [(bs.layout, bs.plan) for bs in bound],
                n_devices=1, interpret=self._interpret,
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
        """|0..0>: the one-hot first block and the zero block are each
        encoded once and aliased across the remaining blocks (§4.2)."""
        bsz = 2 ** self.b
        n_blocks = self.n_blocks
        first = np.zeros(bsz, dtype=np.complex64)
        first[0] = 1.0
        self.backend.encode_host_block(0, first)
        if n_blocks > 1:
            self.backend.encode_host_block(1, np.zeros(bsz, np.complex64))
        for blk in range(2, n_blocks):
            self.store.put_alias(blk, 1)
        self.stats.n_block_compressions += min(n_blocks, 2)

    def _make_monitor(self) -> PressureMonitor | None:
        """Arm the degradation ladder for one run (None when disabled)."""
        if not self.cfg.pressure_monitor:
            return None
        return PressureMonitor(
            predicted_bpa=estimate_bytes_per_amp(self.cfg.b_r,
                                                 self.cfg.compression),
            n_qubits=self.n, lanes=1,
            headroom=self.cfg.pressure_headroom,
            ram_budget=self.cfg.ram_budget_bytes,
            disk_budget=self.cfg.disk_budget_bytes)

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
            self._init_state()
        pipe = StagePipeline(self.backend, depth=self.cfg.pipeline_depth,
                             device=self.device)
        monitor = self._make_monitor()
        # snapshot the backend's lifetime counters so repeated run() calls
        # on one engine accumulate deltas, not running totals
        back = self.backend
        h2d0, d2h0 = back.h2d_bytes, back.d2h_bytes
        dec0, com0 = back.n_decompressions, back.n_compressions
        first_done = False
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
                self.stats.n_transposes_naive += \
                    bs.sched.n_transposes_naive * bs.layout.n_groups
                self.stats.n_transposes_scheduled += \
                    bs.sched.n_transposes * bs.layout.n_groups
                sh2d, sd2h = back.h2d_bytes, back.d2h_bytes
                self.stats.per_stage_exchange_bytes.append(0)
                pipe.run_stage(bs.layout.group_block_ids(), bs.wave_fn,
                               bs.mats)
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

    def run_batch(self, bindings) -> None:
        """Lane-batched execution — not ported yet (ROADMAP A7)."""
        raise _not_ported("BMQSimEngine.run_batch", "A7")

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
