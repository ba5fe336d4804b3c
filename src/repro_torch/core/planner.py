"""Planner: budget-driven auto-tuning of the simulation knobs (§4.4).

The knobs that decide everything about a run — ``local_bits`` (SV block
size), ``inner_size`` (Algorithm 1's stage threshold) and
``pipeline_depth`` — were hand-picked constants.  This module chooses
them with a cost model under a user-supplied ``memory_budget_bytes``:

    cost      minimize stage count (one decompress/recompress sweep of
              the whole state each), then group-weighted transposes,
              then prefer larger blocks (bigger GEMMs, fewer boundary
              round trips)
    subject   predicted store peak + pipeline staging working set fits
              the budget

The compression ratio is *estimated* from ``b_r`` (a conservative
entropy-style model of the pwrel code stream — see
:func:`estimate_bytes_per_amp`); the engine *calibrates* the estimate
against the first encoded stage at run time
(``SimStats.bytes_per_amp_measured``), and the resolved config always
carries the budget into the two-level store's ``ram_budget_bytes`` as
the backstop, so a mispredicted ratio spills to disk instead of
aborting — the store guarantees ``peak_ram_bytes <= budget`` even when
the model is wrong.

Entry points:

* :func:`resolve_config` — concrete :class:`EngineConfig` from one with
  ``local_bits=None`` ("auto"); runs the search when a budget is set,
  falls back to a documented heuristic otherwise.
* :func:`fuse_stage` — the one place a stage's gates become the
  structural fused plan the engine keys its caches on (shared with
  :meth:`BMQSimEngine._bind_stages` so planner and executor can't drift).
* :func:`assemble_plan` — freeze a bound engine state into an
  :class:`~repro_torch.core.plan.ExecutionPlan` with predictions.
"""
from __future__ import annotations

import math
import warnings
from dataclasses import dataclass, replace

from .fusion import FusedGate, fuse_gates
from .groups import GroupLayout
from .partition import partition_circuit
from .plan import ExecutionPlan, PlanPredictions, StagePlan
from .schedule import compile_schedule

__all__ = ["DEFAULT_INNER_SIZE", "DEFAULT_PIPELINE_DEPTH",
           "PipelineCalibration", "DEFAULT_CALIBRATION",
           "predict_depth_speedup",
           "estimate_bytes_per_amp", "wire_bytes_per_block",
           "resolve_config", "fuse_stage", "fuse_stage_lanes",
           "max_feasible_lanes", "peak_ram_for", "assemble_plan"]

DEFAULT_INNER_SIZE = 2
DEFAULT_PIPELINE_DEPTH = 2

#: auto search never proposes blocks above 2^20 amplitudes (group arrays
#: must stay jit-traceable and cache-friendly even with inner_size added)
MAX_AUTO_LOCAL_BITS = 20

#: per-block constant overhead in the store (headers, dict slots)
_BLOCK_OVERHEAD = 64

#: inner-size candidates the search sweeps (partition clamps below 2)
_INNER_CANDIDATES = (2, 3, 4)

#: log2 dynamic range the code stream is assumed to span (typical SV
#: blocks concentrate within ~2^40 of their max; wider tails quantize to
#: the exact-zero escape and compress away)
_SPAN_LOG2 = 40.0


@dataclass(frozen=True)
class PipelineCalibration:
    """Measured (or assumed) per-group phase costs of the stage pipeline
    — the inputs of :func:`predict_depth_speedup`.

    The four timings are *per group-phase* (any consistent unit — only
    ratios matter): ``t_load`` host fetch/decode, ``t_compute`` the
    H2D-staging + compute + encode *dispatch* cost, ``t_fetch`` the
    blocking device→host await, ``t_store`` host encode/store.  The
    engine records them into ``SimStats`` and hands them back via
    :meth:`SimStats.pipeline_calibration`.

    ``measured`` optionally pins whole-depth speedups observed on the
    target machine (``((depth, speedup), ...)``, e.g. transcribed from a
    benchmark dump): a measurement always beats the model, so a recorded
    losing profile can never be re-chosen by the auto-tuner.
    """

    t_load: float
    t_compute: float
    t_fetch: float
    t_store: float
    measured: tuple = ()

    def measured_speedup(self, depth: int) -> float | None:
        for d, s in self.measured:
            if d == depth:
                return s
        return None


#: default profile of the scheduled planes path on the dev box (BENCH_6
#: shape): the per-group cost is dominated by the host codec halves and
#: the per-dispatch overhead; the blocking await is short because the
#: device compute drains while the host codec works
DEFAULT_CALIBRATION = PipelineCalibration(
    t_load=1.0, t_compute=0.45, t_fetch=0.1, t_store=0.9)

#: fractional growth of the blocking await per coalesced wave: a wave of
#: d groups awaits one d-times-larger result, which is not entirely free
_WAVE_TAX = 0.25


def predict_depth_speedup(depth: int,
                          calibration: PipelineCalibration | None = None
                          ) -> float:
    """Predicted whole-run speedup of ``pipeline_depth=depth`` over the
    strictly sequential ``depth=1`` schedule.

    Model of the wave-coalesced pipeline (core/pipeline.py): a wave of
    ``d`` groups pays the host codec per group (``t_load`` + ``t_store``
    do not shrink), ONE compute/encode dispatch for the whole wave
    (``t_compute / d`` per group — the amortization that makes depth
    win on dispatch-bound configs), and a slightly larger blocking
    await (``t_fetch`` grown by ``_WAVE_TAX`` at full coalescing).  No
    parallel-speedup credit is taken for the worker threads — on a
    single-core host there is none to take, so the model stays
    conservative.  A ``calibration.measured`` entry for ``depth``
    overrides the model entirely.
    """
    cal = calibration if calibration is not None else DEFAULT_CALIBRATION
    m = cal.measured_speedup(depth)
    if m is not None:
        return m
    if depth <= 1:
        return 1.0
    serial = cal.t_load + cal.t_compute + cal.t_fetch + cal.t_store
    if serial <= 0:
        return 1.0
    piped = (cal.t_load + cal.t_store + cal.t_compute / depth
             + cal.t_fetch * (1.0 + _WAVE_TAX * (1.0 - 1.0 / depth)))
    return serial / piped


def _auto_depth(cands, calibration) -> int:
    """Deepest candidate whose predicted speedup is >= 1 (depth 1 is
    always admissible — the auto-tuner must never pick a losing depth)."""
    best = 1
    for d in cands:
        if d is None:
            continue
        if d <= 1 or predict_depth_speedup(d, calibration) >= 1.0:
            best = max(best, d)
    return best


def estimate_bytes_per_amp(b_r: float, compression: bool = True) -> float:
    """Conservatively estimated *stored* bytes per complex amplitude.

    Model: each of the two f32 planes stores a uint16 code stream plus a
    1-bit sign bitmap.  The codes span roughly ``_SPAN_LOG2 / step``
    distinct values (``step = 2 log2(1+b_r)``), so an entropy coder needs
    about ``log2(span/step)`` bits each; zlib level 1 is charged ~2 bits
    of slack over that.  The RAW escape caps every block at 8 B/amp —
    compression never inflates — so the estimate is clipped there.
    Deliberately conservative: real SV blocks (concentrated amplitudes,
    repeated signs, the all-zero init) compress better, and a *low*
    estimate is the dangerous direction for a budget guarantee.
    """
    if not compression:
        return 8.0
    step = 2.0 * math.log2(1.0 + b_r)
    span_codes = max(2.0, _SPAN_LOG2 / step)
    code_bits = min(16.0, math.log2(span_codes) + 2.0)
    per_plane = code_bits / 8.0 + 0.125          # codes + sign bitmap
    return min(8.0, 2.0 * per_plane)


def wire_bytes_per_block(bsz: int, codec_backend: str,
                         compression: bool) -> int:
    """Bytes one block moves across the host<->device boundary, one way.

    The device codec ships packed uint16 codes + ballot sign words + an
    ``l_max`` scalar per plane (~4.25 B/amp); the host backend moves raw
    complex64 (8 B/amp).
    """
    if codec_backend == "device" and compression:
        return 2 * (2 * bsz + 4 * math.ceil(bsz / 32) + 4)
    return 8 * bsz


def _predict_working_set(n: int, b: int, max_m: int, depth: int,
                         bpa: float, lanes: int = 1,
                         n_devices: int = 1) -> tuple[int, int]:
    """(store peak, pipeline staging) in bytes for one candidate —
    **per device** of an ``n_devices`` mesh (the whole machine at the
    default ``n_devices=1``).

    Store peak: the whole compressed state plus ``depth + 1`` groups'
    worth of fresh blobs coexisting with the blocks they replace (the
    store binds the new blob before releasing the old).  Pipeline
    staging: the wave scheduler holds, per ``depth``-group wave, up to
    two waves on-device (one computing, one decoded ahead), two
    lookahead waves in the fetch worker, and one in-flight result — ~5
    waves of complex64-sized group arrays at ``depth >= 2``, 3 group
    arrays in the strictly sequential ``depth=1`` schedule.  That is the
    host backend's (larger) footprint, so the bound holds for both
    backends.

    ``lanes`` is the batch factor K: a batched run keeps K compressed
    state copies in the store and stages K-lane group stacks through the
    pipeline, so everything scales linearly with it.

    Sharded placement (``n_devices > 1``) divides what a device holds:
    a batched run shards *lanes* (``ceil(K / D)`` lanes per device — the
    busiest device's share), a single-lane run shards *blocks*
    (``ceil(state / D)``, the device_slot round-robin) while every wave
    still stages one full group.  The busiest-device model is what the
    per-device ``memory_budget_bytes`` compares against.
    """
    lanes = max(1, lanes)
    d = max(1, n_devices)
    n_blocks = 1 << (n - b)
    state_one = int((1 << n) * bpa) + n_blocks * _BLOCK_OVERHEAD
    if d == 1:
        state, staged_lanes = lanes * state_one, lanes
    elif lanes > 1:
        staged_lanes = -(-lanes // d)        # busiest device's lane share
        state = staged_lanes * state_one
    else:
        state, staged_lanes = -(-state_one // d), 1   # block round-robin
    group = 1 << (b + max_m)
    peak_ram = state + (depth + 1) * int(group * bpa) * staged_lanes
    waves = 5 * depth if depth > 1 else 3
    pipeline = waves * group * 8 * staged_lanes
    return peak_ram, pipeline


def max_feasible_lanes(n: int, b: int, max_m: int, depth: int, bpa: float,
                       budget: int, lanes: int, n_devices: int = 1) -> int:
    """Largest sub-batch K' <= ``lanes`` whose predicted batched working
    set fits ``budget`` (>= 1: a single lane always runs, relying on the
    store's spill backstop when even that exceeds the budget).  The
    engine chunks an infeasible ``run_batch`` into sub-batches of this
    size.  ``budget`` is per device: on an ``n_devices`` mesh the lanes
    shard, so chunking engages only when the busiest device's lane share
    overflows — the whole mesh must be exhausted first."""
    for cand in range(max(1, lanes), 1, -1):
        peak, pipe = _predict_working_set(n, b, max_m, depth, bpa, cand,
                                          n_devices)
        if peak + pipe <= budget:
            return cand
    return 1


def peak_ram_for(plan, lanes: int = 1, n_devices: int = 1) -> int:
    """Admission-side predicted peak RAM (store peak + pipeline staging,
    bytes) of executing ``plan`` with ``lanes`` concurrent lanes.

    This is the quantity a multi-tenant scheduler sums against a global
    memory budget (see :class:`repro_torch.core.service.SimService`): it reads
    everything from the frozen :class:`~repro_torch.core.plan.ExecutionPlan`
    artifact — no circuit, partition or engine needed — and uses exactly
    the cost model ``resolve_config`` planned under, so admission
    decisions are consistent with what the planner promised.  The model
    is **linear in** ``lanes`` (state copies, staged group stacks and
    pipeline waves all scale with the lane count), which is what makes
    per-job reservations sum exactly: merging K admitted jobs into one
    lane stack needs precisely the K reservations already held.

    ``n_devices=1`` (the default) prices the whole-host working set —
    the right quantity for a single-host service budget; pass the mesh
    size to price the busiest device's share instead (the
    ``per_device_peak_bytes`` form).
    """
    max_m = max((st.layout.m for st in plan.stages), default=0)
    bpa = estimate_bytes_per_amp(plan.b_r, plan.compression)
    peak, pipe = _predict_working_set(
        plan.n_qubits, plan.local_bits, max_m, plan.pipeline_depth, bpa,
        max(1, lanes), n_devices)
    return peak + pipe


def _default_auto(n: int) -> tuple[int, int, int]:
    """No-budget heuristic: paper-ish blocks of 2^(n-4) (>= 16 blocks, so
    stages and groups exist to pipeline), capped at 2^MAX_AUTO_LOCAL_BITS."""
    b = max(1, min(MAX_AUTO_LOCAL_BITS, n - 4))
    return b, DEFAULT_INNER_SIZE, DEFAULT_PIPELINE_DEPTH


def _transpose_cost(circuit, b: int, m: int, part, max_fused: int) -> int:
    """Tie-break metric: elements moved by full-group transposes across
    the whole run (compiled schedule, group-weighted)."""
    cost = 0
    for st in part.stages:
        layout = GroupLayout(circuit.n_qubits, b, tuple(st.inner))
        _, plan = fuse_stage(layout, st.gates, max_fused)
        if not plan:
            continue
        nv = layout.b + layout.m
        sched = compile_schedule(plan, nv)
        cost += sched.n_transposes * layout.n_groups * (1 << nv)
    return cost


def resolve_config(circuit, config, n_devices: int = 1,
                   calibration: PipelineCalibration | None = None):
    """Concrete engine knobs from a possibly-auto :class:`EngineConfig`.

    Returns ``(resolved_config, auto_tuned, partition)`` — ``partition``
    is the winning candidate's (already computed) stage partition when
    the budget search ran, else ``None`` (the engine partitions itself).
    ``local_bits=None`` triggers the budget search (or the no-budget
    heuristic); ``inner_size``/``pipeline_depth`` left ``None`` resolve
    to their defaults, and ``memory_budget_bytes`` always flows into the
    store's ``ram_budget_bytes`` backstop unless one was given
    explicitly.

    An auto ``pipeline_depth`` consults :func:`predict_depth_speedup`
    under ``calibration`` (default profile when None; pass
    ``SimStats.pipeline_calibration()`` to re-plan from measurements):
    the tuner never selects a depth whose predicted speedup is < 1 — an
    explicitly requested depth is always honored verbatim.

    ``memory_budget_bytes`` is **per device**: on an ``n_devices`` mesh a
    candidate is feasible when the busiest device's predicted share fits,
    and the store's derived ``ram_budget_bytes`` backstop scales to the
    whole mesh (``budget * n_devices`` — the host store holds every
    device's partition), so chunking/spilling engage only when the whole
    mesh is exhausted, not when one device's budget would be.
    """
    budget = config.memory_budget_bytes
    ram_budget = (config.ram_budget_bytes
                  if config.ram_budget_bytes is not None
                  else budget * max(1, n_devices) if budget is not None
                  else None)
    if config.local_bits is not None:
        return replace(
            config,
            inner_size=(config.inner_size if config.inner_size is not None
                        else DEFAULT_INNER_SIZE),
            pipeline_depth=(config.pipeline_depth
                            if config.pipeline_depth is not None
                            else _auto_depth((DEFAULT_PIPELINE_DEPTH, 1),
                                             calibration)),
            ram_budget_bytes=ram_budget), False, None

    n = circuit.n_qubits
    if budget is None:
        b, m, depth = _default_auto(n)
        if config.inner_size is not None:
            m = config.inner_size
        if config.pipeline_depth is not None:
            depth = config.pipeline_depth
        else:
            depth = _auto_depth((depth, 1), calibration)
        return replace(config, local_bits=b, inner_size=m,
                       pipeline_depth=depth,
                       ram_budget_bytes=ram_budget), True, None

    bpa = estimate_bytes_per_amp(config.b_r, config.compression)
    lanes = max(1, config.batch)          # provision for the batch factor
    inner_cands = ((config.inner_size,) if config.inner_size is not None
                   else _INNER_CANDIDATES)
    if config.pipeline_depth is not None:
        depth_cands = (config.pipeline_depth,)
    else:
        # deepest-first, losing depths dropped up front: the per-(b, m)
        # scan below keeps "deepest fitting pipeline wins" semantics
        # among depths the overlap model actually endorses
        depth_cands = tuple(
            d for d in (DEFAULT_PIPELINE_DEPTH, 1)
            if d <= 1 or predict_depth_speedup(d, calibration) >= 1.0)
    feasible: list[tuple] = []
    fallback = None                       # least-working-set candidate
    for b in range(min(n, MAX_AUTO_LOCAL_BITS), 0, -1):
        for m in inner_cands:
            eff_m = min(max(m, 2), n - b)     # partition's clamped threshold
            part = partition_circuit(circuit, b, m)
            for depth in depth_cands:
                peak, pipe = _predict_working_set(n, b, eff_m, depth, bpa,
                                                  lanes, n_devices)
                cand = (part.n_stages, b, m, depth, peak + pipe, part)
                if fallback is None or peak + pipe < fallback[4]:
                    fallback = cand
                if peak + pipe <= budget:
                    feasible.append(cand)
                    break                     # deepest fitting pipeline wins

    if not feasible:
        n_stages, b, m, depth, ws, part = fallback
        warnings.warn(
            f"memory budget {budget} B is below the smallest feasible "
            f"working set ({ws} B at local_bits={b}"
            + (f", batch={lanes}" if lanes > 1 else "") + "); planning "
            "the smallest candidate and relying on the disk spill tier "
            "(batched runs fall back to chunked sub-batches)",
            RuntimeWarning, stacklevel=3)
        return replace(config, local_bits=b, inner_size=m,
                       pipeline_depth=depth,
                       ram_budget_bytes=ram_budget), True, part

    min_stages = min(c[0] for c in feasible)
    best = [c for c in feasible if c[0] == min_stages]
    if len(best) > 1 and not circuit.free_parameters \
            and not circuit.is_stochastic:
        # transpose tie-break needs concrete matrices; cap the candidates
        # so plan time stays trivial next to a single stage's compute
        best = sorted(best, key=lambda c: -c[1])[:6]
        best = [min(best, key=lambda c: (
            _transpose_cost(circuit, c[1], c[2], c[5],
                            config.max_fused_qubits), -c[1], c[2]))]
    _, b, m, depth, _, part = max(best, key=lambda c: (c[1], -c[2]))
    return replace(config, local_bits=b, inner_size=m, pipeline_depth=depth,
                   ram_budget_bytes=ram_budget), True, part


def fuse_stage(layout: GroupLayout, gates, max_fused: int,
               params: dict | None = None):
    """Fuse one stage's gates and remap onto the group's virtual bits.

    Returns ``(vgates, plan)``: the fused unitaries (matrices bound with
    ``params`` where parameterized) and the structural
    ``((vqubits, is_diagonal), ...)`` tuple that keys every downstream
    cache (stage fns, schedules, plans).
    """
    concrete = [g.bind(params) if g.is_parameterized else g for g in gates]
    fused = fuse_gates(concrete, max_fused)
    vgates = [FusedGate(layout.remap_qubits(fg.qubits), fg.matrix)
              for fg in fused]
    plan = tuple((fg.qubits, fg.is_diagonal) for fg in vgates)
    return vgates, plan


def fuse_stage_lanes(layout: GroupLayout, gates, max_fused: int, bindings,
                     rngs):
    """Fuse one stage for every lane of a batch -> shared structural plan.

    Args:
        bindings: per lane, the parameter dict (or None).
        rngs: per lane, the trajectory rng realizing stochastic channels
            (or None for a lane of a deterministic circuit); each lane's
            rng is threaded through the stages in circuit order, so one
            seed yields one consistent whole-circuit realization.

    Returns ``(lane_vgates, plan)``: the per-lane fused unitaries and the
    ONE structural plan they all execute under.  Fusion depends only on
    gate supports — identical across lanes by construction — while
    ``is_diagonal`` depends on matrix values (an rx(0) lane fuses to a
    diagonal identity; a trajectory's sampled X does not), so a fused
    gate is marked diagonal iff EVERY lane's realization is: a dense op
    applies any unitary correctly, a diagonal op only diagonal ones.
    """
    lane_vgates, lane_plans = [], []
    for params, rng in zip(bindings, rngs):
        concrete = [g.realize(rng) if g.is_stochastic else g for g in gates]
        vg, plan = fuse_stage(layout, concrete, max_fused, params)
        lane_vgates.append(vg)
        lane_plans.append(plan)
    base = lane_plans[0]
    for plan in lane_plans[1:]:
        if len(plan) != len(base) or \
                any(a[0] != b[0] for a, b in zip(plan, base)):
            raise RuntimeError(
                "batch lanes fused to different stage structures "
                "(fusion must depend on gate supports only)")
    merged = tuple(
        (vq, all(plan[i][1] for plan in lane_plans))
        for i, (vq, _) in enumerate(base))
    return lane_vgates, merged


def assemble_plan(circuit_fp: str, cfg, partition, stage_plans,
                  *, n_devices: int, interpret: bool, params_key: tuple,
                  auto_tuned: bool) -> ExecutionPlan:
    """Freeze a bound engine state into an :class:`ExecutionPlan`.

    ``stage_plans`` is ``[(layout, plan_tuple), ...]`` per partition
    stage (the engine's bound records minus the operand matrices — those
    belong to a binding, not the plan).
    """
    n, b = partition.n_qubits, partition.local_bits
    bpa = estimate_bytes_per_amp(cfg.b_r, cfg.compression)
    wire = wire_bytes_per_block(1 << b, cfg.codec_backend, cfg.compression)
    stages = []
    gate_lo = 0
    tot_t = tot_tn = tot_boundary = 0
    max_m = 0
    for idx, ((layout, plan), st) in enumerate(
            zip(stage_plans, partition.stages)):
        nv = layout.b + layout.m
        max_m = max(max_m, layout.m)
        if plan:
            sched = compile_schedule(plan, nv)
            n_t, n_tn = sched.n_transposes, sched.n_transposes_naive
        else:
            n_t = n_tn = 0
        stage_bytes = (wire * layout.n_groups * layout.blocks_per_group
                       * max(1, cfg.batch))
        key = (plan, nv, cfg.use_kernel, cfg.gate_schedule, interpret)
        stages.append(StagePlan(
            index=idx, layout=layout,
            gate_slice=(gate_lo, gate_lo + len(st.gates)), plan=plan,
            stagefn_key=key, n_devices=n_devices,
            n_transposes=n_t, n_transposes_naive=n_tn,
            est_h2d_bytes=stage_bytes, est_d2h_bytes=stage_bytes))
        gate_lo += len(st.gates)
        tot_t += n_t * layout.n_groups
        tot_tn += n_tn * layout.n_groups
        tot_boundary += 2 * stage_bytes
    # peak_ram/pipeline stay mesh-wide (n_devices=1 form) — the quantity
    # older dumps and the memory benchmarks report; the busiest device's
    # share is the budget-facing per_device_peak_bytes
    peak_ram, pipeline = _predict_working_set(
        n, b, max_m, cfg.pipeline_depth, bpa, cfg.batch)
    dev_peak, dev_pipe = _predict_working_set(
        n, b, max_m, cfg.pipeline_depth, bpa, cfg.batch, n_devices)
    predicted = PlanPredictions(
        bytes_per_amp=bpa,
        state_bytes=int((1 << n) * bpa) + (1 << (n - b)) * _BLOCK_OVERHEAD,
        peak_ram_bytes=peak_ram, pipeline_bytes=pipeline,
        boundary_bytes=tot_boundary,
        n_transposes=tot_t, n_transposes_naive=tot_tn,
        depth_speedup=predict_depth_speedup(cfg.pipeline_depth),
        per_device_peak_bytes=dev_peak + dev_pipe)
    return ExecutionPlan(
        circuit_fp=circuit_fp, n_qubits=n, local_bits=b,
        inner_size=cfg.inner_size, pipeline_depth=cfg.pipeline_depth,
        b_r=cfg.b_r, compression=cfg.compression, prescan=cfg.prescan,
        codec_backend=cfg.codec_backend, use_kernel=cfg.use_kernel,
        gate_schedule=cfg.gate_schedule,
        max_fused_qubits=cfg.max_fused_qubits, interpret=interpret,
        n_devices=n_devices, memory_budget_bytes=cfg.memory_budget_bytes,
        auto_tuned=auto_tuned, params_key=params_key,
        stages=tuple(stages), predicted=predicted, batch=cfg.batch)
