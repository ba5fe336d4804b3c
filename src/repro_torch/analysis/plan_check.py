"""ExecutionPlan verifier: prove a plan is safe to execute verbatim.

The engine executes an :class:`~repro_torch.core.plan.ExecutionPlan` without
re-deriving anything — stage layouts, gate slices, compiled schedules
and byte predictions are trusted as written.  The plan's
:attr:`~repro_torch.core.plan.ExecutionPlan.fingerprint` deliberately covers
only the *state-layout* half (inner sets + slice lengths), so a plan
whose ``gate_slice`` was shifted, whose ``GroupLayout`` chain disagrees
with the plan-level knobs, or whose predictions were tampered with is
fingerprint-identical to a good one.  This module closes that gap with
a pure structural pass:

* **layout flow** — every stage's :class:`GroupLayout` chains to the
  plan-level ``(n_qubits, local_bits)``, its inner set is sorted,
  in-range and within the partition threshold;
* **gate tiling** — the stage ``gate_slice`` ranges tile ``[0, n_gates)``
  contiguously with no gaps or overlaps, and (when the circuit is at
  hand) each slice's global support equals the stage's inner set;
* **schedule replay** — each stage's compiled permutation plan is
  replayed: every ``TransposeOp.perm`` is a true permutation, the
  composition returns the group tensor to the canonical layout, and the
  recorded transpose counts match the schedule's;
* **byte self-consistency** — every byte prediction is recomputed from
  the planner's own cost model and compared exactly; a predicted
  working set above ``memory_budget_bytes`` is surfaced as a *warning*
  (the store's spill tier is the documented backstop, and the planner
  already warns when it plans over budget).

Wired in as the default ``Simulator.compile(verify=True)`` and the
plan-only ``qsim --verify`` (zero stages executed, like ``--explain``).

:func:`verify_plan` returns findings; :func:`check_plan` raises
:class:`~repro_torch.errors.PlanVerificationError` on any error-severity
finding.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from ..core.plan import ExecutionPlan, circuit_fingerprint
from ..core.planner import (
    _BLOCK_OVERHEAD,
    _predict_working_set,
    estimate_bytes_per_amp,
    predict_depth_speedup,
    wire_bytes_per_block,
)
from ..core.schedule import TransposeOp, compile_schedule
from ..errors import PlanVerificationError

__all__ = ["PlanFinding", "verify_plan", "check_plan"]


@dataclass(frozen=True)
class PlanFinding:
    """One verifier finding.

    Attributes:
        severity: ``"error"`` (plan must not execute) or ``"warning"``
            (suspicious but executable — e.g. over-budget working set,
            which the spill tier absorbs by design).
        code: stable machine-readable identifier (``gate-tiling``,
            ``layout-chain``, ``schedule-replay``, ``predictions``, ...).
        message: human-readable description.
        stage: stage index the finding is anchored to, or None for
            whole-plan findings.
    """

    severity: str
    code: str
    message: str
    stage: int | None = None

    def render(self) -> str:
        where = f"stage {self.stage}: " if self.stage is not None else ""
        return f"[{self.severity}] {self.code}: {where}{self.message}"


def _isclose(a: float, b: float) -> bool:
    # predictions round-trip JSON exactly (IEEE doubles), so the
    # tolerance only needs to absorb float re-derivation, not drift
    return math.isclose(a, b, rel_tol=1e-9, abs_tol=1e-12)


def _check_knobs(plan: ExecutionPlan, err) -> bool:
    """Plan-level knob sanity; False means layout math below is bogus."""
    n, b = plan.n_qubits, plan.local_bits
    if not 0 <= b <= n:
        err("knobs", f"local_bits={b} out of range for n_qubits={n}")
        return False
    if plan.inner_size < 1:
        err("knobs", f"inner_size={plan.inner_size} must be >= 1")
    if plan.pipeline_depth < 1:
        err("knobs", f"pipeline_depth={plan.pipeline_depth} must be >= 1")
    if plan.b_r <= 0:
        err("knobs", f"b_r={plan.b_r} must be > 0")
    if plan.n_devices < 1:
        err("knobs", f"n_devices={plan.n_devices} must be >= 1")
    if plan.batch < 1:
        err("knobs", f"batch={plan.batch} must be >= 1")
    return True


def _check_layout(plan: ExecutionPlan, sp, i: int, thr: int, err) -> None:
    """Layout chain: every stage must agree with the plan-level state
    layout — the fingerprint only covers the inner set, so a layout
    rebuilt with the wrong (n_qubits, local_bits) is invisible to it."""
    n, b = plan.n_qubits, plan.local_bits
    lay = sp.layout
    if lay.n_qubits != n:
        msg = f"layout.n_qubits={lay.n_qubits} != plan n_qubits={n}"
        err("layout-chain", msg, i)
    if lay.local_bits != b:
        msg = f"layout.local_bits={lay.local_bits} != plan local_bits={b}"
        err("layout-chain", msg, i)
    inner = lay.inner
    if list(inner) != sorted(set(inner)):
        err("layout-chain", f"inner set {inner} is not strictly increasing", i)
    bad = [q for q in inner if not b <= q < n]
    if bad:
        msg = f"inner qubits {bad} outside global range [{b}, {n})"
        err("layout-chain", msg, i)
    if lay.m > thr:
        msg = f"stage has {lay.m} inner qubits > partition threshold {thr}"
        err("layout-chain", msg, i)


def _check_schedule(sp, nv: int, i: int, err) -> None:
    """Schedule replay: recompile the stage schedule and replay its
    permutation plan — it must compose back to the identity layout."""
    if not sp.plan:
        if sp.n_transposes or sp.n_transposes_naive:
            err("schedule-replay", "empty fused plan but nonzero transpose counts", i)
        return
    sched = compile_schedule(sp.plan, nv)
    ident = tuple(range(nv))
    cur = ident
    n_t = 0
    valid = True
    for op in sched.ops:
        if not isinstance(op, TransposeOp):
            continue
        n_t += 1
        if sorted(op.perm) != list(ident):
            msg = f"transpose perm {op.perm} is not a permutation of {nv} axes"
            err("schedule-replay", msg, i)
            valid = False
            break
        cur = tuple(cur[p] for p in op.perm)
    if valid:
        if cur != ident:
            msg = (
                f"transpose chain composes to {cur}, not identity — "
                f"the stage would emit a permuted state"
            )
            err("schedule-replay", msg, i)
        if n_t != sched.n_transposes:
            msg = (
                f"schedule op list has {n_t} transposes but records "
                f"n_transposes={sched.n_transposes}"
            )
            err("schedule-replay", msg, i)
    if sp.n_transposes != sched.n_transposes:
        msg = (
            f"stage records {sp.n_transposes} transposes, "
            f"compiled schedule has {sched.n_transposes}"
        )
        err("schedule-replay", msg, i)
    if sp.n_transposes_naive != sched.n_transposes_naive:
        msg = (
            f"stage records {sp.n_transposes_naive} naive transposes, "
            f"schedule has {sched.n_transposes_naive}"
        )
        err("schedule-replay", msg, i)


def _check_circuit(plan: ExecutionPlan, circuit, gate_hi: int, err) -> None:
    """Gate tiling against the circuit itself (fingerprint, length and
    per-stage global support) — the checks a deserialized plan alone
    cannot do."""
    n, b = plan.n_qubits, plan.local_bits
    if circuit.n_qubits != n:
        msg = f"circuit has {circuit.n_qubits} qubits, plan has {n}"
        err("gate-tiling", msg)
    fp = circuit_fingerprint(circuit)
    if fp != plan.circuit_fp:
        msg = (
            f"circuit fingerprint {fp[:12]} != plan circuit_fp "
            f"{plan.circuit_fp[:12]}"
        )
        err("gate-tiling", msg)
    n_gates = len(circuit.gates)
    if gate_hi != n_gates:
        msg = (
            f"stage slices cover [0, {gate_hi}) but the circuit "
            f"has {n_gates} gates"
        )
        err("gate-tiling", msg)
    for sp in plan.stages:
        lo, hi = sp.gate_slice
        sup = {q for g in circuit.gates[lo:hi] for q in g.qubits if q >= b}
        if sup != set(sp.layout.inner):
            msg = (
                f"gates[{lo}:{hi}] global support {sorted(sup)} != "
                f"stage inner set {list(sp.layout.inner)}"
            )
            err("gate-tiling", msg, sp.index)


def verify_plan(plan: ExecutionPlan, circuit=None) -> list[PlanFinding]:
    """Run every check; returns all findings (empty list = clean).

    ``circuit`` is optional: with it, the gate slices are additionally
    checked against the circuit's length, fingerprint and per-stage
    global support (the checks a deserialized plan alone cannot do).
    """
    out: list[PlanFinding] = []

    def err(code, msg, stage=None):
        out.append(PlanFinding("error", code, msg, stage))

    def warn(code, msg, stage=None):
        out.append(PlanFinding("warning", code, msg, stage))

    n, b = plan.n_qubits, plan.local_bits
    if not _check_knobs(plan, err):
        return out

    # partition's effective threshold (see partition_circuit): the
    # requested inner_size is clamped to at least 2 (two-qubit gates)
    # and to the number of global bits
    thr = max(plan.inner_size, 2)
    if thr > n - b:
        thr = max(n - b, 0)

    # -- per-stage structure -------------------------------------------------
    gate_hi = 0
    tot_t = tot_tn = tot_boundary = 0
    max_m = 0
    wire = wire_bytes_per_block(1 << b, plan.codec_backend, plan.compression)
    for i, sp in enumerate(plan.stages):
        if sp.index != i:
            err("stage-index", f"recorded index {sp.index} != position {i}", i)
        _check_layout(plan, sp, i, thr, err)
        max_m = max(max_m, sp.layout.m)
        if sp.n_devices != plan.n_devices:
            msg = f"stage n_devices={sp.n_devices} != plan n_devices={plan.n_devices}"
            err("placement", msg, i)
        else:
            # placement replay: every group must land on a real mesh slot
            # (the engine trusts device_slot verbatim for its group ->
            # device map and the exchange ledger).  Bounded: the slot
            # assignment is periodic in n_devices, so the first 64k
            # groups witness every residue class many times over.
            for g in range(min(sp.layout.n_groups, 1 << 16)):
                slot = sp.device_slot(g)
                if not 0 <= slot < plan.n_devices:
                    msg = (
                        f"group {g} maps to device slot {slot}, outside "
                        f"mesh [0, {plan.n_devices})"
                    )
                    err("placement", msg, i)
                    break

        # gate tiling: slices must cover the circuit contiguously —
        # a shifted slice of equal length passes the fingerprint but
        # would apply the wrong gates to the wrong stage layout
        lo, hi = sp.gate_slice
        if lo > hi:
            err("gate-tiling", f"gate_slice ({lo}, {hi}) is reversed", i)
        elif lo != gate_hi:
            msg = (
                f"gate_slice starts at {lo}, expected {gate_hi} "
                f"(gap or overlap with previous stage)"
            )
            err("gate-tiling", msg, i)
        gate_hi = max(gate_hi, hi)

        # fused plan: virtual qubits must be unique and inside the group
        nv = sp.layout.b + sp.layout.m
        for gi, (vq, _diag) in enumerate(sp.plan):
            if len(set(vq)) != len(vq) or any(not 0 <= q < nv for q in vq):
                msg = f"fused gate {gi} vqubits {vq} invalid for nv={nv}"
                err("fused-plan", msg, i)

        # stage-fn key: the engine compiles (or reuses) exactly this key;
        # a stale key silently runs the wrong jitted function
        key = (sp.plan, nv, plan.use_kernel, plan.gate_schedule, plan.interpret)
        if sp.stagefn_key != key:
            msg = f"stagefn_key {sp.stagefn_key!r} != expected {key!r}"
            err("stagefn-key", msg, i)

        _check_schedule(sp, nv, i, err)

        # per-stage boundary traffic from the planner's wire model
        lay = sp.layout
        stage_bytes = wire * lay.n_groups * lay.blocks_per_group * max(1, plan.batch)
        if sp.est_h2d_bytes != stage_bytes:
            msg = f"est_h2d_bytes={sp.est_h2d_bytes} != wire model {stage_bytes}"
            err("predictions", msg, i)
        if sp.est_d2h_bytes != stage_bytes:
            msg = f"est_d2h_bytes={sp.est_d2h_bytes} != wire model {stage_bytes}"
            err("predictions", msg, i)
        tot_boundary += 2 * stage_bytes
        tot_t += sp.n_transposes * lay.n_groups
        tot_tn += sp.n_transposes_naive * lay.n_groups

    if circuit is not None:
        _check_circuit(plan, circuit, gate_hi, err)

    # -- whole-plan predictions ---------------------------------------------
    p = plan.predicted
    bpa = estimate_bytes_per_amp(plan.b_r, plan.compression)
    if not _isclose(p.bytes_per_amp, bpa):
        err("predictions", f"bytes_per_amp={p.bytes_per_amp} != cost model {bpa}")
    state_bytes = int((1 << n) * bpa) + (1 << (n - b)) * _BLOCK_OVERHEAD
    if p.state_bytes != state_bytes:
        msg = f"state_bytes={p.state_bytes} != cost model {state_bytes}"
        err("predictions", msg)
    peak_ram, pipeline = _predict_working_set(
        n, b, max_m, plan.pipeline_depth, bpa, max(1, plan.batch)
    )
    if p.peak_ram_bytes != peak_ram:
        msg = f"peak_ram_bytes={p.peak_ram_bytes} != cost model {peak_ram}"
        err("predictions", msg)
    if p.pipeline_bytes != pipeline:
        msg = f"pipeline_bytes={p.pipeline_bytes} != cost model {pipeline}"
        err("predictions", msg)
    if p.boundary_bytes != tot_boundary:
        msg = f"boundary_bytes={p.boundary_bytes} != sum of stage traffic {tot_boundary}"
        err("predictions", msg)
    if p.n_transposes != tot_t:
        msg = f"n_transposes={p.n_transposes} != group-weighted stage total {tot_t}"
        err("predictions", msg)
    if p.n_transposes_naive != tot_tn:
        msg = (
            f"n_transposes_naive={p.n_transposes_naive} != "
            f"group-weighted stage total {tot_tn}"
        )
        err("predictions", msg)
    speedup = predict_depth_speedup(plan.pipeline_depth)
    if not _isclose(p.depth_speedup, speedup):
        msg = f"depth_speedup={p.depth_speedup} != overlap model {speedup}"
        err("predictions", msg)
    dev_peak, dev_pipe = _predict_working_set(
        n, b, max_m, plan.pipeline_depth, bpa, max(1, plan.batch), plan.n_devices
    )
    if p.per_device_peak_bytes != dev_peak + dev_pipe:
        msg = (
            f"per_device_peak_bytes={p.per_device_peak_bytes} != "
            f"cost model {dev_peak + dev_pipe} for {plan.n_devices} device(s)"
        )
        err("predictions", msg)

    # over-budget is a warning: the planner documents planning the
    # smallest candidate over budget and relying on the disk spill tier.
    # The budget is per device — the busiest device's predicted share is
    # what must fit (identical to the whole working set at n_devices=1)
    budget = plan.memory_budget_bytes
    if budget is not None and p.per_device_peak_bytes > budget:
        msg = (
            f"predicted per-device peak {p.per_device_peak_bytes} B exceeds "
            f"the per-device memory budget {budget} B — the run will lean "
            f"on the disk spill tier"
        )
        warn("budget", msg)
    # ragged lane shards are legal but cost one extra jit specialization
    # per distinct shard width — surface the split explicitly
    if plan.batch > 1 and plan.n_devices > 1 and plan.batch % plan.n_devices:
        msg = (
            f"batch={plan.batch} does not divide over {plan.n_devices} "
            f"devices — lane shards are ragged "
            f"({plan.batch % plan.n_devices} device(s) carry an extra lane)"
        )
        warn("placement", msg)
    return out


def check_plan(plan: ExecutionPlan, circuit=None) -> list[PlanFinding]:
    """:func:`verify_plan`, raising on errors.

    Returns the (possibly warning-bearing) findings when the plan is
    executable; raises :class:`PlanVerificationError` carrying every
    finding when any error-severity finding exists.
    """
    findings = verify_plan(plan, circuit)
    errors = [f for f in findings if f.severity == "error"]
    if errors:
        head = "; ".join(f.render() for f in errors[:3])
        more = f" (+{len(errors) - 3} more)" if len(errors) > 3 else ""
        raise PlanVerificationError(
            f"ExecutionPlan failed verification: {head}{more}", findings
        )
    return findings
