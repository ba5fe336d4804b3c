"""ExecutionPlan: the ahead-of-time compilation artifact of a simulation.

The paper's fourth challenge — unpredictable memory requirements under
variable-ratio compression — used to be handled only *reactively* (the
two-level store spills after the fact), and everything the engine decided
per run (partition, per-stage schedules, stage-fn keys, device placement)
was rebuilt inside ``run()``.  This module makes planning a first-class
phase: an :class:`ExecutionPlan` is the inspectable, hashable,
serializable record of every compile-time decision, produced by
:mod:`repro_torch.core.planner` (which also *chooses* the knobs under a memory
budget) and executed verbatim by :class:`~repro_torch.core.engine.BMQSimEngine`.

Per stage, a :class:`StagePlan` freezes:

* the :class:`~repro_torch.core.groups.GroupLayout` (inner set, group table),
* the fused-gate plan ``((vqubits, is_diagonal), ...)`` — the structural
  tuple the engine keys its jitted stage functions on,
* the precompiled transpose-minimizing :class:`StageSchedule` counts,
* the stage-fn cache key (so a warm process compiles nothing at run time),
* the operand slots (``gate_slice`` into the circuit's gate list) that a
  parameter binding fills with concrete matrices, and
* the round-robin device placement of its groups.

Whole-plan :class:`PlanPredictions` estimate the peak compressed working
set, per-stage boundary traffic and transpose counts before anything
executes; ``plan.describe()`` renders the whole artifact (the
``qsim --explain`` output).

The plan's :attr:`~ExecutionPlan.fingerprint` covers exactly the
*state-layout* decisions — circuit structure, ``(local_bits, inner_size)``,
codec parameters, and the stage partition — the things that must match for
a checkpointed compressed state to be continuable.  It is stamped into
every checkpoint manifest; :meth:`Simulator.resume` rejects mismatches.
Execution-only knobs (backend, kernels, pipeline depth, devices) do not
affect the fingerprint.
"""
from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass

from .groups import GroupLayout

__all__ = ["StagePlan", "PlanPredictions", "ExecutionPlan",
           "circuit_fingerprint", "plan_fingerprint"]


def circuit_fingerprint(circuit) -> str:
    """Structural hash of a circuit template (gate names, qubits, params —
    :class:`Parameter` placeholders hash by name, so one template yields
    one fingerprint across bindings)."""
    h = hashlib.sha1()
    h.update(str(circuit.n_qubits).encode())
    for g in circuit.gates:
        h.update(g.name.encode())
        h.update(repr(g.qubits).encode())
        h.update(repr(g.params).encode())
    return h.hexdigest()


def plan_fingerprint(circuit_fp: str, n_qubits: int, local_bits: int,
                     inner_size: int, b_r: float, compression: bool,
                     prescan: bool,
                     stage_shape: list[tuple[tuple[int, ...], int]]) -> str:
    """Fingerprint of the state-layout half of a plan.

    ``stage_shape`` is ``[(inner set, n_gates), ...]`` per stage.  The
    same function serves :attr:`ExecutionPlan.fingerprint` and the
    engine's binding-free ``plan_fingerprint()`` (checkpoint manifests),
    so the two can never drift apart.
    """
    h = hashlib.sha1()
    h.update(circuit_fp.encode())
    h.update(repr((n_qubits, local_bits, inner_size, float(b_r),
                   bool(compression), bool(prescan))).encode())
    for inner, n_gates in stage_shape:
        h.update(repr((tuple(inner), int(n_gates))).encode())
    return h.hexdigest()


@dataclass(frozen=True)
class StagePlan:
    """One stage's frozen compile-time record (see module docs).

    ``gate_slice`` is the stage's operand slot range into
    ``circuit.gates`` — the partition assigns contiguous runs, and a
    parameter binding fills exactly these slots with concrete matrices.
    ``stagefn_key`` is the full cache key of the jitted stage function
    (structure + execution flags); two stages with equal keys share one
    compilation.  Group ``g`` executes on device ``g % n_devices``
    (:meth:`device_slot`).
    """

    index: int
    layout: GroupLayout
    gate_slice: tuple[int, int]
    plan: tuple                      # ((vqubits, is_diagonal), ...) fused
    stagefn_key: tuple
    n_devices: int
    n_transposes: int                # per group, compiled schedule
    n_transposes_naive: int          # per group, per-gate path
    est_h2d_bytes: int               # predicted boundary traffic, whole stage
    est_d2h_bytes: int

    @property
    def nv(self) -> int:
        return self.layout.b + self.layout.m

    @property
    def n_groups(self) -> int:
        return self.layout.n_groups

    @property
    def n_fused(self) -> int:
        return len(self.plan)

    def device_slot(self, group: int) -> int:
        """Round-robin placement: group ``g`` runs on this device index."""
        return group % self.n_devices


@dataclass(frozen=True)
class PlanPredictions:
    """Whole-plan cost-model outputs (estimates, not measurements).

    ``bytes_per_amp`` is the estimated *stored* compressed size; the
    engine calibrates it against the first encoded stage at run time
    (``SimStats.bytes_per_amp_measured``), with the two-level store's RAM
    budget as the backstop when the estimate was optimistic.
    ``peak_ram_bytes`` predicts the store's primary-tier peak;
    ``pipeline_bytes`` the host-side staging working set on top of it.
    """

    bytes_per_amp: float
    state_bytes: int
    peak_ram_bytes: int
    pipeline_bytes: int
    boundary_bytes: int              # total h2d + d2h across stages
    n_transposes: int                # group-weighted, compiled schedules
    n_transposes_naive: int
    #: predicted whole-run speedup of the plan's pipeline_depth over the
    #: strictly sequential depth-1 schedule (the planner's overlap model,
    #: :func:`repro_torch.core.planner.predict_depth_speedup`); 1.0 at depth 1
    depth_speedup: float = 1.0
    #: predicted working set of the BUSIEST device of the mesh (store
    #: peak + staging for its share of lanes/blocks).  The budget-facing
    #: quantity of a sharded plan — ``memory_budget_bytes`` is per
    #: device, and chunking engages only when this (not the mesh-wide
    #: total) overflows it.  Equals ``working_set_bytes`` at n_devices=1;
    #: 0 only in pre-v9 plan dumps (from_json backfills it).
    per_device_peak_bytes: int = 0

    @property
    def working_set_bytes(self) -> int:
        """Budget-facing total: store peak + pipeline staging."""
        return self.peak_ram_bytes + self.pipeline_bytes


@dataclass(frozen=True)
class ExecutionPlan:
    """The full ahead-of-time compilation artifact (see module docs)."""

    circuit_fp: str
    n_qubits: int
    local_bits: int
    inner_size: int
    pipeline_depth: int
    b_r: float
    compression: bool
    prescan: bool
    codec_backend: str
    use_kernel: bool
    gate_schedule: bool
    max_fused_qubits: int
    interpret: bool
    n_devices: int
    memory_budget_bytes: int | None
    auto_tuned: bool
    params_key: tuple
    stages: tuple[StagePlan, ...]
    predicted: PlanPredictions
    #: batch factor K the plan was provisioned for: predictions (peak
    #: working set, boundary traffic) assume K lanes flow through every
    #: stage together (Simulator.run_batch / noise trajectories); does
    #: not affect the state-layout fingerprint — each lane's blocks are
    #: laid out exactly like a single-lane run's
    batch: int = 1

    @property
    def n_stages(self) -> int:
        return len(self.stages)

    @property
    def fingerprint(self) -> str:
        """State-layout fingerprint (stamped into checkpoint manifests)."""
        return plan_fingerprint(
            self.circuit_fp, self.n_qubits, self.local_bits,
            self.inner_size, self.b_r, self.compression, self.prescan,
            [(sp.layout.inner, sp.gate_slice[1] - sp.gate_slice[0])
             for sp in self.stages])

    # -- rendering -------------------------------------------------------------
    def describe(self, max_stages: int = 24) -> str:
        """Human-readable rendering (the ``qsim --explain`` output)."""
        p = self.predicted
        mib = 2.0 ** 20
        lines = [
            f"ExecutionPlan  n={self.n_qubits}  fingerprint "
            f"{self.fingerprint[:12]}",
            f"  knobs     : local_bits={self.local_bits}"
            f"{' (auto)' if self.auto_tuned else ''} "
            f"inner_size={self.inner_size} "
            f"pipeline_depth={self.pipeline_depth} b_r={self.b_r:g} "
            f"max_fused={self.max_fused_qubits}"
            + (f" batch={self.batch}" if self.batch > 1 else ""),
            f"  codec     : backend={self.codec_backend} "
            f"compression={'on' if self.compression else 'off'} "
            f"prescan={'on' if self.prescan else 'off'}",
            f"  execution : use_kernel={self.use_kernel} "
            f"gate_schedule={self.gate_schedule} "
            f"devices={self.n_devices} (groups round-robin)",
            "  budget    : "
            + (f"{self.memory_budget_bytes / mib:.1f} MiB"
               if self.memory_budget_bytes else "none"),
            f"  predicted : stored {p.bytes_per_amp:.2f} B/amp "
            f"(state {p.state_bytes / mib:.2f} MiB); "
            f"peak RAM {p.peak_ram_bytes / mib:.2f} MiB "
            f"+ pipeline {p.pipeline_bytes / mib:.2f} MiB",
            f"  predicted : boundary {p.boundary_bytes / mib:.2f} MiB "
            f"over {self.n_stages} stages; group transposes "
            f"{p.n_transposes} scheduled vs {p.n_transposes_naive} per-gate",
            f"  predicted : pipeline depth {self.pipeline_depth} overlap "
            f"speedup {p.depth_speedup:.2f}x vs sequential",
        ]
        if self.n_devices > 1:
            lines.insert(6, (
                f"  predicted : per-device peak "
                f"{p.per_device_peak_bytes / mib:.2f} MiB across "
                f"{self.n_devices} devices (budget is per device)"))
        for sp in self.stages[:max_stages]:
            lo, hi = sp.gate_slice
            inner = ",".join(map(str, sp.layout.inner)) or "-"
            lines.append(
                f"  stage {sp.index:3d}: inner={{{inner}}} "
                f"{sp.n_groups} groups x {sp.layout.blocks_per_group} blk "
                f"(nv={sp.nv})  gates[{lo}:{hi}] -> {sp.n_fused} fused, "
                f"{sp.n_transposes} transposes, "
                f"h2d {sp.est_h2d_bytes / mib:.2f} MiB")
        if self.n_stages > max_stages:
            lines.append(f"  ... {self.n_stages - max_stages} more stages")
        return "\n".join(lines)

    # -- serialization ---------------------------------------------------------
    def to_json(self) -> str:
        d = {
            "kind": "bmqsim-execution-plan", "version": 1,
            "circuit_fp": self.circuit_fp, "n_qubits": self.n_qubits,
            "local_bits": self.local_bits, "inner_size": self.inner_size,
            "pipeline_depth": self.pipeline_depth, "b_r": self.b_r,
            "compression": self.compression, "prescan": self.prescan,
            "codec_backend": self.codec_backend,
            "use_kernel": self.use_kernel,
            "gate_schedule": self.gate_schedule,
            "max_fused_qubits": self.max_fused_qubits,
            "interpret": self.interpret,
            "n_devices": self.n_devices,
            "memory_budget_bytes": self.memory_budget_bytes,
            "auto_tuned": self.auto_tuned,
            "batch": self.batch,
            "params_key": list(list(kv) for kv in self.params_key),
            "predicted": {
                "bytes_per_amp": self.predicted.bytes_per_amp,
                "state_bytes": self.predicted.state_bytes,
                "peak_ram_bytes": self.predicted.peak_ram_bytes,
                "pipeline_bytes": self.predicted.pipeline_bytes,
                "boundary_bytes": self.predicted.boundary_bytes,
                "n_transposes": self.predicted.n_transposes,
                "n_transposes_naive": self.predicted.n_transposes_naive,
                "depth_speedup": self.predicted.depth_speedup,
                "per_device_peak_bytes":
                    self.predicted.per_device_peak_bytes,
            },
            "stages": [{
                "index": sp.index,
                "inner": list(sp.layout.inner),
                "gate_slice": list(sp.gate_slice),
                "plan": [[list(vq), diag] for vq, diag in sp.plan],
                "n_transposes": sp.n_transposes,
                "n_transposes_naive": sp.n_transposes_naive,
                "est_h2d_bytes": sp.est_h2d_bytes,
                "est_d2h_bytes": sp.est_d2h_bytes,
            } for sp in self.stages],
        }
        return json.dumps(d, sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "ExecutionPlan":
        d = json.loads(s)
        if d.get("kind") != "bmqsim-execution-plan":
            raise ValueError("not a serialized ExecutionPlan")
        n, b = d["n_qubits"], d["local_bits"]
        stages: list[StagePlan] = []
        for sd in d["stages"]:
            plan = tuple((tuple(vq), bool(diag)) for vq, diag in sd["plan"])
            layout = GroupLayout(n, b, tuple(sd["inner"]))
            key = (plan, layout.b + layout.m, d["use_kernel"],
                   d["gate_schedule"], d["interpret"])
            stages.append(StagePlan(
                index=sd["index"], layout=layout,
                gate_slice=tuple(sd["gate_slice"]), plan=plan,
                stagefn_key=key, n_devices=d["n_devices"],
                n_transposes=sd["n_transposes"],
                n_transposes_naive=sd["n_transposes_naive"],
                est_h2d_bytes=sd["est_h2d_bytes"],
                est_d2h_bytes=sd["est_d2h_bytes"]))
        pd = dict(d["predicted"])
        pd.setdefault("depth_speedup", 1.0)   # pre-v6 plan dumps
        # pre-v9 dumps predate sharded placement: one device held it all
        pd.setdefault("per_device_peak_bytes",
                      pd["peak_ram_bytes"] + pd["pipeline_bytes"])
        return cls(
            circuit_fp=d["circuit_fp"], n_qubits=n, local_bits=b,
            inner_size=d["inner_size"], pipeline_depth=d["pipeline_depth"],
            b_r=d["b_r"], compression=d["compression"],
            prescan=d["prescan"], codec_backend=d["codec_backend"],
            use_kernel=d["use_kernel"], gate_schedule=d["gate_schedule"],
            max_fused_qubits=d["max_fused_qubits"],
            interpret=d["interpret"], n_devices=d["n_devices"],
            memory_budget_bytes=d["memory_budget_bytes"],
            auto_tuned=d["auto_tuned"], batch=d.get("batch", 1),
            params_key=tuple(tuple(kv) for kv in d["params_key"]),
            stages=tuple(stages), predicted=PlanPredictions(**pd))
