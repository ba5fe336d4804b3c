"""Pressure monitor: graceful degradation when compression underdelivers.

The planner predicts the compressed state's ``bytes_per_amp`` from an
entropy model of ``b_r`` (:func:`repro_torch.core.planner.estimate_bytes_per_amp`)
— but the achieved ratio is data-dependent (§4.4: QFT/GHZ compress
~130x, QAOA/RCS barely 2x), and a run whose state is incompressible will
blow straight past the plan's working-set budget.  Rather than thrash or
die, the engine checks this monitor at every stage boundary and walks a
degradation ladder while measured ``bytes_per_amp`` exceeds
``headroom ×`` the prediction:

    rung 1  ``shrink_window``  — pipeline in-flight window -> 1
                                 (halves the staged-wave working set)
    rung 2  ``wave_depth_1``   — pipeline wave depth -> 1 (one group's
                                 planes in flight at a time)
    rung 3  ``proactive_spill``— push RAM-tier blobs to disk down to
                                 half the budget (or half current use)
    rung 4  ``abort``          — the disk tier itself overflowed its
                                 budget: raise a typed
                                 :class:`~repro_torch.errors.MemoryPressureError`
                                 at the stage boundary (the simulator
                                 flushes an emergency checkpoint and
                                 re-raises with the resume path)

Rungs 1–3 degrade throughput, never correctness (the store's spill
backstop still guarantees ``peak_ram <= budget``); rung 4 only fires
when ``disk_budget_bytes`` is set and exhausted — an incompressible but
spillable run degrades and completes.  Every rung taken is recorded in
``SimStats.pressure_rungs`` (and counted in ``n_pressure_events``), and
``qsim --explain`` prints the armed ladder.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from ..errors import MemoryPressureError

__all__ = ["PressureMonitor", "RUNGS"]

#: ladder order; "abort" is the terminal disk-overflow rung
RUNGS = ("shrink_window", "wave_depth_1", "proactive_spill")


@dataclass
class PressureMonitor:
    """Stage-boundary memory-pressure watchdog (one per engine run).

    Args:
        predicted_bpa: the planner's bytes-per-amplitude estimate.
        n_qubits: state size (the bpa denominator is ``2^n × lanes``).
        headroom: measured/predicted ratio that counts as pressure
            (default 1.5× — the entropy model is deliberately loose).
        lanes: lanes currently materialized in the store (run_batch).
        ram_budget: the store's RAM budget, for the spill rung's target.
        disk_budget: optional disk-tier byte budget; overflowing it is
            the terminal ``abort`` rung.
    """

    predicted_bpa: float
    n_qubits: int
    headroom: float = 1.5
    lanes: int = 1
    ram_budget: int | None = None
    disk_budget: int | None = None
    rung: int = 0
    #: (stages_done, rung_name) of every escalation, newest last
    events: list = field(default_factory=list)

    def measured_bpa(self, store) -> float:
        denom = float(2 ** self.n_qubits) * max(1, self.lanes)
        return store.total_bytes / denom

    def under_pressure(self, store) -> bool:
        return self.measured_bpa(store) > self.headroom * self.predicted_bpa

    def check(self, store, pipe, stats, stages_done: int) -> None:
        """Escalate one rung if pressure persists; raise at disk overflow.

        Called at stage boundaries only — the store is consistent and no
        pipeline workers are mid-flight, so mutating ``pipe`` and
        spilling are race-free.
        """
        if (self.disk_budget is not None
                and store.stats.disk_bytes > self.disk_budget):
            self._record(stats, stages_done, "abort")
            raise MemoryPressureError(
                f"disk tier overflowed its budget after stage "
                f"{stages_done}: {store.stats.disk_bytes} B spilled > "
                f"{self.disk_budget} B allowed (measured "
                f"{self.measured_bpa(store):.2f} B/amp vs predicted "
                f"{self.predicted_bpa:.2f})",
                stages_done=stages_done)
        if not self.under_pressure(store) or self.rung >= len(RUNGS):
            return
        name = RUNGS[self.rung]
        self.rung += 1
        self._record(stats, stages_done, name)
        if name == "shrink_window":
            pipe.inflight_window = 1
        elif name == "wave_depth_1":
            pipe.depth = 1
            pipe.inflight_window = 1
        elif name == "proactive_spill":
            target = ((self.ram_budget // 2) if self.ram_budget
                      else store.stats.ram_bytes // 2)
            store.spill(target)

    def _record(self, stats, stages_done: int, name: str) -> None:
        self.events.append((stages_done, name))
        if stats is not None:
            stats.pressure_rungs.append(f"stage{stages_done}:{name}")
            stats.n_pressure_events += 1
