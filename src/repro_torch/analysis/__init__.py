"""Static analysis & invariant verification for the simulator.

Two halves (see ARCHITECTURE.md "Static analysis & invariants"):

* :mod:`repro_torch.analysis.plan_check` — a pure pass over
  :class:`~repro_torch.core.plan.ExecutionPlan` proving layout flow, gate
  tiling, schedule composition and byte predictions are internally
  consistent before the engine executes the plan verbatim.  Runs by
  default in ``Simulator.compile(verify=True)`` and as the plan-only
  ``qsim --verify``.
* :mod:`repro_torch.analysis.lint` — an AST checker framework
  (``python -m repro_torch.analysis src/repro_torch``) enforcing the
  project's cross-cutting invariants: fault-point coverage, lock
  discipline, jit purity and the typed-error contract.

``plan_check`` pulls in the planner (and through it torch), so it is
exposed lazily — linting stays importable in seconds on a cold cache.
"""

from __future__ import annotations

from .lint import Violation, all_checkers, run_checkers

__all__ = [
    "Violation",
    "all_checkers",
    "run_checkers",
    "PlanFinding",
    "verify_plan",
    "check_plan",
]

_PLAN_CHECK = ("PlanFinding", "verify_plan", "check_plan")


def __getattr__(name: str):
    if name in _PLAN_CHECK:
        from . import plan_check

        return getattr(plan_check, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
