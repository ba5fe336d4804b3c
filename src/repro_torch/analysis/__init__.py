"""Static verification of compiled plans.

:mod:`repro_torch.analysis.plan_check` is a pure pass over an
:class:`~repro_torch.core.plan.ExecutionPlan` proving layout flow, gate
tiling, schedule composition and byte predictions are internally
consistent before the engine executes the plan verbatim.  It runs by
default in ``Simulator.compile(verify=True)``.  (The AST lints of the JAX
package are not ported.)
"""
