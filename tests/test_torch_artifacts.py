"""Framework-free artifacts are EXACTLY equal between the port and the JAX
package: circuit fingerprints, partition stages, compiled schedule op
lists and the compiled ExecutionPlan JSON (the port on the CPU records
interpret=True, like the JAX package's interpret-mode plans)."""
import pytest

pytest.importorskip("jax")
import torch

import repro
import repro_torch
from repro.core import library as jlib
from repro.core import partition as jpart
from repro.core import schedule as jsched
from repro.core.plan import ExecutionPlan as JPlan
from repro.core.plan import circuit_fingerprint as jfp
from repro_torch.core import partition as tpart
from repro_torch.core import schedule as tsched
from repro_torch.core.plan import ExecutionPlan as TPlan
from repro_torch.core.plan import circuit_fingerprint as tfp

CPU = torch.device("cpu")
NAMES = sorted(jlib.CIRCUIT_BUILDERS)
SIZES = [8, 10, 12]


def _pair(name, n):
    return repro.build_circuit(name, n), repro_torch.build_circuit(name, n)


def test_every_library_circuit_is_ported():
    assert sorted(repro_torch.core.CIRCUIT_BUILDERS) == NAMES


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("name", NAMES)
def test_fingerprint_partition_and_schedules_equal(name, n):
    jc, tc = _pair(name, n)
    assert jfp(jc) == tfp(tc)
    for g1, g2 in zip(jc.gates, tc.gates):
        assert (g1.name, g1.qubits, g1.params) == (g2.name, g2.qubits,
                                                   g2.params)
        assert (g1.matrix == g2.matrix).all()
    b = max(2, n - 4)
    jp = jpart.partition_circuit(jc, b, 2)
    tp = tpart.partition_circuit(tc, b, 2)
    assert [(s.inner, len(s.gates)) for s in jp.stages] == \
        [(s.inner, len(s.gates)) for s in tp.stages]
    with repro.Simulator(jc, repro.EngineConfig(local_bits=b)) as js, \
            repro_torch.Simulator(tc, repro_torch.EngineConfig(
                local_bits=b, devices=[CPU])) as ts:
        jplan, tplan = js.compile(), ts.compile()
    for jsp, tsp in zip(jplan.stages, tplan.stages):
        nv = jsp.layout.b + jsp.layout.m
        if not jsp.plan:
            continue
        assert jsp.plan == tsp.plan
        assert ([repr(op) for op in jsched.compile_schedule(jsp.plan, nv).ops]
                == [repr(op)
                    for op in tsched.compile_schedule(tsp.plan, nv).ops])


@pytest.mark.parametrize("budget", [None, 1 << 16])
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("name", NAMES)
def test_compiled_plan_json_equal(name, n, budget):
    """Default config (auto planning), and an auto-planned
    memory_budget_bytes config."""
    jc, tc = _pair(name, n)
    with repro.Simulator(jc, repro.EngineConfig(
            memory_budget_bytes=budget)) as js, \
            repro_torch.Simulator(tc, repro_torch.EngineConfig(
                memory_budget_bytes=budget, devices=[CPU])) as ts:
        jplan, tplan = js.compile(), ts.compile()
    assert tplan.interpret is True
    assert jplan.to_json() == tplan.to_json()
    assert jplan.fingerprint == tplan.fingerprint
    # plans round-trip between the packages
    assert TPlan.from_json(jplan.to_json()).to_json() == tplan.to_json()
    assert JPlan.from_json(tplan.to_json()).to_json() == jplan.to_json()
