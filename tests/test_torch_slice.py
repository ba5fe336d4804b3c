"""The slice as a whole: Simulator(circuit, EngineConfig()).run() and its
SimResult readout in the port (on the CPU, kernels' plain versions)
against the JAX package (Pallas in interpret mode), and each against its
own dense oracle.

Tolerances: fidelity(port, repro) >= 0.9999 and each package against its
dense oracle >= 0.99 (the suite's threshold); expectation values within
1e-3.  Amplitudes: every stage's pwrel encode moves each real part by at
most b_r relative, so it moves a unit state by at most b_r in 2-norm and
the unitary gates carry that on unchanged; after S stages each package is
within S*b_r of the ideal state and the two within 2*S*b_r of each other.
(A per-amplitude relative bound of 2*b_r holds only for shallow circuits:
on qsvm-10, 19 stages, the JAX package's own amplitudes are 7% off its
dense oracle.)  Byte and block counters are framework-free and must be
exactly equal.
"""
import numpy as np
import pytest

pytest.importorskip("jax")
import torch

import repro
import repro_torch
from repro_torch.core.dense_engine import simulate_dense as t_dense
from repro_torch.core.fidelity import norm
from repro_torch.interop import circuit_from_gates

CPU = torch.device("cpu")
B_R = 1e-3

CASES = [("qft", 12), ("ising", 10), ("qsvm", 10), ("ghz_state", 12),
         ("qft", 10)]
QAOA_PARAMS = {"gamma0": 0.8, "beta0": 0.4}


def _idx(n):
    return np.arange(0, 2 ** n, 7)


def _run_both(jc, tc, params=None):
    with repro.Simulator(jc, repro.EngineConfig()) as js:
        jr = js.run(params=params)
        jstate = jr.statevector()
        jstats = js.stats
        jout = (jr.expectation(repro.zsum_cost_fn(jc.n_qubits)),
                jr.amplitudes(_idx(jc.n_qubits)))
    with repro_torch.Simulator(tc, repro_torch.EngineConfig(
            devices=[CPU])) as ts:
        tr = ts.run(params=params)
        tstate = tr.statevector()
        tstats = ts.stats
        tout = (tr.expectation(repro_torch.zsum_cost_fn(tc.n_qubits)),
                tr.amplitudes(_idx(tc.n_qubits)))
    return (jstate, jstats, jout), (tstate, tstats, tout)


def _check(jc, tc, params=None, cost_j=None, cost_t=None):
    (js, jstats, jout), (ts, tstats, tout) = _run_both(jc, tc, params)
    assert ts.shape == js.shape and ts.dtype == np.complex64
    assert np.isfinite(ts).all()
    assert repro_torch.fidelity(js, ts) >= 0.9999
    bound_j = jc.bind(params) if params else jc
    bound_t = tc.bind(params) if params else tc
    j_ideal = np.asarray(repro.simulate_dense(bound_j))
    t_ideal = t_dense(bound_t, device=CPU)
    assert repro.fidelity(j_ideal, js) >= 0.99
    assert repro_torch.fidelity(t_ideal, torch.from_numpy(ts)) >= 0.99
    # readout
    assert abs(jout[0] - tout[0]) <= 1e-3
    ja, ta = jout[1], tout[1]
    np.testing.assert_array_equal(ta, ts[_idx(tc.n_qubits)])
    assert np.linalg.norm(ta - ja) <= 2 * tstats.n_stages * B_R
    # framework-free counters: exactly equal
    for f in ("h2d_bytes", "d2h_bytes", "n_block_compressions",
              "n_block_decompressions", "n_stages", "n_transposes_naive",
              "n_transposes_scheduled", "n_fused_unitaries"):
        assert getattr(jstats, f) == getattr(tstats, f), f
    assert jstats.per_stage_boundary_bytes == tstats.per_stage_boundary_bytes


def _carried(jc):
    """The JAX package's circuit, carried into the port through interop."""
    return circuit_from_gates(
        jc.n_qubits, [(g.name, g.qubits, g.matrix, g.params)
                      for g in jc.gates])


@pytest.mark.parametrize("name,n", CASES)
def test_port_matches_repro_end_to_end(name, n):
    jc = repro.build_circuit(name, n)
    _check(jc, _carried(jc))


def test_qaoa_with_a_parameter_binding():
    jc = repro.qaoa_template(10, layers=1)
    tc = _carried(jc)
    assert jc.free_parameters == tc.free_parameters == set(QAOA_PARAMS)
    _check(jc, tc, QAOA_PARAMS)
    # the MaxCut expectation, the quantity a QAOA user reads
    edges = repro.maxcut_edges(10)
    assert edges == repro_torch.maxcut_edges(10)
    with repro.Simulator(jc, repro.EngineConfig()) as js, \
            repro_torch.Simulator(tc, repro_torch.EngineConfig(
                devices=[CPU])) as ts:
        je = js.run(params=QAOA_PARAMS).expectation(
            repro.maxcut_cost_fn(edges))
        te = ts.run(params=QAOA_PARAMS).expectation(
            repro_torch.maxcut_cost_fn(edges))
        assert ts.stats.n_stagefn_compiles == js.stats.n_stagefn_compiles
    assert abs(je - te) <= 1e-3


@pytest.mark.parametrize("name", ["qft", "ising", "qsvm", "bv"])
def test_dense_oracle_matches_repro(name):
    jc = repro.build_circuit(name, 9)
    tc = repro_torch.build_circuit(name, 9)
    want = np.asarray(repro.simulate_dense(jc))
    got = t_dense(tc, device=CPU)
    assert got.dtype == torch.complex64 and got.shape == (2 ** 9,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    # complex64 norm drift over ~170 gates is ~1e-6: compare directions
    fid = repro_torch.fidelity(want, got) / (norm(want) * norm(got))
    assert fid >= 0.999999


def test_sample_counts_cover_the_shots():
    with repro_torch.Simulator(repro_torch.build_circuit("ghz_state", 10),
                               repro_torch.EngineConfig(devices=[CPU])) as s:
        counts = s.run().sample(256, seed=3)
    assert sum(counts.values()) == 256
    assert set(counts) <= {0, 2 ** 10 - 1}


def test_rerun_reuses_compiled_stage_functions():
    with repro_torch.Simulator(repro_torch.qaoa_template(8, layers=1),
                               repro_torch.EngineConfig(devices=[CPU])) as s:
        s.run(params={"gamma0": 0.1, "beta0": 0.2})
        first = s.stats.n_stagefn_compiles
        s.run(params={"gamma0": 0.5, "beta0": 0.9})
        assert s.stats.n_stagefn_compiles == first
        assert s.stats.n_stagefn_cache_hits > 0


@pytest.mark.parametrize("depth", [2, 4])
def test_final_state_is_invariant_across_pipeline_depths(depth):
    """Depth 1 runs the sequential wave loop, depth > 1 the overlapped
    one: on the host codec the final states agree bitwise, as in the JAX
    package (``test_depth_invariant_smoke``), and match its depth-1
    state."""
    jc = repro.random_circuit(6, 12, seed=3)

    def cfg(pkg, d, **kw):
        return pkg.EngineConfig(local_bits=3, inner_size=2,
                                pipeline_depth=d, **kw)

    with repro_torch.Simulator(_carried(jc),
                               cfg(repro_torch, 1, devices=[CPU])) as s1, \
            repro_torch.Simulator(_carried(jc),
                                  cfg(repro_torch, depth,
                                      devices=[CPU])) as s2:
        ref = s1.run().statevector()
        got = s2.run().statevector()
    np.testing.assert_array_equal(ref, got)
    want, _ = repro.simulate_bmqsim(jc, cfg(repro, 1))
    assert repro_torch.fidelity(np.asarray(want), got) >= 0.9999
