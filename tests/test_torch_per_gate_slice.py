"""The per-gate slice as a whole: ``Simulator(circuit,
EngineConfig(gate_schedule=False)).run()`` (the per-gate stage compute,
one group at a time through the pipeline's single-group hooks) and the
``per_gate=True`` baseline (one stage per gate) in the port, on the CPU
with the kernels' plain versions, against the JAX package (Pallas in
interpret mode) and against the port's dense oracle.

Held as ``tests/test_torch_slice.py`` holds the wave path: equal plan
JSON; equal byte, block and transpose counters; final states within
2·S·b_r of each other in 2-norm (S stages, each encode moving a unit
state by at most b_r); fidelity against the dense oracle >= 0.99.
"""
import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.core.dense_engine import simulate_dense as t_dense
from repro_torch.interop import circuit_from_gates
from repro_torch.kernels import gate_apply as tga

CPU = torch.device("cpu")
B_R = 1e-3
COUNTERS = ("h2d_bytes", "d2h_bytes", "n_block_compressions",
            "n_block_decompressions", "n_stages", "n_transposes_naive",
            "n_transposes_scheduled", "n_fused_unitaries",
            "n_stagefn_compiles", "n_group_phases")

CIRCUITS = [("qft", 12), ("qsvm", 10), ("ising", 9), ("ghz_state", 14),
            ("bv", 11), ("cat_state", 13), ("cc", 10), ("qaoa", 8)]
PER_GATE = [("qft", 8), ("qsvm", 8), ("ising", 8), ("cc", 9), ("bv", 10)]


def _carried(jc):
    return circuit_from_gates(
        jc.n_qubits, [(g.name, g.qubits, g.matrix, g.params)
                      for g in jc.gates])


def _check(name, n, **kw):
    pytest.importorskip("jax")
    import repro

    jc = repro.build_circuit(name, n)
    tc = _carried(jc)
    with repro.Simulator(jc, repro.EngineConfig(**kw)) as js:
        jplan = js.compile().to_json()
        jstate = js.run().statevector()
        jstats = js.stats
    tga.reset_launch_counts()
    with repro_torch.Simulator(tc, repro_torch.EngineConfig(
            devices=[CPU], **kw)) as ts:
        tplan = ts.compile().to_json()
        tstate = ts.run().statevector()
        tstats = ts.stats
    assert sum(tga.launch_counts.values()) == 0     # CPU: plain versions
    assert tplan == jplan
    for f in COUNTERS:
        assert getattr(tstats, f) == getattr(jstats, f), f
    assert tstats.per_stage_boundary_bytes == jstats.per_stage_boundary_bytes
    assert tstate.dtype == np.complex64 and np.isfinite(tstate).all()
    assert np.linalg.norm(tstate - jstate) <= 2 * tstats.n_stages * B_R
    ideal = t_dense(tc, device=CPU)
    assert repro_torch.fidelity(ideal, torch.from_numpy(tstate)) >= 0.99
    return tstats


@pytest.mark.parametrize("codec", ["host", "device"])
@pytest.mark.parametrize("name,n", CIRCUITS)
def test_per_gate_path_matches_repro(name, n, codec):
    stats = _check(name, n, gate_schedule=False, codec_backend=codec)
    # the per-gate path runs one group at a time: one phase a group a stage
    assert stats.n_group_phases > 0


@pytest.mark.parametrize("codec", ["host", "device"])
@pytest.mark.parametrize("name,n", [("qft", 11), ("qsvm", 9), ("ising", 10),
                                    ("cc", 8)])
def test_per_gate_path_without_kernels_matches_repro(name, n, codec):
    _check(name, n, gate_schedule=False, use_kernel=False,
           codec_backend=codec)


@pytest.mark.parametrize("gate_schedule", [True, False])
@pytest.mark.parametrize("name,n", PER_GATE)
def test_per_gate_baseline_matches_repro(name, n, gate_schedule):
    """``per_gate=True`` (one stage per gate, the SC19 baseline) under
    both stage computes."""
    stats = _check(name, n, per_gate=True, gate_schedule=gate_schedule)
    assert stats.n_stages == len(repro_torch.build_circuit(name, n).gates)


def test_per_gate_path_matches_the_wave_path():
    """Both stage computes of the port on one circuit: same plan but for
    the knob, same boundary bytes, states within the two paths' bound."""
    tc = repro_torch.build_circuit("qft", 12)
    out = {}
    for gs in (True, False):
        with repro_torch.Simulator(tc, repro_torch.EngineConfig(
                devices=[CPU], gate_schedule=gs)) as s:
            out[gs] = (s.run().statevector(), s.stats)
    (ws, wst), (ps, pst) = out[True], out[False]
    assert (wst.h2d_bytes, wst.d2h_bytes) == (pst.h2d_bytes, pst.d2h_bytes)
    assert np.linalg.norm(ws - ps) <= 2 * pst.n_stages * B_R
    assert repro_torch.fidelity(ws, ps) >= 0.9999


@pytest.mark.cuda
def test_cuda_per_gate_run_launches_one_kernel_a_gate_a_group():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU form")
    from repro_torch.kernels import codec

    tc = repro_torch.build_circuit("qft", 14)
    kw = dict(local_bits=8, codec_backend="device", gate_schedule=False)
    cpu_state, cpu_stats = repro_torch.simulate_bmqsim(
        tc, repro_torch.EngineConfig(devices=[CPU], **kw))
    with repro_torch.Simulator(tc, repro_torch.EngineConfig(**kw)) as s:
        bound = s._engine._bind_stages(None)
        dense = sum(sum(not d for _, d in bs.plan) * bs.layout.n_groups
                    for bs in bound if bs.plan)
        diag = sum(sum(d for _, d in bs.plan) * bs.layout.n_groups
                   for bs in bound if bs.plan)
        groups = sum(bs.layout.n_groups for bs in bound if bs.plan)
        tga.reset_launch_counts()
        codec.reset_launch_counts()
        state = s.run().statevector()
        stats = s.stats
    assert tga.launch_counts["gemm_planes"] == dense
    assert tga.launch_counts["diag_apply"] == diag
    assert tga.launch_counts["gemm_planes_batch"] == 0
    assert codec.launch_counts == {"encode": groups, "decode": groups}
    assert repro_torch.fidelity(cpu_state, state) >= 0.99999
    for f in ("h2d_bytes", "d2h_bytes", "n_block_compressions",
              "n_block_decompressions", "n_stages"):
        assert getattr(stats, f) == getattr(cpu_stats, f), f
