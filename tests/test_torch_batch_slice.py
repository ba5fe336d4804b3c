"""Batched runs and noise trajectories in the port: Simulator.run_batch,
run(trajectories=K) and BMQSimEngine.run_batch (on the CPU, the kernels'
plain versions) against the JAX package's (Pallas in interpret mode) on
the same circuit, config, params and seeds, for the host and the device
codec, and against the dense oracle of each lane's realization.

Tolerances: fidelity of directions >= 0.999999 against repro's lane (the
suite's threshold for one circuit through two codec paths; the lossy codec
lets a deep circuit's norm drift by ~1e-4, in both packages alike) and
fidelity >= 0.999 against the lane's dense oracle (tests/test_batch.py's
floor); the stage update
within 1e-5 of repro's.  Counters and plans are framework-free and must
be equal to repro's: boundary bytes (per stage too), block counts,
transposes, lanes, chunks, fused unitaries and the plan JSON.  Trajectory
draws and the lane-stacked operands must equal repro's exactly.
"""
import contextlib
import io
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.core.dense_engine import simulate_dense as t_dense
from repro_torch.core.fidelity import norm
from repro_torch.interop import circuit_from_gates

try:
    import repro
except ImportError:             # the card's machine has no JAX
    repro = None

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _needs_jax(request):
    """Every test here but the ``cuda`` ones holds the port against the
    JAX package."""
    if repro is None and "cuda" not in request.keywords:
        pytest.skip("needs JAX (the reference package)")


REPRO_FID = 0.999999
ORACLE_FID = 0.999
CODECS = ["host", "device"]
COUNTERS = ("h2d_bytes", "d2h_bytes", "n_block_compressions",
            "n_block_decompressions", "n_transposes_naive",
            "n_transposes_scheduled", "n_lanes", "n_batch_chunks",
            "n_fused_unitaries", "n_stagefn_compiles",
            "n_stagefn_cache_hits", "n_runs", "n_stages")


def _carried(jc):
    return circuit_from_gates(
        jc.n_qubits, [(g.name, g.qubits, g.matrix, g.params)
                      for g in jc.gates])


def _sims(jc, **kw):
    """The same circuit and config in both packages (the port on the
    CPU)."""
    return (repro.Simulator(jc, repro.EngineConfig(**kw)),
            repro_torch.Simulator(_carried(jc), repro_torch.EngineConfig(
                devices=[CPU], **kw)))


def _fid(a, b):
    return repro_torch.fidelity(np.asarray(a, np.complex128),
                                np.asarray(b, np.complex128))


def _direction(a, b):
    """Fidelity of two states' directions."""
    return _fid(a, b) / (norm(a) * norm(b))


def _oracle(tc):
    return t_dense(tc, device=CPU).numpy()


def _same_stats(js, ts):
    for f in COUNTERS:
        assert getattr(ts.stats, f) == getattr(js.stats, f), f
    assert (ts.stats.per_stage_boundary_bytes
            == js.stats.per_stage_boundary_bytes)
    assert ts.stats.per_stage_exchange_bytes == \
        js.stats.per_stage_exchange_bytes


@pytest.mark.parametrize("codec", CODECS)
def test_deterministic_lanes_match_repro_and_a_plain_run(codec):
    jc = repro.build_circuit("qft", 8)
    js, ts = _sims(jc, local_bits=4, inner_size=2, codec_backend=codec)
    with js, ts:
        jb, tb = js.run_batch([None] * 3), ts.run_batch([None] * 3)
        assert len(tb) == 3 and isinstance(tb, repro_torch.BatchResult)
        _same_stats(js, ts)
        lanes = [lane.statevector() for lane in tb]
        jlanes = [lane.statevector() for lane in jb]
        solo = ts.run().statevector()
        assert ts.stats.n_lanes == 1
    oracle = _oracle(_carried(jc))
    for t, j in zip(lanes, jlanes):
        assert t.dtype == np.complex64 and np.isfinite(t).all()
        assert _direction(j, t) >= REPRO_FID
        assert _direction(solo, t) >= REPRO_FID
        assert _fid(oracle, t) >= ORACLE_FID


@pytest.mark.parametrize("codec", CODECS)
def test_qaoa_sweep_lane_by_lane(codec):
    """A 4-point sweep as one batch: each lane against repro's lane and
    against the port's own solo run(params=p)."""
    jc = repro.qaoa_template(8)
    points = [{"gamma0": 0.3 + 0.2 * i, "beta0": 0.1 + 0.1 * i}
              for i in range(4)]
    js, ts = _sims(jc, local_bits=4, inner_size=2, codec_backend=codec)
    with js, ts:
        jlanes = [lane.statevector() for lane in js.run_batch(points)]
        tlanes = [lane.statevector() for lane in ts.run_batch(points)]
        _same_stats(js, ts)
        solo = [ts.run(params=p).statevector() for p in points]
    for j, t, s in zip(jlanes, tlanes, solo):
        assert _direction(j, t) >= REPRO_FID
        assert _direction(s, t) >= REPRO_FID


@pytest.mark.parametrize("codec", CODECS)
def test_trajectory_lanes_match_their_realizations(codec):
    """run(trajectories=3, seed=11): lane j is noisy.realize(11 + j) draw
    for draw — the realized gates and the lane-stacked stage operands
    equal repro's — and matches that realization's dense oracle."""
    jnoisy = repro.with_depolarizing(repro.build_circuit("ghz_state", 6),
                                     0.08)
    tnoisy = _carried(jnoisy)
    assert tnoisy.is_stochastic
    js, ts = _sims(jnoisy, local_bits=3, codec_backend=codec)
    with js, ts:
        jb = js.run(trajectories=3, seed=11)
        tb = ts.run(trajectories=3, seed=11)
        _same_stats(js, ts)
        bindings = tuple((None, 11 + j) for j in range(3))
        jbound = js._engine._bind_stages_batch(bindings)
        tbound = ts._engine._bind_stages_batch(bindings)
        for jbs, tbs in zip(jbound, tbound):
            assert tbs.plan == jbs.plan
            for jm, tm in zip(jbs.mats, tbs.mats):
                lanes = jm.shape[0]
                np.testing.assert_array_equal(tm[:lanes].numpy(),
                                              np.asarray(jm))
        states = [lane.statevector() for lane in tb]
        jstates = [lane.statevector() for lane in jb]
    for j in range(3):
        jr, tr = jnoisy.realize(11 + j), tnoisy.realize(11 + j)
        for g1, g2 in zip(jr.gates, tr.gates):
            assert g1.name == g2.name and g1.qubits == g2.qubits
            np.testing.assert_array_equal(g1.matrix, g2.matrix)
        assert _fid(_oracle(tr), states[j]) >= ORACLE_FID
        assert _direction(jstates[j], states[j]) >= REPRO_FID


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("name,noisy", [("qft", False), ("qsvm", True)])
def test_plan_json_with_a_batch_factor_equals_repro(name, noisy, codec):
    jc = repro.build_circuit(name, 10)
    if noisy:
        jc = repro.with_depolarizing(jc, 0.02)
    js, ts = _sims(jc, batch=4, codec_backend=codec)
    with js, ts:
        jplan, tplan = js.compile(), ts.compile()
    assert tplan.batch == 4
    assert tplan.to_json() == jplan.to_json()


def test_tight_budget_chunks_sub_batches_and_holds_the_peak():
    """A budget that admits the predicted 2-lane working set but not 4
    lanes: both packages warn, chunk alike, and the answers stay."""
    from repro_torch.core.planner import (_predict_working_set,
                                          estimate_bytes_per_amp)
    jc = repro.build_circuit("qft", 10)
    bpa = estimate_bytes_per_amp(1e-3, True)
    peak2, pipe2 = _predict_working_set(10, 5, 2, 2, bpa, lanes=2)
    budget = peak2 + pipe2 + 1
    js, ts = _sims(jc, local_bits=5, inner_size=2,
                   memory_budget_bytes=budget, batch=4)
    with js, ts:
        with pytest.warns(RuntimeWarning, match="sub-batches"):
            tb = ts.run_batch([None] * 4)
        with pytest.warns(RuntimeWarning, match="sub-batches"):
            jb = js.run_batch([None] * 4)
        assert ts.stats.n_batch_chunks > 1 and ts.stats.n_lanes == 4
        assert ts.stats.peak_ram_bytes <= budget
        _same_stats(js, ts)
        assert ts._engine.feasible_lanes(4) == js._engine.feasible_lanes(4)
        oracle = _oracle(_carried(jc))
        for jl, tl in zip(jb, tb):
            t = tl.statevector()
            assert _fid(oracle, t) >= ORACLE_FID
            assert _direction(jl.statevector(), t) >= REPRO_FID


def test_trajectory_average_converges_to_the_analytic_value():
    """|0..0> through one depolarizing layer: <sum Z> = n (1 - 4p/3);
    48 trajectories of 4 qubits land within ~3 sigma, and on repro's
    estimate (the same draws)."""
    n, p, K = 4, 0.2, 48
    tc = repro_torch.Circuit(n)
    jc = repro.Circuit(n)
    for q in range(n):
        tc.depolarize(p, q)
        jc.depolarize(p, q)
    with repro_torch.Simulator(tc, repro_torch.EngineConfig(
            local_bits=2, devices=[CPU])) as ts:
        est = ts.run(trajectories=K, seed=3).expectation(
            repro_torch.zsum_cost_fn(n))
    with repro.Simulator(jc, repro.EngineConfig(local_bits=2)) as js:
        jest = js.run(trajectories=K, seed=3).expectation(
            repro.zsum_cost_fn(n))
    assert abs(est - n * (1.0 - 4.0 * p / 3.0)) < 0.6
    assert abs(est - jest) < 1e-3


@pytest.mark.parametrize("codec", CODECS)
def test_trajectories_are_seeded_and_reproducible(codec):
    noisy = repro_torch.with_depolarizing(
        repro_torch.build_circuit("cat_state", 5), 0.1)
    cost = repro_torch.zsum_cost_fn(5)
    with repro_torch.Simulator(noisy, repro_torch.EngineConfig(
            local_bits=3, devices=[CPU], codec_backend=codec)) as sim:
        a = sim.run(trajectories=4, seed=9)
        av = [lane.statevector() for lane in a]
        ea = a.expectations(cost)
        b = sim.run(trajectories=4, seed=9)
        np.testing.assert_array_equal(b.expectations(cost), ea)
        for x, lane in zip(av, b):
            np.testing.assert_array_equal(lane.statevector(), x)
        c = [lane.statevector() for lane in sim.run(trajectories=4,
                                                     seed=10)]
    assert any(not np.array_equal(x, y) for x, y in zip(av, c))


def _errors(pkg, tmp_path):
    """label -> callable, per error a batched run raises, for ``pkg``."""
    cpu = {"devices": [CPU]} if pkg is repro_torch else {}
    cfg = pkg.EngineConfig(local_bits=3, **cpu)
    qc = pkg.build_circuit("ghz_state", 6)
    noisy = pkg.with_depolarizing(pkg.build_circuit("cat_state", 5), 0.1)
    ck = str(tmp_path / f"{pkg.__name__}.ckpt")

    def sim(circuit=qc, **kw):
        return pkg.Simulator(circuit, pkg.EngineConfig(
            **{**cfg.__dict__, **kw}))

    def closed():
        s = sim()
        s.close()
        s.run_batch([None])

    def readout_only():
        with sim() as s:
            s.run().save(ck)
        with pkg.Simulator.resume(ck) as r:
            r.run_batch([None])

    def pending_partial():
        c = pkg.build_circuit("qft", 6)
        with pkg.Simulator(c, pkg.EngineConfig(local_bits=3, inner_size=1,
                                               **cpu)) as s:
            s.run(checkpoint_path=ck, checkpoint_every=1)
            s._save_checkpoint(ck, stages_done=1)
        with pkg.Simulator.resume(ck, circuit=c,
                                  config=pkg.EngineConfig(**cpu)) as r:
            r.run_batch([None])

    def engine_run_batch(circuit, bindings, **kw):
        def go():
            with sim(circuit, **kw) as s:
                s._engine.run_batch(bindings)
        return go

    def with_sim(fn, circuit=qc, **kw):
        def go():
            with sim(circuit, **kw) as s:
                fn(s)
        return go

    def save_batch(s):
        s.run_batch([None] * 2)[0].save(ck)

    out = dict([
        ("trajectories_checkpoint", with_sim(
            lambda s: s.run(trajectories=2, checkpoint_path=ck))),
        ("run_batch_checkpoint", with_sim(
            lambda s: s.run_batch([None], checkpoint_every=1))),
        ("closed", closed),
        ("readout_only", readout_only),
        ("pending_partial", pending_partial),
        ("seed_count", with_sim(
            lambda s: s.run_batch([None] * 3, seeds=[1, 2]))),
        ("gate_schedule_off", with_sim(lambda s: s.run_batch([None]),
                                       gate_schedule=False)),
        ("per_gate", with_sim(lambda s: s.run_batch([None]),
                              per_gate=True)),
        ("empty", with_sim(lambda s: s.run_batch([]))),
        ("stochastic_without_seed", engine_run_batch(noisy,
                                                     [(None, None)])),
        ("stochastic_plain_run", with_sim(lambda s: s.run(), noisy)),
        ("checkpoint_a_batch", with_sim(save_batch)),
    ])
    assert sorted(out) == sorted(ERROR_LABELS)
    return out


ERROR_LABELS = ["trajectories_checkpoint", "run_batch_checkpoint", "closed",
                "readout_only", "pending_partial", "seed_count",
                "gate_schedule_off", "per_gate", "empty",
                "stochastic_without_seed", "stochastic_plain_run",
                "checkpoint_a_batch"]


@pytest.mark.parametrize("label", ERROR_LABELS)
def test_errors_are_repros(label, tmp_path):
    """Every ValueError / RuntimeError repro raises around a batched run,
    with its type and message."""
    got = {}
    for pkg in (repro, repro_torch):
        fn = _errors(pkg, tmp_path)[label]
        with pytest.raises((ValueError, RuntimeError)) as info:
            fn()
        got[pkg] = info
    j, t = got[repro], got[repro_torch]
    assert type(t.value) is type(j.value)
    assert str(t.value).replace(str(tmp_path), "") == \
        str(j.value).replace(str(tmp_path), "")
    if label == "stochastic_plain_run":
        assert "trajectories" in str(t.value)


def test_batch_result_goes_stale_on_the_next_run():
    tc = repro_torch.build_circuit("qft", 8)
    with repro_torch.Simulator(tc, repro_torch.EngineConfig(
            local_bits=4, devices=[CPU])) as sim:
        batch = sim.run_batch([None] * 2)
        lane = batch[1]
        lane.sample(16)                          # live
        again = sim.run_batch([None] * 2)
        with pytest.raises(RuntimeError, match="stale"):
            lane.sample(16)
        again[0].sample(16)
        sim.run()
        with pytest.raises(RuntimeError, match="stale"):
            again[1].sample(16)
        # the single run cleared the batch's surplus lane from the store
        assert sim._engine._stored_lanes == 1
        n_blocks = sim._engine.n_blocks
        assert n_blocks not in sim._engine.store


def test_batch_stage_fns_compile_once_across_repeats():
    tc = repro_torch.build_circuit("qft", 8)
    with repro_torch.Simulator(tc, repro_torch.EngineConfig(
            local_bits=4, devices=[CPU])) as sim:
        sim.run_batch([None] * 2)
        compiles = sim.stats.n_stagefn_compiles
        sim.run_batch([None] * 2)
        assert sim.stats.n_stagefn_compiles == compiles
        assert sim.stats.n_lanes == 2


@pytest.mark.parametrize("use_kernel", [True, False])
def test_stage_fn_batch_on_a_multi_group_wave_equals_repros(use_kernel):
    """The lane-batched stage update on a (d·L)-row wave, groups-major
    (row w against lane w % L), against repro's jitted one on the same
    planes and (L, ...) operands: within 1e-5; and the port's operands
    tiled once for the full wave give the same rows."""
    from repro.core import engine as jeng
    from repro_torch.core import engine as teng
    from repro_torch.core.pipeline import StagePipeline
    jc = repro.random_circuit(7, 40, seed=5)
    points = [None] * 3
    lanes, d = len(points), 2
    with repro_torch.Simulator(_carried(jc), repro_torch.EngineConfig(
            local_bits=3, inner_size=2, pipeline_depth=d,
            devices=[CPU])) as ts:
        eng = ts._engine
        bindings = tuple((p, None) for p in points)
        bound = [bs for bs in eng._bind_stages_batch(bindings) if bs.plan]
        with StagePipeline(eng.backend, depth=d, devices=[CPU]) as pipe:
            keys, dev, _ = pipe._wave_items(
                bound[0].layout.group_block_ids(), bound[0].mats,
                np.arange(lanes) * eng.n_blocks)[0]
    assert dev == CPU
    assert keys.shape[0] == d * lanes
    np.testing.assert_array_equal(keys[1] - keys[0], [eng.n_blocks] *
                                  keys.shape[1])
    rng = np.random.default_rng(0)
    checked = 0
    for bs in bound:
        nv = bs.layout.b + bs.layout.m
        planes = rng.standard_normal((d * lanes, 2, 2 ** nv)).astype(
            np.float32)
        mats = [m[:lanes].numpy() for m in bs.mats]
        want = np.asarray(jeng._stage_fn_batch(bs.plan, nv, use_kernel,
                                               True)(
            planes.copy(), *mats))
        fn = teng._stage_fn_batch(bs.plan, nv, use_kernel)
        got = fn(torch.from_numpy(planes.copy()),
                 *[torch.from_numpy(m) for m in mats]).numpy()
        tiled = fn(torch.from_numpy(planes.copy()), *bs.mats).numpy()
        scale = np.abs(want).max()
        assert np.abs(got - want).max() <= 1e-5 * scale
        np.testing.assert_array_equal(tiled, got)
        checked += 1
    assert checked >= 2


@pytest.mark.parametrize("codec", CODECS)
def test_sequential_lane_loop_equals_the_wave_loop(codec):
    """StagePipeline.run_stage with lane_offsets and no wave_fn (one
    group's L lanes a call, as repro's sequential fallback) writes the
    same blocks as the wave loop."""
    from repro_torch.core.pipeline import StagePipeline
    tc = repro_torch.random_circuit(7, 30, seed=2)
    points = [None] * 3
    out = []
    for waves in (True, False):
        with repro_torch.Simulator(tc, repro_torch.EngineConfig(
                local_bits=3, inner_size=2, pipeline_depth=2,
                codec_backend=codec, devices=[CPU])) as sim:
            eng = sim._engine
            bindings = tuple((p, None) for p in points)
            eng._init_lanes(0, len(points))
            offs = np.arange(len(points)) * eng.n_blocks
            with StagePipeline(eng.backend, depth=2, devices=[CPU]) as pipe:
                for bs in eng._bind_stages_batch(bindings):
                    if bs.plan:
                        pipe.run_stage(bs.layout.group_block_ids(), bs.fn,
                                       bs.mats, lane_offsets=offs,
                                       wave_fn=bs.wave_fn if waves
                                       else None)
            eng._stored_lanes = len(points)
            out.append([lane.statevector() for lane in
                        repro_torch.BatchResult(eng.backend, eng.n, eng.b,
                                                len(points))])
    for a, b in zip(*out):
        np.testing.assert_array_equal(a, b)
    assert _fid(t_dense(tc, device=CPU).numpy(), out[1][2]) >= ORACLE_FID


@pytest.mark.parametrize("codec", CODECS)
def test_qsim_cli_runs_trajectories_on_the_cpu(codec):
    from repro.launch import qsim as jqsim
    from repro_torch.launch import qsim as tqsim
    argv = ["--circuit", "qft", "--qubits", "8", "--noise", "0.02",
            "--trajectories", "3", "--codec-backend", codec,
            "--expect", "zsum", "--shots", "32"]
    outs = []
    for main, extra in ((tqsim.main, ["--device", "cpu"]), (jqsim.main, [])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf), warnings.catch_warnings():
            warnings.simplefilter("ignore")
            assert main(argv + extra) == 0
        outs.append(buf.getvalue())
    tout, jout = outs
    assert "[qsim] batched run: 3 trajectories in 1 sub-batch(es)" in tout

    def pick(out, prefix):
        return [ln for ln in out.splitlines() if ln.startswith(prefix)]
    for prefix in ("[qsim] batched run", "[qsim] qft n=8",
                   "[qsim] group transposes", "[qsim] boundary traffic"):
        assert pick(tout, prefix) == pick(jout, prefix)
    tz = float(pick(tout, "[qsim] <sum Z_i>")[0].split()[4])
    jz = float(pick(jout, "[qsim] <sum Z_i>")[0].split()[4])
    assert abs(tz - jz) <= 1e-3


def _repro_qsim(argv: list) -> str:
    """repro's qsim in a subprocess, as tests/test_multidevice.py runs it:
    ``--devices D`` makes D virtual host devices before JAX starts."""
    root = os.path.join(os.path.dirname(__file__), "..")
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"),
               JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-m", "repro.launch.qsim", *argv],
                         capture_output=True, text=True, env=env,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    return out.stdout


def test_qsim_cli_batch_explain_and_unported_mesh():
    """The name is kept from when ``--devices 2`` raised; A10 ported it:
    the call returns 0 on two CPU slots, block-sharded, and its lines
    (the exchange line among them) are repro's ``qsim --devices 2``."""
    from repro_torch.launch import qsim as tqsim
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert tqsim.main(["--circuit", "qft", "--qubits", "8", "--batch",
                           "2", "--device", "cpu", "--expect", "zsum"]) == 0
        assert tqsim.main(["--circuit", "qft", "--qubits", "8", "--batch",
                           "2", "--device", "cpu", "--explain"]) == 0
    out = buf.getvalue()
    assert "[qsim] batched run: 2 lanes in 1 sub-batch(es)" in out
    assert "(avg over 2 lanes" in out
    argv = ["--circuit", "qft", "--qubits", "8", "--devices", "2"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert tqsim.main(argv + ["--device", "cpu"]) == 0
    tout, jout = buf.getvalue(), _repro_qsim(argv)
    assert "[qsim] 2 device slots on 1 physical device(s): cpu" in tout

    def pick(out, prefixes):
        return [ln for ln in out.splitlines() if ln.startswith(prefixes)]
    exact = ("[qsim] planned", "[qsim] qft n=8", "[qsim] group transposes",
             "[qsim] boundary traffic", "[qsim] device exchange")
    assert pick(tout, exact) == pick(jout, exact)
    assert len(pick(tout, "[qsim] device exchange (2 devices)")) == 1


def test_batched_runs_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tc = repro_torch.with_depolarizing(
        repro_torch.build_circuit("ghz_state", 6), 0.05)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        repro_torch.Simulator(tc, repro_torch.EngineConfig()).run(
            trajectories=2)
    from repro_torch.launch import qsim as tqsim
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tqsim.main(["--circuit", "ghz_state", "--qubits", "6", "--batch",
                    "2"])


@pytest.mark.cuda
def test_batched_run_launch_counts_on_the_card():
    """On the card a batched run launches gemm_planes_batch once per
    GemmOp per wave and encode / decode once per wave, whatever the lane
    count, and agrees with the CPU run."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU form")
    from repro_torch.core.schedule import GemmOp
    from repro_torch.kernels import codec, gate_apply
    tc = repro_torch.with_depolarizing(
        repro_torch.build_circuit("qft", 12), 0.02)
    cfg = dict(local_bits=8, codec_backend="device")
    with repro_torch.Simulator(tc, repro_torch.EngineConfig(
            devices=[CPU], **cfg)) as sim:
        want = [lane.statevector() for lane in sim.run(trajectories=5)]
    for lanes in (5, 2):
        with repro_torch.Simulator(tc, repro_torch.EngineConfig(
                **cfg)) as sim:
            eng = sim._engine
            bound = [bs for bs in eng._bind_stages_batch(
                tuple((None, j) for j in range(lanes))) if bs.plan]
            depth = eng.cfg.pipeline_depth
            waves = [-(-bs.layout.n_groups // min(depth, bs.layout.n_groups))
                     for bs in bound]
            gemms = sum(w * sum(isinstance(op, GemmOp)
                                for op in bs.sched.ops)
                        for w, bs in zip(waves, bound))
            gate_apply.reset_launch_counts()
            codec.reset_launch_counts()
            got = sim.run(trajectories=lanes)
            torch.cuda.synchronize()
            assert gate_apply.launch_counts["gemm_planes_batch"] == gemms
            assert codec.launch_counts["encode"] == sum(waves)
            assert codec.launch_counts["decode"] == sum(waves)
            assert gate_apply.launch_counts["gemm_planes"] == 0
            states = [lane.statevector() for lane in got]
        for j in range(lanes):
            assert _direction(want[j], states[j]) >= REPRO_FID
