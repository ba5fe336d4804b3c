"""Several devices in the port (paper §4.2, multi-GPU): lane sharding,
block sharding with its exchange ledger, crash and resume at a block
hand-off, the placement helpers of ``distributed.lanes`` and the sharded
dense baseline, against the JAX package in process.

Both packages run D slots of one device: ``[cpu] * D`` in the port and
``[jax.devices()[0]] * D`` in ``repro``, whose engine runs a list with
repeats without a mesh, so no ``XLA_FLAGS`` is needed (the scenarios are
``tests/test_multidevice.py``'s, which makes virtual devices in a
subprocess).

What is held.  Block counts, which keys change owners at each stage
boundary, and every counter of ``tests/test_torch_batch_slice.py``'s
``COUNTERS`` are framework-free: equal to ``repro``'s.  Exchange bytes
are the stored blobs' sizes: equal with ``compression=False``; compressed,
pwrel ties change a blob's size (ROADMAP, "The pwrel tolerance"), so they
equal the sum of the port store's ``nbytes_of`` over its moved keys and
lie within EXCHANGE_RTOL of ``repro``'s (measured on a CPU container at
qaoa-13, ising-13 and qsvm-11 with 2^7-amplitude blocks: totals within
2.9e-3, a stage within 2.8e-2; qft, qaoa, qsvm, ising and ghz at n <= 10
with 2^4-amplitude blocks: equal).  With repeated devices the waves are
the one-device waves, so the port's states equal its one-device run's bit
for bit on both codecs; against ``repro`` they are held in direction.
"""
import os
import tempfile
import warnings

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.core.dense_engine import simulate_dense as t_dense
from repro_torch.core.dense_engine import simulate_dense_sharded
from repro_torch.core.fidelity import norm
from repro_torch.distributed import lanes as tlanes
from repro_torch.interop import circuit_from_gates

repro = pytest.importorskip("repro")
jax = pytest.importorskip("jax")
from repro.distributed import lanes as jlanes  # noqa: E402

CPU = torch.device("cpu")
REPRO_FID = 0.999999
CODECS = ["host", "device"]
COUNTERS = ("h2d_bytes", "d2h_bytes", "n_block_compressions",
            "n_block_decompressions", "n_transposes_naive",
            "n_transposes_scheduled", "n_lanes", "n_batch_chunks",
            "n_fused_unitaries", "n_stagefn_compiles",
            "n_stagefn_cache_hits", "n_runs", "n_stages",
            "n_exchanged_blocks")
#: compressed exchange bytes against repro's (see the module docstring)
EXCHANGE_RTOL = {"total": 1e-2, "stage": 1e-1}


def _jdevs(d):
    return [jax.devices()[0]] * d


def _carried(jc):
    return circuit_from_gates(
        jc.n_qubits, [(g.name, g.qubits, g.matrix, g.params)
                      for g in jc.gates])


def _sims(jc, d, **kw):
    """The same circuit and config in both packages on d slots."""
    return (repro.Simulator(jc, repro.EngineConfig(devices=_jdevs(d), **kw)),
            repro_torch.Simulator(_carried(jc), repro_torch.EngineConfig(
                devices=[CPU] * d, **kw)))


def _direction(a, b):
    a, b = np.asarray(a, np.complex128), np.asarray(b, np.complex128)
    return repro_torch.fidelity(a, b) / (norm(a) * norm(b))


def _same_counters(js, ts):
    for f in COUNTERS:
        assert getattr(ts.stats, f) == getattr(js.stats, f), f
    assert (ts.stats.per_stage_boundary_bytes
            == js.stats.per_stage_boundary_bytes)


class _Moves:
    """Records an engine's exchange ledger: each stage boundary's moved
    keys and the store's ``nbytes_of`` of each, through the two calls the
    ledger makes (the same names in both packages)."""

    def __init__(self, engine):
        self.stages, eng, store = [], engine, engine.store
        ledger, nbytes = eng._exchange_ledger, store.nbytes_of

        def on_ledger(*a):
            self.stages.append({})
            return ledger(*a)

        def on_nbytes(k):
            n = nbytes(k)
            self.stages[-1][k] = n
            return n
        eng._exchange_ledger, store.nbytes_of = on_ledger, on_nbytes


# -- distributed.lanes against repro's ----------------------------------------

@pytest.mark.parametrize("d,k", [(1, 1), (1, 5), (2, 8), (3, 8), (8, 3),
                                 (4, 4), (5, 13)])
def test_lane_helpers_equal_repros(d, k):
    """make_lane_shards, device_slots and gather_lanes on the same
    integers (placeholders for devices) as repro's."""
    devs = list(range(d))
    tsh, jsh = tlanes.make_lane_shards(devs, k), jlanes.make_lane_shards(
        devs, k)
    assert [(s.device, s.lanes, s.n_lanes) for s in tsh] == \
        [(s.device, s.lanes, s.n_lanes) for s in jsh]
    assert sum(s.n_lanes for s in tsh) == k
    np.testing.assert_array_equal(tlanes.device_slots(k, d),
                                  jlanes.device_slots(k, d))
    parts = [np.arange(s.lanes.start, s.lanes.stop) * 1.5 for s in tsh]
    np.testing.assert_array_equal(tlanes.gather_lanes(parts),
                                  jlanes.gather_lanes(parts))
    with pytest.raises(ValueError, match="n_lanes=0"):
        tlanes.make_lane_shards(devs, 0)
    with pytest.raises(ValueError, match="n_lanes=0"):
        jlanes.make_lane_shards(devs, 0)


def test_sim_devices_and_mesh_follow_repros_rules():
    """Truncation, the clamp with a RuntimeWarning, the 1-D rule and the
    names: as repro's, on explicit lists (the port's default list is the
    visible cards, and it raises without one)."""
    t4, j4 = [CPU] * 4, _jdevs(4)
    assert len(tlanes.sim_devices(2, t4)) == len(jlanes.sim_devices(2, j4))
    for mod, devs in ((tlanes, t4), (jlanes, j4)):
        with pytest.warns(RuntimeWarning, match="requested 6 devices but "
                          "only 4 are visible; clamping"):
            assert len(mod.sim_devices(6, devs)) == 4
        with pytest.raises(ValueError, match="n_devices=0"):
            mod.sim_devices(0, devs)
        with pytest.raises(ValueError, match="simulation meshes are 1-D"):
            mod.make_lane_mesh((2, 2), devs)
    mesh = tlanes.make_lane_mesh(3, t4)
    assert mesh.shape == (3,) and mesh.axis == tlanes.LANE_AXIS == \
        jlanes.LANE_AXIS
    assert tlanes.make_lane_mesh(devices=t4).devices == tuple(t4)
    assert set(jlanes.__all__) - set(tlanes.__all__) == {
        "activate_mesh", "lane_sharding", "lane_spec"}


def test_mesh_shape_clamps_to_the_visible_devices(monkeypatch):
    """``mesh_shape=2`` with one visible device clamps with repro's
    warning and runs on it, as repro's does on its one CPU device."""
    monkeypatch.setattr(tlanes, "visible_devices", lambda: [CPU])
    jc = repro.build_circuit("ghz_state", 6)
    got = []
    for pkg, circ in ((repro, jc), (repro_torch, _carried(jc))):
        with pytest.warns(RuntimeWarning, match="requested 2 devices but "
                          "only 1 are visible"):
            sim = pkg.Simulator(circ, pkg.EngineConfig(local_bits=3,
                                                       mesh_shape=2))
        with sim:
            assert len(sim._engine._devices) == 1
            got.append(sim.run().statevector())
    assert _direction(*got) >= REPRO_FID


# -- block sharding -------------------------------------------------------------

@pytest.mark.parametrize("codec", CODECS)
def test_engine_multidevice_equals_single(codec):
    """SV groups round-robined over 8 slots: bit for bit the one-slot run
    (the waves are the same), repro's 8-slot run in direction, every
    counter equal to repro's, the plan recording 8 devices as repro's."""
    jc = repro.build_circuit("qft", 9)
    js, ts = _sims(jc, 8, local_bits=4, codec_backend=codec)
    with js, ts, repro_torch.Simulator(_carried(jc), repro_torch.EngineConfig(
            local_bits=4, codec_backend=codec, devices=[CPU])) as one:
        j8 = js.run().statevector()
        t8 = ts.run().statevector()
        t1 = one.run().statevector()
        _same_counters(js, ts)
        assert ts.stats.per_stage_exchange_bytes == \
            js.stats.per_stage_exchange_bytes
        assert one.stats.n_exchanged_blocks == 0
        for f in COUNTERS[:-1]:
            assert getattr(one.stats, f) == getattr(ts.stats, f), f
        assert ts.compile().n_devices == 8
        assert ts.compile().to_json() == js.compile().to_json()
    assert np.array_equal(t8, t1)
    assert _direction(j8, t8) >= REPRO_FID
    ideal = t_dense(_carried(jc), device=CPU).numpy()
    assert repro_torch.fidelity(ideal.astype(np.complex128),
                                t8.astype(np.complex128)) > 0.99


@pytest.mark.parametrize("name,n,b,d,comp,codec", [
    ("qft", 9, 4, 4, False, "host"), ("qaoa", 9, 4, 2, False, "host"),
    ("qft", 9, 4, 4, True, "device"), ("ising", 11, 6, 4, True, "host"),
    ("qaoa", 9, 5, 3, True, "host")])
def test_block_sharded_ledger_matches_repro(name, n, b, d, comp, codec):
    """The exchange ledger of a block-sharded run: the same moved keys at
    every stage boundary as repro's, stage 0 free, the stage sums the
    total, under the raw bytes of the moved blocks where compressed; the
    bytes equal to repro's raw, within EXCHANGE_RTOL compressed."""
    jc = repro.build_circuit(name, n)
    js, ts = _sims(jc, d, local_bits=b, codec_backend=codec,
                   compression=comp)
    with js, ts:
        jm, tm = _Moves(js._engine), _Moves(ts._engine)
        js.run()
        ts.run()
        _same_counters(js, ts)
        st, sj = ts.stats, js.stats
    assert [set(s) for s in tm.stages] == [set(s) for s in jm.stages]
    assert st.n_exchanged_blocks == sum(len(s) for s in tm.stages) > 0
    assert [sum(s.values()) for s in tm.stages] == \
        st.per_stage_exchange_bytes
    assert st.per_stage_exchange_bytes[0] == 0
    assert sum(st.per_stage_exchange_bytes) == st.exchange_bytes
    if not comp:
        assert st.exchange_bytes == sj.exchange_bytes == \
            st.n_exchanged_blocks * 2 ** b * 8
        assert st.per_stage_exchange_bytes == sj.per_stage_exchange_bytes
        return
    assert 0 < st.exchange_bytes < st.n_exchanged_blocks * 2 ** b * 8
    assert abs(st.exchange_bytes - sj.exchange_bytes) <= \
        EXCHANGE_RTOL["total"] * sj.exchange_bytes
    for a, w in zip(st.per_stage_exchange_bytes, sj.per_stage_exchange_bytes):
        assert abs(a - w) <= EXCHANGE_RTOL["stage"] * w


def test_block_sharded_device_codec_fidelity():
    """repro's test on the port: the lossy device codec, block-sharded
    over 8 slots: fidelity >= 0.99 against the dense oracle, and only
    encoded wire crosses (fewer bytes than the moved blocks' raw
    bytes)."""
    tc = repro_torch.build_circuit("qft", 10)
    with repro_torch.Simulator(tc, repro_torch.EngineConfig(
            local_bits=4, codec_backend="device", devices=[CPU] * 8)) as sim:
        sv = sim.run().statevector()
        st = sim.stats
    assert st.n_exchanged_blocks > 0
    assert 0 < st.exchange_bytes < st.n_exchanged_blocks * (1 << 4) * 8
    assert sum(st.per_stage_exchange_bytes) == st.exchange_bytes
    assert st.per_stage_exchange_bytes[0] == 0
    ideal = t_dense(tc, device=CPU).numpy()
    assert repro_torch.fidelity(ideal.astype(np.complex128),
                                sv.astype(np.complex128)) > 0.99


@pytest.mark.parametrize("codec", CODECS)
def test_exchange_crash_and_resume(codec):
    """A crash at the 40th block hand-off (``pipeline.exchange``) leaves
    the last stage-boundary checkpoint; resuming reproduces the
    uninterrupted state bit for bit, and the fault fires where repro's
    does (the same resume stage)."""
    jc = repro.build_circuit("qft", 9)
    out = []
    for pkg, circ, devs in ((repro, jc, _jdevs(8)),
                            (repro_torch, _carried(jc), [CPU] * 8)):
        def mk():
            return pkg.EngineConfig(local_bits=4, codec_backend=codec,
                                    devices=devs)
        with pkg.Simulator(circ, mk()) as sim:
            ref = sim.run().statevector()
            n_stages = sim.stats.n_stages
        ck = os.path.join(tempfile.mkdtemp(), "ck.bmq")
        with pkg.inject_faults(["pipeline.exchange:crash:hit=40"]) as inj:
            with pytest.raises(pkg.InjectedCrash):
                with pkg.Simulator(circ, mk()) as sim:
                    sim.run(checkpoint_path=ck, checkpoint_every=1)
        assert inj.fired["pipeline.exchange:crash"] == 1
        assert os.path.exists(ck)
        resumed = pkg.Simulator.resume(ck, circuit=circ, config=mk())
        try:
            start = resumed._start_stage
            assert 0 < start < n_stages
            assert np.array_equal(resumed.run().statevector(), ref)
            out.append((start, resumed.stats.per_stage_exchange_bytes[0]))
        finally:
            resumed.close()
    assert out[0] == out[1]


def test_multidevice_scaling_stats():
    """repro's Fig. 13 harness check on the port, beside repro's: every
    group placed, the state's norm within 5e-3 of 1, and the two
    engines' final states in the same direction."""
    jc = repro.build_circuit("qaoa", 9)
    jeng = repro.core.engine.BMQSimEngine(jc, repro.EngineConfig(
        local_bits=4, devices=_jdevs(8)))
    teng = repro_torch.core.engine.BMQSimEngine(
        _carried(jc), repro_torch.EngineConfig(local_bits=4,
                                               devices=[CPU] * 8))
    try:
        js, ts = np.asarray(jeng.run()), teng.run()
        assert teng.stats.n_exchanged_blocks == jeng.stats.n_exchanged_blocks
        assert teng.compile().n_devices == 8
    finally:
        jeng.close()
        teng.close()
    assert abs(float(np.linalg.norm(ts)) - 1.0) < 5e-3
    assert _direction(js, ts) >= REPRO_FID


# -- lane sharding ----------------------------------------------------------------

@pytest.mark.parametrize("codec", CODECS)
def test_lane_sharded_batch_bitwise_equals_single(codec):
    """run_batch over 3 slots: each takes a contiguous lane slice against
    its own store keys, so every lane is bit for bit the one-slot batch's
    and nothing is exchanged; counters equal repro's sharded run, lanes
    in direction."""
    jc = repro.build_circuit("qft", 7)
    js, ts = _sims(jc, 3, local_bits=4, codec_backend=codec)
    with js, ts, repro_torch.Simulator(_carried(jc), repro_torch.EngineConfig(
            local_bits=4, codec_backend=codec, devices=[CPU])) as one:
        ref = [lane.statevector() for lane in one.run_batch([None] * 6)]
        got = [lane.statevector() for lane in ts.run_batch([None] * 6)]
        jgot = [lane.statevector() for lane in js.run_batch([None] * 6)]
        _same_counters(js, ts)
        assert ts.stats.exchange_bytes == ts.stats.n_exchanged_blocks == 0
        assert ts.stats.per_stage_exchange_bytes == \
            js.stats.per_stage_exchange_bytes
    for r, s, j in zip(ref, got, jgot):
        assert np.array_equal(r, s)
        assert _direction(j, s) >= REPRO_FID


def test_lane_shards_of_one_device_run_the_one_device_waves(monkeypatch):
    """Slots that repeat one device hold every lane on it: the engine
    merges their shards, so a lane-sharded batch on ``[cpu] * 3`` cuts
    each stage into the one-slot run's wave items, keys, device and
    operands alike (on a card: the same launches).  Shards of distinct
    devices merge per device, by equality."""
    from repro_torch.core import engine as E
    from repro_torch.core.pipeline import StagePipeline
    meta = torch.device("meta")
    got = E._lanes_by_device(tlanes.make_lane_shards([CPU, meta, CPU], 8))
    assert [(d, ix.tolist()) for d, ix in got] == [
        (CPU, [0, 1, 2, 6, 7]), (meta, [3, 4, 5])]
    assert E._lanes_by_device(tlanes.make_lane_shards([CPU] * 3, 8)) is None
    wave_items, seen = StagePipeline._wave_items, []

    def recording(self, *a, **kw):
        items = wave_items(self, *a, **kw)
        seen[-1].append(items)
        return items
    monkeypatch.setattr(StagePipeline, "_wave_items", recording)
    circuit = repro_torch.build_circuit("qft", 7)
    for d in (1, 3):
        seen.append([])
        with repro_torch.Simulator(circuit, repro_torch.EngineConfig(
                local_bits=4, devices=[CPU] * d)) as sim:
            sim.run_batch([None] * 5)
    assert len(seen[0]) == len(seen[1]) > 0
    for one, three in zip(*seen):
        assert len(one) == len(three)
        for (k1, d1, m1), (k3, d3, m3) in zip(one, three):
            assert d1 == d3 == CPU
            np.testing.assert_array_equal(k1, k3)
            assert all(torch.equal(a, b) for a, b in zip(m1, m3))


def test_lane_sharded_trajectories_bitwise_equal_single():
    """Noise trajectories, a ragged split (5 over 2 slots): each lane's
    state bit for bit the one-slot run's, each equal in direction to
    repro's lane of the same draw; exchange 0."""
    jc = repro.with_depolarizing(repro.build_circuit("qft", 7), 0.05)
    js, ts = _sims(jc, 2, local_bits=4)
    with js, ts, repro_torch.Simulator(_carried(jc), repro_torch.EngineConfig(
            local_bits=4, devices=[CPU])) as one:
        ref = [lane.statevector() for lane in one.run(trajectories=5,
                                                      seed=3)]
        got = [lane.statevector() for lane in ts.run(trajectories=5,
                                                     seed=3)]
        jgot = [lane.statevector() for lane in js.run(trajectories=5,
                                                      seed=3)]
        _same_counters(js, ts)
        assert ts.stats.exchange_bytes == 0
    for r, s, j in zip(ref, got, jgot):
        assert np.array_equal(r, s)
        assert _direction(j, s) >= REPRO_FID


def test_plan_check_ragged_lanes_warning_equals_repros():
    """The verifier's placement warning for a batch the devices do not
    divide, word for word as repro's; none where they do."""
    from repro.analysis.plan_check import verify_plan as jverify
    from repro_torch.analysis.plan_check import verify_plan as tverify
    jc = repro.build_circuit("qft", 8)
    for d, batch in ((3, 8), (4, 8)):
        js, ts = _sims(jc, d, local_bits=4, batch=batch)
        with js, ts:
            jf = [f.render() for f in jverify(js.compile(verify=False), jc)
                  if f.code == "placement"]
            tf = [f.render() for f in tverify(ts.compile(verify=False),
                                              ts.circuit)
                  if f.code == "placement"]
        assert tf == jf
        assert len(tf) == (1 if batch % d else 0)


# -- the sharded dense baseline ----------------------------------------------------

@pytest.mark.parametrize("name,n", [("ghz_state", 8), ("qft", 10),
                                    ("qaoa", 9), ("qsvm", 8)])
@pytest.mark.parametrize("d", [2, 4, 8])
def test_dense_sharded_baseline_matches_both_dense_engines(name, n, d):
    """simulate_dense_sharded over d slots, exchanges where a gate touches
    a sharded qubit, against the port's and repro's simulate_dense within
    atol 1e-6 (repro's own simulate_dense_sharded test fails and is no
    oracle)."""
    jc = repro.build_circuit(name, n)
    slices = simulate_dense_sharded(_carried(jc), [CPU] * d)
    assert len(slices) == d and all(s.shape == (2 ** n // d,)
                                    for s in slices)
    got = torch.cat(slices).numpy()
    np.testing.assert_allclose(got, t_dense(_carried(jc),
                                            device=CPU).numpy(), atol=1e-6)
    np.testing.assert_allclose(got, np.asarray(repro.simulate_dense(jc)),
                               atol=1e-6)


def test_dense_sharded_needs_a_power_of_two_of_devices():
    tc = repro_torch.build_circuit("ghz_state", 3)
    for d in (0, 3, 16):
        with pytest.raises(ValueError, match="do not divide"):
            simulate_dense_sharded(tc, [CPU] * d)


def test_qsim_devices_cli_on_the_cpu(capsys):
    """``qsim --devices 4 --device cpu`` on a batch: lane-sharded, its
    lines those of a one-slot batch with the slots line and repro's
    exchange line (0 hand-offs) added."""
    from repro_torch.launch import qsim as tqsim
    argv = ["--circuit", "qft", "--qubits", "8", "--batch", "4",
            "--device", "cpu", "--expect", "zsum"]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert tqsim.main(argv + ["--devices", "4"]) == 0
        four = capsys.readouterr().out
        assert tqsim.main(argv) == 0
        one = capsys.readouterr().out
    assert "[qsim] 4 device slots on 1 physical device(s): cpu" in four
    assert ("[qsim] device exchange (4 devices): 0.00 MiB encoded wire "
            "over 0 block hand-off(s)") in four

    def lines(out, prefixes):
        return [ln for ln in out.splitlines() if ln.startswith(prefixes)]
    keep = ("[qsim] batched run", "[qsim] qft n=8", "[qsim] group",
            "[qsim] boundary", "[qsim] <sum Z_i>")
    assert lines(four, keep) == lines(one, keep)
