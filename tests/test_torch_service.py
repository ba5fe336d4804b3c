"""SimService in the port: tests/test_service.py's scenarios on
repro_torch.core.service (sessions on the CPU, the kernels' plain
versions), each beside repro's SimService on the same circuits, budget
and config, for the host and the device codec.

The scheduler is framework-free, so its decisions must be repro's
exactly: job states, admission prices, the stats line, merge widths,
virtual-clock waits and latencies.  Merged lanes must equal the same job
run solo bit for bit (every dispatch goes through run_batch, width 1
included); readouts agree with repro's within 1e-3 (expectations) and
fidelity of directions >= 0.999999 (states), the suite's thresholds for
one circuit through two codec paths.
"""
import re

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.core.fidelity import fidelity, norm
from repro_torch.core.planner import peak_ram_for
from repro_torch.errors import StoreIOError

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


CODECS = ["host", "device"]


def _cfg(pkg, codec="host", **kw):
    cpu = {"devices": [CPU]} if pkg is repro_torch else {}
    return pkg.EngineConfig(local_bits=4, codec_backend=codec, **cpu, **kw)


def peak1(pkg, circuit, codec="host") -> int:
    with pkg.Simulator(circuit, _cfg(pkg, codec)) as sim:
        return peak_ram_for(sim.compile(), 1)


def _direction(a, b):
    return fidelity(a, b) / (norm(a) * norm(b))


def _record(svc, jobs):
    """What the scheduler decided, framework-free (under a virtual clock,
    so the waits are exact)."""
    return ([(j.job_id, j.state, j.merge_width, j.cold, j.peak_ram_bytes,
              j.wait_s, j.latency_s is not None) for j in jobs],
            svc.stats.summary(), list(svc.stats.merge_widths))


@pytest.mark.parametrize("codec", CODECS)
def test_admission_decision_table(codec):
    """budget = 2x peak: two admit, two queue, the queue drains in
    arrival order — in both packages alike."""
    recs = []
    for pkg in (repro, repro_torch):
        qc = pkg.build_circuit("qft", 8)
        p1 = peak1(pkg, qc, codec)
        with pkg.SimService(2 * p1, config=_cfg(pkg, codec),
                            clock=pkg.VirtualClock()) as svc:
            jobs = [svc.submit(qc) for _ in range(4)]
            assert [j.state for j in jobs] == ["admitted", "admitted",
                                              "queued", "queued"]
            assert svc.reserved_bytes == 2 * p1
            done = svc.drain()
            assert [j.job_id for j in done] == [0, 1, 2, 3]
            assert svc.reserved_bytes == 0
            s = svc.stats
            assert (s.n_submitted, s.n_admitted, s.n_queued,
                    s.n_rejected) == (4, 2, 2, 0)
            assert (s.n_cold_compiles, s.n_warm_hits) == (1, 3)
            assert s.peak_reserved_bytes == 2 * p1
            recs.append((p1, _record(svc, jobs)))
    assert recs[1] == recs[0]


def test_rejection_only_when_never_fits():
    qc = repro_torch.build_circuit("qft", 8)
    p1 = peak1(repro_torch, qc)
    assert p1 == peak1(repro, repro.build_circuit("qft", 8))
    with repro_torch.SimService(p1 - 1, config=_cfg(repro_torch)) as svc:
        job = svc.submit(qc)
        assert job.state == "rejected" and job.done
        assert svc.drain() == []
        assert svc.stats.n_rejected == 1 and svc.stats.n_completed == 0
    with repro_torch.SimService(p1, config=_cfg(repro_torch)) as svc:
        job = svc.submit(qc)
        assert job.state == "admitted"
        svc.drain()
        assert job.state == "done"


def test_admission_sum_never_exceeds_budget():
    recs = []
    for pkg in (repro, repro_torch):
        circuits = [pkg.build_circuit("qft", 8),
                    pkg.build_circuit("ising", 8),
                    pkg.build_circuit("ghz_state", 8)]
        prices = [peak1(pkg, qc) for qc in circuits]
        budget = max(prices) + min(prices)
        with pkg.SimService(budget, config=_cfg(pkg),
                            clock=pkg.VirtualClock()) as svc:
            jobs = []
            for _ in range(3):
                for qc in circuits:
                    jobs.append(svc.submit(qc))
                    assert svc.reserved_bytes <= budget
            while True:
                done = svc.step()
                assert svc.reserved_bytes <= budget
                if not done:
                    break
            assert all(j.state == "done" for j in jobs)
            assert svc.stats.peak_reserved_bytes <= budget
            assert svc.stats.n_queued > 0
            recs.append(_record(svc, jobs))
    assert recs[1] == recs[0]


def test_fifo_within_structure_class():
    qc = repro_torch.build_circuit("qft", 8)
    with repro_torch.SimService(peak1(repro_torch, qc),
                                config=_cfg(repro_torch)) as svc:
        jobs = [svc.submit(qc, seed=i) for i in range(3)]
        done = svc.drain()
        assert [j.job_id for j in done] == [0, 1, 2]
        assert all(j.merge_width == 1 for j in jobs)
        assert svc.stats.merge_widths == [1, 1, 1]
        assert svc.stats.n_merged_jobs == 0


POINTS = [{"gamma0": g, "beta0": b}
          for g, b in [(0.3, 0.15), (0.7, 0.40), (1.1, 0.65)]]


def _statevector(view):
    return np.asarray(view.statevector())


@pytest.mark.parametrize("codec", CODECS)
def test_merge_bitwise_equal_vs_solo(codec):
    """Three co-admitted qaoa_template(8) jobs merge into one width-3
    run_batch whose lanes equal each job run solo bit for bit; each lane
    also agrees with repro's merged lane."""
    qc = repro_torch.qaoa_template(8)
    grab = {"readout": _statevector}
    with repro_torch.SimService(64 << 20, config=_cfg(repro_torch,
                                                      codec)) as svc:
        merged = [svc.submit(qc, params=p, **grab) for p in POINTS]
        svc.drain()
    assert all(j.merge_width == 3 for j in merged)
    assert svc.stats.n_batches == 1 and svc.stats.max_merge_width == 3
    jqc = repro.qaoa_template(8)
    with repro.SimService(64 << 20, config=_cfg(repro, codec)) as jsvc:
        jmerged = [jsvc.submit(jqc, params=p, **grab) for p in POINTS]
        jsvc.drain()
    assert jsvc.stats.summary() == svc.stats.summary()
    for p, mj, jj in zip(POINTS, merged, jmerged):
        with repro_torch.SimService(64 << 20, config=_cfg(
                repro_torch, codec)) as solo_svc:
            sj = solo_svc.submit(qc, params=p, **grab)
            solo_svc.drain()
        assert sj.merge_width == 1
        assert np.array_equal(mj.result["readout"], sj.result["readout"])
        assert _direction(jj.result["readout"],
                          mj.result["readout"]) >= 0.999999


@pytest.mark.parametrize("codec", CODECS)
def test_noisy_jobs_merge_as_seeded_trajectory_lanes(codec):
    """Stochastic jobs run as trajectory lanes seeded by job.seed: the
    merged readouts agree with repro's lane for lane."""
    results = []
    for pkg in (repro, repro_torch):
        qc = pkg.with_depolarizing(pkg.build_circuit("ghz_state", 6), 0.1)
        with pkg.SimService(64 << 20, config=_cfg(pkg, codec)) as svc:
            jobs = [svc.submit(qc, seed=s, shots=64,
                               observable=pkg.zsum_cost_fn(6))
                    for s in (3, 4, 5)]
            svc.drain()
        assert [j.merge_width for j in jobs] == [3, 3, 3]
        results.append([(j.result["expectation"],
                         sum(j.result["counts"].values())) for j in jobs])
    for (je, jn), (te, tn) in zip(*results):
        assert abs(je - te) <= 1e-3 and jn == tn == 64


def test_different_structures_never_merge():
    qft = repro_torch.build_circuit("qft", 8)
    ising = repro_torch.build_circuit("ising", 8)
    with repro_torch.SimService(64 << 20, config=_cfg(repro_torch)) as svc:
        jobs = [svc.submit(qc) for qc in (qft, ising, qft, ising)]
        svc.drain()
        assert svc.stats.n_batches == 2
        assert sorted(svc.stats.merge_widths) == [2, 2]
        assert jobs[0].structure == jobs[2].structure
        assert jobs[0].structure != jobs[1].structure
    assert jobs[0].structure == repro.core.circuit_fingerprint(
        repro.build_circuit("qft", 8))


def test_session_pool_cold_warm_and_lru_eviction():
    qft = repro_torch.build_circuit("qft", 8)
    ising = repro_torch.build_circuit("ising", 8)
    with repro_torch.SimService(64 << 20, config=_cfg(repro_torch),
                                max_sessions=1) as svc:
        svc.submit(qft)
        svc.drain()
        assert (svc.stats.n_cold_compiles, svc.n_sessions) == (1, 1)
        svc.submit(ising)
        svc.drain()
        assert svc.stats.n_sessions_evicted == 1 and svc.n_sessions == 1
        job = svc.submit(qft)
        svc.drain()
        assert job.cold and svc.stats.n_cold_compiles == 3


def test_pending_sessions_are_not_evicted():
    qft = repro_torch.build_circuit("qft", 8)
    ising = repro_torch.build_circuit("ising", 8)
    with repro_torch.SimService(64 << 20, config=_cfg(repro_torch),
                                max_sessions=1) as svc:
        j1 = svc.submit(qft)
        svc.submit(ising)
        assert svc.n_sessions == 2
        svc.drain()
        assert j1.state == "done"


def test_virtual_clock_exact_waits_and_latencies():
    qc = repro_torch.build_circuit("qft", 8)
    clock = repro_torch.VirtualClock()
    with repro_torch.SimService(peak1(repro_torch, qc),
                                config=_cfg(repro_torch),
                                clock=clock) as svc:
        first, second = svc.submit(qc), svc.submit(qc)
        assert (first.state, second.state) == ("admitted", "queued")
        clock.advance(2.0)
        assert svc.step() == [first]
        assert first.wait_s == 0.0 and first.latency_s == 2.0
        assert second.wait_s == 2.0
        clock.advance(1.5)
        assert svc.step() == [second]
        assert second.latency_s == 3.5
    with pytest.raises(ValueError):
        clock.advance(-1.0)


def test_typed_engine_failure_fails_batch_and_keeps_serving():
    qc = repro_torch.build_circuit("qft", 8)
    with repro_torch.SimService(64 << 20, config=_cfg(repro_torch)) as svc:
        job = svc.submit(qc)
        sess = svc._sessions[job.structure]

        def boom(*a, **k):
            raise StoreIOError("read", key=7)

        sess.sim.run_batch = boom
        assert svc.step() == [job]
        assert job.state == "failed" and "StoreIOError" in job.error
        assert svc.reserved_bytes == 0 and svc.stats.n_failed == 1
        ok = svc.submit(repro_torch.build_circuit("ising", 8))
        svc.drain()
        assert ok.state == "done"


def test_submit_after_close_raises():
    svc = repro_torch.SimService(64 << 20, config=_cfg(repro_torch))
    svc.close()
    with pytest.raises(RuntimeError):
        svc.submit(repro_torch.build_circuit("qft", 8))


def test_stats_summary_is_the_documented_line():
    qc = repro_torch.build_circuit("qft", 8)
    with repro_torch.SimService(64 << 20, config=_cfg(repro_torch)) as svc:
        svc.submit(qc)
        svc.submit(qc)
        svc.drain()
        line = svc.stats.summary()
    assert re.fullmatch(
        r"submitted=2 admitted=2 queued=0 rejected=0 completed=2 failed=0 "
        r"cold=1 warm=1 batches=1 merged=2 max_merge=2 "
        r"peak_reserved_mib=\d+\.\d\d", line)


def test_service_sessions_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with repro_torch.SimService(64 << 20) as svc:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            svc.submit(repro_torch.build_circuit("qft", 8))


def test_serve_cli_on_the_cpu(capsys):
    from repro.launch import serve as jserve
    from repro_torch.launch import serve as tserve
    argv = ["--jobs", "qft:8x3,ising:8x2", "--memory-budget", "8",
            "--shots", "16", "--block-bits", "4"]
    assert tserve.main(argv + ["--device", "cpu"]) == 0
    tout = capsys.readouterr().out
    assert jserve.main(argv) == 0
    jout = capsys.readouterr().out

    def decisions(out):
        return [re.sub(r"(wait|latency) \S+", "", ln)
                for ln in out.splitlines()
                if "top counts" not in ln]
    assert decisions(tout) == decisions(jout)
    assert "round 1: qft-8 x3 lane(s) merged into one run_batch" in tout


@pytest.mark.cuda
def test_merged_lane_equals_its_solo_run_on_the_card():
    """On the card too, a merged lane is bit for bit the job run solo:
    the ring body and the codec kernels compute every row alike whatever
    the row count."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU form")
    qc = repro_torch.qaoa_template(10)
    cfg = repro_torch.EngineConfig(local_bits=6, codec_backend="device")
    grab = {"readout": _statevector}
    with repro_torch.SimService(1 << 30, config=cfg) as svc:
        merged = [svc.submit(qc, params=p, **grab) for p in POINTS]
        svc.drain()
    assert [j.merge_width for j in merged] == [3, 3, 3]
    for p, mj in zip(POINTS, merged):
        with repro_torch.SimService(1 << 30, config=cfg) as solo:
            sj = solo.submit(qc, params=p, **grab)
            solo.drain()
        assert sj.merge_width == 1
        assert np.array_equal(mj.result["readout"], sj.result["readout"])
