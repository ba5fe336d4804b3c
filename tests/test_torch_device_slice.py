"""The device-codec slice as a whole: Simulator(circuit,
EngineConfig(codec_backend="device")).run() in the port (on the CPU, the
codec kernels' plain versions) against the JAX package's device-codec run
(Pallas in interpret mode), against the port's own host-codec run, and
against the dense oracle.

Tolerances: fidelity >= 0.999999 against repro's device-codec run (the
suite's threshold for two codec backends on one circuit) and >= 0.99
against the dense oracle.  Byte and block counters are framework-free and
must be equal to repro's; the device codec must move strictly fewer
boundary bytes than the host codec, stage by stage.
"""
import warnings

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
COUNTERS = ("h2d_bytes", "d2h_bytes", "n_block_compressions",
            "n_block_decompressions", "n_stages")


def _carried(jc):
    return circuit_from_gates(
        jc.n_qubits, [(g.name, g.qubits, g.matrix, g.params)
                      for g in jc.gates])


def _port(tc, **kw):
    return repro_torch.simulate_bmqsim(
        tc, repro_torch.EngineConfig(devices=[CPU], **kw))


def _dense_fidelity(tc, state):
    return repro_torch.fidelity(t_dense(tc, device=CPU),
                                torch.from_numpy(state))


@pytest.mark.parametrize("name", ["qft", "ghz_state"])
def test_device_codec_run_matches_repro_and_the_host_codec(name):
    jc = repro.build_circuit(name, 10)
    tc = _carried(jc)
    js, jst = repro.simulate_bmqsim(
        jc, repro.EngineConfig(local_bits=6, codec_backend="device"))
    ts, tst = _port(tc, local_bits=6, codec_backend="device")
    hs, hst = _port(tc, local_bits=6, codec_backend="host")
    assert ts.dtype == np.complex64 and np.isfinite(ts).all()
    assert repro_torch.fidelity(js, ts) >= 0.999999
    assert repro_torch.fidelity(hs, ts) >= 0.999999
    assert _dense_fidelity(tc, ts) >= 0.99
    for f in COUNTERS:
        assert getattr(tst, f) == getattr(jst, f), f
    assert tst.per_stage_boundary_bytes == jst.per_stage_boundary_bytes
    assert tst.h2d_bytes < hst.h2d_bytes and tst.d2h_bytes < hst.d2h_bytes
    for (h2d_d, d2h_d), (h2d_h, d2h_h) in zip(
            tst.per_stage_boundary_bytes, hst.per_stage_boundary_bytes):
        assert h2d_d < h2d_h and d2h_d < d2h_h


@pytest.mark.parametrize("budget", [None, 1 << 16])
@pytest.mark.parametrize("name", ["qft", "qsvm", "ghz_state"])
def test_device_codec_plan_json_equals_repro(name, budget):
    """The planner prices the device wire (~4.25 B/amplitude) in both
    packages alike: the compiled plans are equal, predictions included."""
    jc, tc = repro.build_circuit(name, 12), repro_torch.build_circuit(name, 12)
    with repro.Simulator(jc, repro.EngineConfig(
            codec_backend="device", memory_budget_bytes=budget)) as js, \
            repro_torch.Simulator(tc, repro_torch.EngineConfig(
                codec_backend="device", memory_budget_bytes=budget,
                devices=[CPU])) as ts:
        jplan, tplan = js.compile(), ts.compile()
    assert tplan.codec_backend == "device"
    assert jplan.to_json() == tplan.to_json()


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_device_codec_with_pipeline_depth_and_spill(depth, tmp_path):
    """Mirrors tests/test_pipeline.py::test_device_backend_with_pipeline_
    depth_and_spill: a 512-byte RAM budget forces the disk tier."""
    tc = repro_torch.build_circuit("qft", 9)
    state, stats = _port(tc, local_bits=5, codec_backend="device",
                         pipeline_depth=depth, ram_budget_bytes=512,
                         spill_dir=str(tmp_path))
    assert _dense_fidelity(tc, state) >= 0.99
    assert stats.n_spills > 0                # disk tier exercised


def _direction(a, b):
    """Fidelity of two states' directions (the lossy codec lets a deep
    circuit's norm drift by ~1e-4, in both packages alike)."""
    return repro_torch.fidelity(a, b) / (norm(a) * norm(b))


def test_raw_escape_blocks_cross_raw_and_decode_in_place():
    """At 16-amplitude blocks a random state's blocks are incompressible:
    they take the RAW escape on encode and cross as raw complex64 on the
    next decode, beside the wire blocks of the same wave."""
    jc = repro.random_circuit(7, 24, seed=3)
    tc = _carried(jc)
    cfg = dict(local_bits=4, pipeline_depth=4)
    ts, tst = _port(tc, codec_backend="device", **cfg)
    js, jst = repro.simulate_bmqsim(
        jc, repro.EngineConfig(codec_backend="device", **cfg))
    hs, hst = _port(tc, codec_backend="host", **cfg)
    assert _dense_fidelity(tc, ts) >= 0.99
    assert _direction(js, ts) >= 0.999999
    assert _direction(hs, ts) >= 0.999999
    for f in COUNTERS:
        assert getattr(tst, f) == getattr(jst, f), f
    assert tst.per_stage_boundary_bytes == jst.per_stage_boundary_bytes
    # some blocks crossed raw: more than pure wire, less than all raw
    wire_only = tst.n_block_decompressions * 2 * (2 * 16 + 4 + 4)
    assert wire_only < tst.h2d_bytes < hst.h2d_bytes


def test_device_codec_without_compression_falls_back_with_a_warning():
    """Mirrors tests/test_pipeline.py::test_device_backend_falls_back_
    without_compression."""
    tc = repro_torch.build_circuit("ghz_state", 8)
    with pytest.warns(RuntimeWarning, match="falling back to the host"):
        state, _ = _port(tc, local_bits=5, compression=False,
                         codec_backend="device")
    assert _dense_fidelity(tc, state) >= 0.999999


def test_device_codec_with_compression_does_not_warn():
    tc = repro_torch.build_circuit("ghz_state", 8)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        state, _ = _port(tc, local_bits=5, codec_backend="device")
    assert not [w for w in caught
                if "falling back to the host" in str(w.message)]
    assert _dense_fidelity(tc, state) >= 0.99


def test_device_codec_result_reads_out_like_repro():
    jc = repro.build_circuit("qft", 10)
    tc = _carried(jc)
    with repro.Simulator(jc, repro.EngineConfig(
            local_bits=6, codec_backend="device")) as js, \
            repro_torch.Simulator(tc, repro_torch.EngineConfig(
                local_bits=6, codec_backend="device",
                devices=[CPU])) as ts:
        je = js.run().expectation(repro.zsum_cost_fn(10))
        tr = ts.run()
        te = tr.expectation(repro_torch.zsum_cost_fn(10))
        assert sum(tr.sample(256, seed=0).values()) == 256
        assert ts.compile().codec_backend == "device"
    assert abs(je - te) <= 1e-3


def test_device_codec_without_a_card_raises_unless_the_cpu_was_asked_for(
        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tc = repro_torch.build_circuit("ghz_state", 6)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        repro_torch.simulate_bmqsim(
            tc, repro_torch.EngineConfig(codec_backend="device"))
    state, _ = _port(tc, codec_backend="device")
    assert _dense_fidelity(tc, state) >= 0.99
