"""Guards of the port: it imports neither JAX nor the JAX package, nothing
falls back silently (no GPU), placements it cannot run raise, and the
interop helpers carry circuits and arrays across."""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch import EngineConfig, Simulator, build_circuit
from repro_torch.core.dense_engine import simulate_dense
from repro_torch.interop import circuit_from_gates, to_device

ROOT = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
FORBIDDEN = {"jax", "jaxlib", "repro"}


def _port_sources():
    return sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
        sorted((ROOT / "examples").glob("*_torch.py")) + \
        [ROOT / "chip_smoke.py", ROOT / "chip_tiles.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(encoding="utf-8"), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, (node.module or "").split(".")[0]


def test_port_imports_neither_jax_nor_the_jax_package():
    sources = _port_sources()
    assert len(sources) > 20
    bad = [f"{p.relative_to(ROOT)}:{line} imports {root}"
           for p in sources for line, root in _imported_roots(p)
           if root in FORBIDDEN]
    assert bad == []


def _cpu_sim(circuit, **kw):
    return Simulator(circuit, EngineConfig(devices=[CPU], **kw))


@pytest.fixture
def fake_card(monkeypatch):
    """A process that reports one CUDA card (none is touched)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)


@pytest.mark.parametrize("kw,item", [
    ({"mesh_shape": 2}, "A10"),
    ({"devices": [CPU, CPU]}, "A10"),
    ({"devices": [torch.device("cuda", 0), CPU]}, "one platform"),
    ({"mesh_shape": (2, 2)}, "1-D"),
])
def test_unported_placements_and_paths_raise(kw, item, fake_card,
                                             monkeypatch):
    """The name is kept from when these placements raised: A10 ported
    ``mesh_shape=2`` and ``[cpu, cpu]``, which now construct and run two
    block-sharded slots equal to repro's ``[jax.devices()[0]] * 2`` (the
    visible devices stand in as two CPU slots for ``mesh_shape``).  A list
    that mixes a card and the CPU, and a 2-D mesh_shape, raise
    ``ValueError`` before any device is touched."""
    from repro_torch.distributed import lanes
    circuit = build_circuit("ghz_state", 6)
    if item != "A10":
        with pytest.raises(ValueError, match=item):
            Simulator(circuit, EngineConfig(**kw))
        return
    repro = pytest.importorskip("repro")
    jax = pytest.importorskip("jax")
    monkeypatch.setattr(lanes, "visible_devices", lambda: [CPU, CPU])
    with Simulator(circuit, EngineConfig(local_bits=3, **kw)) as sim:
        assert sim._engine._devices == [CPU, CPU]
        got = sim.run().statevector()
        st = sim.stats
    jc = repro.build_circuit("ghz_state", 6)
    with repro.Simulator(jc, repro.EngineConfig(
            local_bits=3, devices=[jax.devices()[0]] * 2)) as jsim:
        want = jsim.run().statevector()
        jst = jsim.stats
    assert st.n_exchanged_blocks == jst.n_exchanged_blocks > 0
    assert st.per_stage_exchange_bytes == jst.per_stage_exchange_bytes
    assert (st.h2d_bytes, st.d2h_bytes) == (jst.h2d_bytes, jst.d2h_bytes)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_missing_gpu_raises_unless_the_cpu_was_asked_for(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    circuit = build_circuit("ghz_state", 6)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Simulator(circuit, EngineConfig()).run()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        simulate_dense(circuit)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        to_device(np.zeros(4, np.float32))
    with _cpu_sim(circuit) as sim:           # the CPU, asked for, runs
        state = sim.run().statevector()
    assert abs(abs(state[0]) ** 2 - 0.5) < 1e-3


def _model_entry_points(ckpt_dir):
    """The model builders exported by name, each as fn(device=...), and
    the training entry points that put tensors on a device: the
    launcher's set-up (its ``--device``) and a checkpoint's restore."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.launch import train as launch_train
    from repro_torch.models import attention, layers, mlp
    from repro_torch.train.checkpoint import CheckpointManager
    cfg = reduced_config(get_config("qwen3-4b"))
    mgr = CheckpointManager(str(ckpt_dir))
    mgr.save(0, {"w": torch.ones(3)})

    def launch(device=None):
        argv = ["--steps", "1"] + ([] if device is None
                                   else ["--device", str(device)])
        return launch_train.setup(argv)[1]["embed"]
    return {
        "launch_train": launch,
        "checkpoint_restore": lambda device=None: mgr.restore(
            {"w": torch.zeros(3)}, device=device)[0]["w"],
        "init_cache": lambda device=None: attention.init_cache(
            cfg, 2, 16, 2, device=device)["k"],
        "init_attn_params": lambda device=None: attention.init_attn_params(
            None, cfg, device=device)["wq"],
        "init_mlp_params": lambda device=None: mlp.init_mlp_params(
            None, 64, 128, "silu", device=device)["w_in"],
        "dense_init": lambda device=None: layers.dense_init(
            None, (8, 4), device=device),
    }


@pytest.mark.parametrize("name", ["init_cache", "init_attn_params",
                                  "init_mlp_params", "dense_init",
                                  "launch_train", "checkpoint_restore"])
def test_model_entry_points_default_to_the_card(monkeypatch, tmp_path,
                                                name):
    fn = _model_entry_points(tmp_path)[name]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fn()
    assert fn(device=CPU).device == CPU       # the CPU, asked for, builds
    assert fn(device="meta").device.type == "meta"


def test_stage_pipeline_defaults_to_the_card(monkeypatch):
    from repro_torch.compression import BlockStore, PwRelParams
    from repro_torch.core import HostCodecBackend, StagePipeline
    backend = HostCodecBackend(BlockStore(), PwRelParams(1e-3), 1 << 8)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StagePipeline(backend)
    assert StagePipeline(backend, devices=[CPU]).devices == [CPU]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert StagePipeline(backend).devices == [torch.device("cuda", 0)]


@pytest.mark.cuda
def test_cuda_run_goes_through_the_kernel_and_matches_the_cpu_run():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU form")
    from repro_torch.kernels import gate_apply

    circuit = build_circuit("qft", 12)
    with _cpu_sim(circuit) as sim:
        want = sim.run().statevector()
    gate_apply.reset_launch_counts()
    with Simulator(circuit, EngineConfig()) as sim:
        assert sim._engine.device == torch.device("cuda", 0)
        assert sim.compile().interpret is False
        got = sim.run().statevector()
    assert gate_apply.launch_counts["gemm_planes_batch"] > 0
    assert repro_torch.fidelity(want, got) >= 0.9999


def _run_smoke(cwd: Path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""         # no card, even where there is one
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_chip_smoke_fails_without_a_gpu_or_alone(tmp_path):
    for cwd in (ROOT, tmp_path):
        if cwd is tmp_path:
            shutil.copy(ROOT / "chip_smoke.py", tmp_path)
        out = _run_smoke(cwd)
        assert out.returncode != 0, out.stdout
        assert '"ok": true' not in out.stdout
        assert "FAILED" in out.stderr


def test_interop_carries_circuits_across():
    pytest.importorskip("jax")
    import repro as jax_pkg
    from repro.core.plan import circuit_fingerprint as jfp

    from repro_torch.core.plan import circuit_fingerprint as tfp

    for jc in (jax_pkg.random_circuit(7, 40, seed=3),
               jax_pkg.qaoa_template(6, layers=2),
               jax_pkg.with_depolarizing(jax_pkg.build_circuit("qft", 5),
                                         0.01)):
        gates = [(g.name, g.qubits, g.matrix, g.params) for g in jc.gates]
        tc = circuit_from_gates(jc.n_qubits, gates)
        assert tfp(tc) == jfp(jc)
        assert tc.free_parameters == jc.free_parameters
        assert tc.is_stochastic == jc.is_stochastic
        for g1, g2 in zip(jc.gates, tc.gates):
            if g1.matrix is not None:
                np.testing.assert_array_equal(g1.matrix, g2.matrix)


def test_interop_moves_numpy_onto_the_device():
    rng = np.random.default_rng(0)
    planes = rng.standard_normal((2, 2, 16))
    mats = [rng.standard_normal((2, 4, 4)), rng.standard_normal((2, 2))]
    tp, tm = to_device((planes, mats), CPU, torch.float32)
    assert isinstance(tm, list) and tp.dtype == torch.float32
    np.testing.assert_array_equal(tp.numpy(), planes.astype(np.float32))
    np.testing.assert_array_equal(tm[1].numpy(), mats[1].astype(np.float32))
    state = to_device(np.zeros(8, np.complex64), CPU)
    assert state.dtype == torch.complex64 and state.device == CPU


def test_public_names_are_those_of_the_jax_package():
    pytest.importorskip("jax")
    import repro as jax_pkg

    assert set(repro_torch.__all__) <= set(jax_pkg.__all__)
