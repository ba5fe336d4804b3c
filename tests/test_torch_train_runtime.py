"""Checkpoints, the fault-tolerant runtime, the data sources and whole
train steps of the port (ROADMAP A12f) against the JAX package.

The checkpoint container is a framework-free artifact, so it is held
equal: the same ``manifest.json`` and byte-identical ``.bin`` files for
the same tree, raw and zlib-compressed, and a checkpoint written by either
package restores in the other.  ``tests/test_checkpoint.py``'s scenarios
run on the port with the same assertions (its elastic re-shard becomes a
restore onto another device: the CPU again, and ``meta``).

Three full train steps of reduced qwen3-4b in f32 (AdamW, with and without
gradient compression) are held against ``repro``'s jitted step: the loss
and the gradient norm of each step within 1e-5 relative; the moments
within 1e-5 of each leaf's max (measured on a CPU container over seeds
0-5: 4.1e-6).  The parameters are held at 5e-4 of each leaf's max
(measured 5.7e-6 to 1.2e-4): the gradients agree to about 1e-6 of a
leaf's max (``tests/test_torch_train_step.py``), and AdamW divides each
element's first moment by the root of its own second moment, so on an
element whose gradient is some 200 times below its leaf's max that
difference becomes 1e-4 of the element's update (ROADMAP C).  With
compression a pwrel code at a rounding tie moves an element by a code
step, so that run is held by its loss and gradient norm."""
import json
import os
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.interop import lm_params_from_numpy, train_state_from_numpy
from repro_torch.models import transformer as T
from repro_torch.optim import AdamW, GradCompressor
from repro_torch.optim.adamw import tree_map
from repro_torch.train.checkpoint import CheckpointManager, flatten
from repro_torch.train.data import FileTokens, SyntheticTokens
from repro_torch.train.runtime import RuntimeConfig, TrainRuntime
from repro_torch.train.step import init_train_state, make_train_step

CPU = torch.device("cpu")
STEP_RTOL = 1e-5               # loss, gradient norm, moments
PARAM_RTOL = 5e-4              # parameters after AdamW (see the docstring)


@pytest.fixture(scope="module")
def J():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro import optim
    from repro.configs import get_config as jget
    from repro.configs import reduced_config as jreduced
    from repro.models import transformer as JT
    from repro.train import checkpoint as JC
    from repro.train import data as JD
    from repro.train import step as JS
    return types.SimpleNamespace(jax=jax, jnp=jnp, optim=optim, get=jget,
                                 reduced=jreduced, T=JT, C=JC, D=JD, S=JS)


def _jax_train_tree(J, dt="bfloat16", compress=False):
    """``repro``'s (params, train state) of reduced qwen3-4b in ``dt``,
    AdamW with bf16 moments, a step count of 5."""
    cfg = J.reduced(J.get("qwen3-4b"))
    params = J.T.init_params(cfg, J.jax.random.PRNGKey(0),
                             getattr(J.jnp, dt))
    gc = J.optim.GradCompressor() if compress else None
    state = J.S.init_train_state(cfg, params,
                                 J.optim.AdamW(moment_dtype="bfloat16"), gc)
    state["opt"]["step"] = state["opt"]["step"] + 5
    state["opt"]["m"] = J.jax.tree.map(lambda x: x + 0.25, state["opt"]["m"])
    return params, state


def _port_tree(J, tree):
    params, state = J.jax.tree.map(np.asarray, tree)
    return (lm_params_from_numpy(params, CPU),
            train_state_from_numpy(state, CPU))


def _dir_bytes(path) -> dict:
    return {n: open(os.path.join(path, n), "rb").read()
            for n in sorted(os.listdir(path))}


@pytest.mark.parametrize("compress", [False, True], ids=["raw", "zlib"])
def test_checkpoints_equal_repros_byte_for_byte(J, tmp_path, compress):
    tree = _jax_train_tree(J, compress=True)
    J.C.CheckpointManager(str(tmp_path / "j"), compress=compress).save(
        3, tree)
    CheckpointManager(str(tmp_path / "t"), compress=compress).save(
        3, _port_tree(J, tree))
    want = _dir_bytes(tmp_path / "j" / "step_00000003")
    got = _dir_bytes(tmp_path / "t" / "step_00000003")
    assert list(got) == list(want)
    for name in want:
        assert got[name] == want[name], name
    manifest = json.loads(got["manifest.json"])
    assert manifest["1/opt/step"] == {"file": "1__opt__step.bin",
                                      "dtype": "int32", "shape": [],
                                      "codec": "zlib" if compress else "raw"}
    assert manifest["0/embed"]["dtype"] == "bfloat16"


def test_checkpoints_restore_across_packages(J, tmp_path):
    """A ``repro`` checkpoint restored in the port, and a port checkpoint
    restored in ``repro``: every leaf bit for bit, dtypes kept."""
    tree = _jax_train_tree(J)
    port = _port_tree(J, tree)
    J.C.CheckpointManager(str(tmp_path / "j")).save(1, tree)
    got, step = CheckpointManager(str(tmp_path / "j")).restore(port,
                                                               device=CPU)
    assert step == 1
    for key, t in flatten(got).items():
        assert t.dtype == flatten(port)[key].dtype
        assert torch.equal(t, flatten(port)[key]), key
    CheckpointManager(str(tmp_path / "t")).save(2, port)
    back, step = J.C.CheckpointManager(str(tmp_path / "t")).restore(tree)
    assert step == 2
    for a, b in zip(J.jax.tree.leaves(back), J.jax.tree.leaves(tree)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_restore_puts_leaves_on_the_device(tmp_path):
    """The elastic re-shard of ``repro`` becomes a restore onto a device:
    written from the CPU, restored on the CPU bit for bit and on ``meta``
    with the same shapes and dtypes."""
    mgr = CheckpointManager(str(tmp_path))
    tree = {"w": torch.arange(64, dtype=torch.float32).reshape(8, 8),
            "s": torch.zeros((), dtype=torch.int32)}
    mgr.save(0, tree)
    got, _ = mgr.restore(tree, device=CPU)
    assert torch.equal(got["w"], tree["w"]) and got["s"].dim() == 0
    meta, _ = mgr.restore(tree, device="meta")
    assert meta["w"].device.type == "meta" and meta["w"].shape == (8, 8)
    assert meta["s"].dtype == torch.int32


# -- tests/test_checkpoint.py's scenarios on the port -------------------------

def test_save_restore_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    tree = {"a": torch.arange(10, dtype=torch.float32),
            "b": {"c": torch.ones((3, 4), dtype=torch.bfloat16),
                  "d": [torch.zeros(2), torch.full((2, 2), 7)]}}
    mgr.save(3, tree)
    got, step = mgr.restore(tree, device=CPU)
    assert step == 3
    for a, b in zip(flatten(tree).values(), flatten(got).values()):
        assert torch.equal(a, b)
        assert a.dtype == b.dtype


def test_compressed_checkpoint_lossless(tmp_path):
    mgr = CheckpointManager(str(tmp_path), compress=True)
    tree = {"w": torch.from_numpy(np.random.default_rng(0)
                                  .standard_normal((64, 64))
                                  .astype(np.float32))}
    mgr.save(1, tree)
    got, _ = mgr.restore(tree, device=CPU)
    assert torch.equal(tree["w"], got["w"])


def test_keep_last_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_last=2)
    for s in range(5):
        mgr.save(s, {"x": torch.zeros(1)})
    assert mgr.steps() == [3, 4]


def test_atomicity_no_partial_dirs(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"x": torch.zeros(4)})
    names = os.listdir(tmp_path)
    assert "step_00000001" in names
    assert not any(n.endswith(".tmp") for n in names)


def _mk_runtime(tmp_path, fail_at=None):
    cfg = reduced_config(get_config("xlstm-125m")).with_(remat=False)
    params = T.init_params(cfg, 0, device=CPU)
    opt = AdamW(lr=1e-3)
    state = init_train_state(cfg, params, opt)
    step_fn = make_train_step(cfg, opt)
    src = SyntheticTokens(vocab=cfg.vocab, seq_len=16, global_batch=4)
    rt = TrainRuntime(
        cfg=RuntimeConfig(ckpt_dir=str(tmp_path), ckpt_every=4,
                          fail_at_step=fail_at),
        train_step=step_fn, data_source=src, device=CPU)
    return rt, params, state


def test_runtime_failure_injection_and_restart(tmp_path):
    """A 'node failure' at step 6 restarts from step 4's checkpoint and
    the final state equals an uninterrupted run's (deterministic
    replay): the losses within 1e-3, as in ``repro``'s test, and on the
    CPU every parameter and moment bit for bit."""
    rt, params, state = _mk_runtime(tmp_path / "a", fail_at=6)
    p1, s1, hist1 = rt.run(params, state, n_steps=10)
    assert any(m["restarts"] == 1 for m in hist1)

    rt2, params2, state2 = _mk_runtime(tmp_path / "b", fail_at=None)
    p2, s2, hist2 = rt2.run(params2, state2, n_steps=10)
    last1 = [m["loss"] for m in hist1 if m["step"] == 9][0]
    last2 = [m["loss"] for m in hist2 if m["step"] == 9][0]
    assert abs(last1 - last2) < 1e-3    # replay converged to same state
    for a, b in zip(flatten((p1, s1)).values(), flatten((p2, s2)).values()):
        assert torch.equal(a, b)


class _FailingAdamW(AdamW):
    """AdamW whose update call ``at_call`` (0-based) writes into the
    parameters, as a slice of the in-place update would, then raises."""

    def __init__(self, at_call, **kw):
        super().__init__(**kw)
        object.__setattr__(self, "_left", at_call)

    def update(self, grads, state, params):
        object.__setattr__(self, "_left", self._left - 1)
        if self._left == -1:
            next(iter(flatten(params).values())).add_(1.0)
            raise RuntimeError("injected failure inside optimizer.update")
        return super().update(grads, state, params)


def test_runtime_refuses_to_replay_a_partly_updated_step_0(tmp_path):
    """A failure inside ``optimizer.update`` at step 0, with no checkpoint
    yet, leaves a partly updated tree: the runtime raises rather than
    replay from it.  The same failure at step 6 restores step 4's
    checkpoint and ends bit for bit on the uninterrupted run."""
    cfg = reduced_config(get_config("xlstm-125m")).with_(remat=False)
    src = SyntheticTokens(vocab=cfg.vocab, seq_len=16, global_batch=4)

    def run(path, at_call, n_steps):
        params = T.init_params(cfg, 0, device=CPU)
        opt = AdamW(lr=1e-3) if at_call is None else \
            _FailingAdamW(at_call, lr=1e-3)
        state = init_train_state(cfg, params, opt)
        rt = TrainRuntime(cfg=RuntimeConfig(ckpt_dir=str(path),
                                            ckpt_every=4),
                          train_step=make_train_step(cfg, opt),
                          data_source=src, device=CPU)
        return rt.run(params, state, n_steps=n_steps)

    with pytest.raises(RuntimeError, match="no checkpoint") as info:
        run(tmp_path / "a", 0, 3)
    assert "optimizer.update" in str(info.value.__cause__)
    p1, s1, hist1 = run(tmp_path / "b", 6, 8)
    assert any(m["restarts"] == 1 for m in hist1)
    p2, s2, _ = run(tmp_path / "c", None, 8)
    for a, b in zip(flatten((p1, s1)).values(), flatten((p2, s2)).values()):
        assert torch.equal(a, b)


def test_runtime_resume_from_disk(tmp_path):
    """Simulated preemption: a second runtime resumes where the first
    stopped (latest checkpoint) instead of from scratch."""
    rt, params, state = _mk_runtime(tmp_path)
    rt.run(params, state, n_steps=5)
    rt2, params2, state2 = _mk_runtime(tmp_path)
    _, _, hist = rt2.run(params2, state2, n_steps=8)
    assert hist[0]["step"] == 5         # continued, not restarted


# -- data, whole steps, the launcher ------------------------------------------

def test_token_sources_equal_repros(J, tmp_path):
    kw = dict(vocab=1000, seq_len=32, global_batch=6, seed=3, n_shards=2,
              shard=1)
    for step in (0, 1, 17):
        np.testing.assert_array_equal(
            SyntheticTokens(**kw).batch(step),
            J.D.SyntheticTokens(**kw).batch(step))
    path = str(tmp_path / "tokens.bin")
    np.random.default_rng(0).integers(0, 60000, 5000).astype(
        np.uint16).tofile(path)
    for step in (0, 5):
        np.testing.assert_array_equal(
            FileTokens(path=path, **kw).batch(step),
            J.D.FileTokens(path=path, **kw).batch(step))


@pytest.mark.parametrize("compress", [False, True], ids=["plain", "gc"])
def test_three_train_steps_match_repros_jitted_step(J, compress):
    jcfg = J.reduced(J.get("qwen3-4b"))
    tcfg = reduced_config(get_config("qwen3-4b"))
    jp = J.T.init_params(jcfg, J.jax.random.PRNGKey(1), J.jnp.float32)
    jopt, jgc = J.optim.AdamW(lr=3e-3), (J.optim.GradCompressor(1e-2)
                                         if compress else None)
    js = J.S.init_train_state(jcfg, jp, jopt, jgc)
    tp = lm_params_from_numpy(J.jax.tree.map(np.asarray, jp), CPU)
    topt, tgc = AdamW(lr=3e-3), GradCompressor(1e-2) if compress else None
    ts = init_train_state(tcfg, tp, topt, tgc)
    jstep = J.jax.jit(J.S.make_train_step(jcfg, jopt, jgc))
    tstep = make_train_step(tcfg, topt, tgc)
    src = SyntheticTokens(vocab=jcfg.vocab, seq_len=16, global_batch=4)
    for i in range(3):
        toks = src.batch(i)
        jp, js, jm = jstep(jp, js, {"tokens": J.jnp.asarray(toks)})
        tp, ts, tm = tstep(tp, ts, {"tokens": torch.from_numpy(toks)})
        for key in ("loss", "grad_norm"):
            assert abs(float(tm[key]) - float(jm[key])) <= \
                STEP_RTOL * abs(float(jm[key])), (i, key)
    assert int(ts["opt"]["step"]) == 3
    if compress:
        return
    want = {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path): np.asarray(x)
            for path, x in J.jax.tree_util.tree_flatten_with_path(
                (jp, js))[0]}
    got = flatten((tp, ts))
    assert list(got) == list(want)
    for key, w in want.items():
        err = np.abs(got[key].numpy().astype(np.float64) - w).max()
        tol = PARAM_RTOL if key.startswith("0/") else STEP_RTOL
        assert err <= tol * max(np.abs(w).max(), 1e-30), key


def test_launch_train_on_the_cpu(tmp_path, capsys):
    from repro_torch.launch import train as launch
    rc = launch.main(["--arch", "qwen3-4b", "--steps", "3", "--batch", "2",
                      "--seq", "16", "--device", "cpu", "--ckpt-dir",
                      str(tmp_path)])
    assert rc == 0
    out = capsys.readouterr().out
    assert "[train] qwen3-4b mesh=1x1: loss " in out and "ms/step" in out
    assert CheckpointManager(str(tmp_path)).steps() == [0, 2]
    # a mesh runs (tests/test_torch_sharded_train.py), one card a rank by
    # default: 2x4 wants 8 cards, and reduced qwen3-4b's 2 kv heads do not
    # split over model 4 on the CPU either
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < 8:
        with pytest.raises(ValueError, match=f"needs 8 devices, have {n}"):
            launch.main(["--mesh", "2x4"])
    with pytest.raises(NotImplementedError, match="A12h-b"):
        launch.main(["--mesh", "2x4", "--device", "cpu"])


def test_example_trains_on_the_cpu(tmp_path):
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    out = subprocess.run(
        [sys.executable, os.path.join(root, "examples", "train_lm_torch.py"),
         "--steps", "6", "--batch", "2", "--seq", "16", "--fail-at", "3",
         "--device", "cpu", "--ckpt-dir", str(tmp_path)],
        capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stderr
    assert "restarts=1" in out.stdout and "final loss" in out.stdout


@pytest.mark.cuda
def test_cuda_train_step_matches_the_cpu_run():
    """One train step of reduced qwen3-4b in f32 on the card (B10 in the
    forward and the remat recompute, its torch backward) against the same
    step on the CPU: the gradients within 1e-4 of each leaf's max, the
    loss and gradient norm within 1e-5, AdamW's moments within 1e-4 of
    their max.  The parameters move by lr · m/(sqrt(v) + eps) an element,
    a ratio that turns the last bits of a gradient far below its leaf's
    max into a visible part of the step (3.5e-5 of 3e-3 seen on one
    H100), so they are held within a tenth of one step, 0.1 · lr, and
    every leaf must have moved from its initial values."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU form")
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.train.step import make_loss_fn, value_and_grad
    cfg = reduced_config(get_config("qwen3-4b")).with_(remat=True)
    toks = SyntheticTokens(vocab=cfg.vocab, seq_len=64,
                           global_batch=2).batch(0)
    lr = 3e-3
    runs = []
    for dev in (CPU, torch.device("cuda", 0)):
        params = tree_map(lambda t: t.to(dev), T.init_params(
            cfg, 0, dtype=torch.float32, device=CPU))
        init = {k: t.cpu().clone() for k, t in flatten(params).items()}
        batch = {"tokens": torch.from_numpy(toks).to(dev)}
        _, grads = value_and_grad(make_loss_fn(cfg), params, batch)
        opt = AdamW(lr=lr)
        state = init_train_state(cfg, params, opt)
        fa.reset_launch_counts()
        params, state, m = make_train_step(cfg, opt)(params, state, batch)
        runs.append((flatten(grads), flatten(params), flatten(state), m,
                     fa.launch_counts["flash_attention"]))
    (gc, pc, sc, mc, nc), (gg, pg, sg, mg, ng) = runs
    assert nc == 0 and ng == 2 * cfg.n_layers     # forward + recompute
    for key in ("loss", "grad_norm"):
        assert abs(float(mg[key]) - float(mc[key])) <= 1e-5 * float(mc[key])
    for want, got, tol in ((gc, gg, 1e-4), (sc, sg, 1e-4)):
        for key, w in want.items():
            scale = float(w.abs().max()) or 1.0
            assert float((got[key].cpu() - w).abs().max()) <= tol * scale, \
                key
    for key, w in pc.items():
        assert float((pg[key].cpu() - w).abs().max()) <= 0.1 * lr, key
        assert not torch.equal(pg[key].cpu(), init[key]), key
