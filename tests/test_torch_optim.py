"""The port's optimizers and gradient compressor (ROADMAP A12f) against
the JAX package's, and ``tests/test_train.py``'s scenarios on the port.

``AdamW`` (f32 and bf16 moments, with and without weight decay) and
``Adafactor`` take three updates of the same numpy-seeded trees in both
packages, stacked leaves among them, with slices of 300 elements so every
leaf is updated in slices (Adafactor's matrices over their leading axes):
parameters and state within 1e-6 of their max (measured on a CPU
container: AdamW 7.6e-9, Adafactor 2.0e-7).  Adafactor also runs on the
reduced arctic-480b's tree, the config that picks it.

``GradCompressor`` is held to the pwrel tolerance (ROADMAP): from the same
gradients and residuals, equal zero and sign positions and codes one
apart in at most 0.1% of elements (measured 0.9e-5 to 2.3e-5 of 3 M
log-uniform elements a step: XLA's ``log2`` is not correctly rounded, nor
is ``torch.log2``), the residual the part the code dropped."""
import types

import numpy as np
import pytest
import torch

from repro_torch.compression.pwrel import log_step
from repro_torch.configs import get_config, reduced_config
from repro_torch.interop import lm_params_from_numpy, train_state_from_numpy
from repro_torch.models import transformer as T
from repro_torch.optim import Adafactor, AdamW, GradCompressor
from repro_torch.optim import adamw as adamw_mod
from repro_torch.train.checkpoint import flatten
from repro_torch.train.data import SyntheticTokens, make_batches
from repro_torch.train.step import init_train_state, make_train_step

CPU = torch.device("cpu")
RTOL = 1e-6
CODE_DIFF_SHARE = 1e-3
SHAPES = {"a": (3, 40, 50), "b": (64,), "c": [(7, 9), (2, 3, 4, 5)]}


@pytest.fixture(scope="module")
def J():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro import optim
    from repro.configs import get_config as jget
    from repro.configs import reduced_config as jreduced
    from repro.models import transformer as JT
    return types.SimpleNamespace(jax=jax, jnp=jnp, optim=optim, get=jget,
                                 reduced=jreduced, T=JT)


@pytest.fixture
def small_slices(monkeypatch):
    monkeypatch.setattr(adamw_mod, "SLICE_ELEMENTS", 300)


def _tree(rng, scale=None):
    def leaf(shape):
        x = rng.standard_normal(shape)
        if scale is not None:
            x = x * np.exp(rng.uniform(*scale, shape))
        return x.astype(np.float32)
    return {"a": leaf(SHAPES["a"]), "b": leaf(SHAPES["b"]),
            "c": [leaf(s) for s in SHAPES["c"]]}


def _jflat(J, tree) -> dict:
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path): np.asarray(leaf, np.float32)
            for path, leaf in J.jax.tree_util.tree_flatten_with_path(tree)[0]}


def _close(J, port_tree, jax_tree, rtol: float = RTOL) -> None:
    want, got = _jflat(J, jax_tree), flatten(port_tree)
    assert list(got) == list(want)
    for key, w in want.items():
        g = got[key].float().numpy()
        assert g.shape == w.shape, key
        scale = max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(g - w).max()) / scale <= rtol, key


def _three_updates(J, jopt, topt, params, grads):
    jp = J.jax.tree.map(J.jnp.asarray, params)
    js = jopt.init(jp)
    tp = lm_params_from_numpy(params, CPU)
    ts = topt.init(tp)
    for g in grads:
        jp, js = jopt.update(J.jax.tree.map(J.jnp.asarray, g), js, jp)
        tp, ts = topt.update(lm_params_from_numpy(g, CPU), ts, tp)
    return (tp, ts), (jp, js)


@pytest.mark.parametrize("kw", [{}, {"moment_dtype": "bfloat16"},
                                {"weight_decay": 0.1}],
                         ids=["f32", "bf16_moments", "weight_decay"])
def test_adamw_matches_repro(J, small_slices, kw):
    rng = np.random.default_rng(0)
    port, ref = _three_updates(J, J.optim.AdamW(lr=1e-2, **kw),
                               AdamW(lr=1e-2, **kw), _tree(rng),
                               [_tree(rng) for _ in range(3)])
    _close(J, port, ref)
    assert int(port[1]["step"]) == 3 and port[1]["step"].dtype == torch.int32
    want = torch.bfloat16 if kw.get("moment_dtype") else torch.float32
    assert port[1]["m"]["a"].dtype == want


def test_adafactor_matches_repro(J, small_slices):
    rng = np.random.default_rng(1)
    port, ref = _three_updates(J, J.optim.Adafactor(lr=1e-2),
                               Adafactor(lr=1e-2), _tree(rng),
                               [_tree(rng) for _ in range(3)])
    _close(J, port, ref)
    assert sorted(port[1]["f"]["a"]) == ["c", "r"]
    assert sorted(port[1]["f"]["b"]) == ["v"]


def test_adafactor_matches_repro_on_reduced_arctic(J, small_slices):
    """The reduced arctic-480b's tree (expert stacks, router, dense
    branch) under its config's optimizer."""
    jcfg = J.reduced(J.get("arctic-480b"))
    assert jcfg.optimizer == "adafactor"
    jp = J.T.init_params(jcfg, J.jax.random.PRNGKey(0), J.jnp.float32)
    params = J.jax.tree.map(np.asarray, jp)
    rng = np.random.default_rng(2)
    grads = [J.jax.tree.map(lambda x: rng.standard_normal(x.shape)
                            .astype(np.float32), params) for _ in range(3)]
    port, ref = _three_updates(J, J.optim.Adafactor(lr=1e-3),
                               Adafactor(lr=1e-3), params, grads)
    _close(J, port, ref)


def test_train_state_crosses_from_repro(J):
    """``interop.train_state_from_numpy`` carries ``repro``'s
    ``{"opt", "gc_err"}`` across: the same leaves and dtypes, ``step`` a
    0-d int32 tensor."""
    rng = np.random.default_rng(3)
    params = J.jax.tree.map(J.jnp.asarray, _tree(rng))
    opt = J.optim.AdamW(moment_dtype="bfloat16")
    state = {"opt": opt.init(params),
             "gc_err": J.optim.GradCompressor().init(params)}
    state["opt"]["step"] = state["opt"]["step"] + 7
    got = train_state_from_numpy(J.jax.tree.map(np.asarray, state), CPU)
    assert list(flatten(got)) == list(_jflat(J, state))
    assert got["opt"]["m"]["a"].dtype == torch.bfloat16
    step = got["opt"]["step"]
    assert step.dim() == 0 and step.dtype == torch.int32 and int(step) == 7


def _codes_one_apart(got: np.ndarray, want: np.ndarray, step: float):
    """(elements, code differences) of two dequantized gradients: equal
    zero and sign positions, codes apart by at most one."""
    got, want = got.astype(np.float64), want.astype(np.float64)
    np.testing.assert_array_equal(got == 0, want == 0)
    np.testing.assert_array_equal(np.sign(got), np.sign(want))
    nz = want != 0
    ratio = np.log2(np.abs(got[nz]) / np.abs(want[nz])) / step
    d = np.round(ratio)
    assert float(np.abs(ratio - d).max()) < 1e-2     # whole code steps
    assert float(np.abs(d).max()) <= 1
    return int(nz.sum()), int((d != 0).sum())


def test_grad_compressor_matches_repro_within_the_pwrel_tolerance(
        J, small_slices):
    """Three steps from the same gradients and residuals (each step the
    port starts from ``repro``'s residuals): dequantized gradients within
    the pwrel tolerance, residuals g + e - q."""
    rng = np.random.default_rng(4)
    jgc, tgc = J.optim.GradCompressor(1e-2), GradCompressor(1e-2)
    step = log_step(1e-2)
    jerr = jgc.init(J.jax.tree.map(J.jnp.asarray, _tree(rng)))
    n = diff = 0
    for _ in range(3):
        g = _tree(rng, scale=(-20.0, 3.0))
        terr = train_state_from_numpy(J.jax.tree.map(np.asarray, jerr), CPU)
        g32 = {k: v + terr_v for k, v, terr_v in zip(
            flatten(g), (torch.from_numpy(x) for x in flatten(g).values()),
            flatten(terr).values())}
        tq, terr = tgc.roundtrip(lm_params_from_numpy(g, CPU), terr)
        jq, jerr = jgc.roundtrip(J.jax.tree.map(J.jnp.asarray, g), jerr)
        for key, want in _jflat(J, jq).items():
            a, b = _codes_one_apart(flatten(tq)[key].numpy(), want, step)
            n, diff = n + a, diff + b
            q = flatten(tq)[key]
            np.testing.assert_allclose((q + flatten(terr)[key]).numpy(),
                                       g32[key].numpy(), atol=1e-7)
    assert diff <= CODE_DIFF_SHARE * n


# -- tests/test_train.py's scenarios on the port ------------------------------

def _t(x, dtype=torch.float32):
    return torch.tensor(x, dtype=dtype)


def test_adamw_quadratic():
    """AdamW minimizes a quadratic."""
    opt = AdamW(lr=0.1)
    params = {"w": _t([3.0, -2.0])}
    state = opt.init(params)
    for _ in range(200):
        grads = {"w": 2.0 * params["w"]}
        params, state = opt.update(grads, state, params)
    assert float(params["w"].abs().max()) < 1e-2


def test_adamw_bf16_moments():
    opt = AdamW(lr=0.05, moment_dtype="bfloat16")
    params = {"w": _t([1.0, -1.0])}
    state = opt.init(params)
    assert state["m"]["w"].dtype == torch.bfloat16
    for _ in range(100):
        params, state = opt.update({"w": 2 * params["w"]}, state, params)
    assert float(params["w"].abs().max()) < 0.1


def test_adafactor_quadratic():
    opt = Adafactor(lr=0.1)
    params = {"w": torch.ones((4, 4)) * 3.0}
    state = opt.init(params)
    assert "r" in state["f"]["w"]       # factored, not full
    for _ in range(300):
        params, state = opt.update({"w": 2 * params["w"]}, state, params)
    assert float(params["w"].abs().max()) < 0.05


def test_grad_compressor_bound_and_feedback():
    gc = GradCompressor(b_r=1e-2)
    g0 = np.random.default_rng(0).standard_normal(512).astype(np.float32)
    g = {"w": torch.from_numpy(g0.copy())}
    err = gc.init(g)
    q, err = gc.roundtrip(g, err)
    rel = np.abs(q["w"].numpy() - g0) / np.maximum(np.abs(g0), 1e-20)
    assert rel.max() < 2e-2 + 1e-6
    # error feedback: residual equals what quantization dropped
    np.testing.assert_allclose(err["w"].numpy(), g0 - q["w"].numpy(),
                               atol=1e-7)
    assert gc.bytes_ratio > 1.8


def _short_train(arch="xlstm-125m", steps=20, compress=False):
    cfg = reduced_config(get_config(arch)).with_(remat=False)
    params = T.init_params(cfg, 0, device=CPU)
    opt = AdamW(lr=3e-3)
    gc = GradCompressor(1e-2) if compress else None
    state = init_train_state(cfg, params, opt, gc)
    step_fn = make_train_step(cfg, opt, gc)
    src = SyntheticTokens(vocab=cfg.vocab, seq_len=32, global_batch=8)
    losses = []
    for step, batch in make_batches(src):
        if step >= steps:
            break
        params, state, metrics = step_fn(
            params, state, {"tokens": torch.from_numpy(batch).long()})
        losses.append(float(metrics["loss"]))
    return losses


def test_loss_decreases():
    losses = _short_train(steps=20)
    assert losses[-1] < losses[0] - 0.2, losses[::5]
    assert all(np.isfinite(losses))


def test_grad_compression_preserves_convergence():
    """Compressed-grad training tracks the uncompressed trajectory (same
    data, same init)."""
    base = _short_train(steps=15, compress=False)
    comp = _short_train(steps=15, compress=True)
    assert comp[-1] < comp[0] - 0.15
    assert abs(comp[-1] - base[-1]) < 0.3, (base[-1], comp[-1])


def test_data_pipeline_deterministic_resume():
    src = SyntheticTokens(vocab=100, seq_len=16, global_batch=4)
    a = [b for _, b in zip(range(5), make_batches(src))]
    b = [b for _, b in zip(range(3), make_batches(src, start_step=2))]
    np.testing.assert_array_equal(a[2][1], b[0][1])   # replay == original
    # sharded streams partition the same step
    s0 = SyntheticTokens(vocab=100, seq_len=16, global_batch=4,
                         n_shards=2, shard=0)
    s1 = SyntheticTokens(vocab=100, seq_len=16, global_batch=4,
                         n_shards=2, shard=1)
    assert s0.batch(7).shape == (2, 16)
    assert not np.array_equal(s0.batch(7), s1.batch(7))


def test_updates_run_in_slices_in_place(small_slices):
    """A stacked leaf is updated a slice of the leading axis at a time,
    into the given tensors (the same storage comes back), and the result
    is the whole-leaf update's."""
    rng = np.random.default_rng(5)
    p0, g = rng.standard_normal((2, 6, 20, 30)).astype(np.float32)
    whole = AdamW(lr=1e-2)
    ref_p = {"w": torch.from_numpy(p0.copy())}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(adamw_mod, "SLICE_ELEMENTS", 1 << 30)
        ref_p, _ = whole.update({"w": torch.from_numpy(g)},
                                whole.init(ref_p), ref_p)
    p = {"w": torch.from_numpy(p0.copy())}
    ptr = p["w"].data_ptr()
    state = whole.init(p)
    p, state = whole.update({"w": torch.from_numpy(g)}, state, p)
    assert p["w"].data_ptr() == ptr
    assert torch.equal(p["w"], ref_p["w"])
    assert len(list(adamw_mod.slices(p["w"]))) == 6
