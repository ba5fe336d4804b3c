"""Training's loss and gradients on the port (ROADMAP A12f) against the
JAX package: ``jax.value_and_grad(repro.train.step.make_loss_fn(cfg))``
beside ``repro_torch.train.step.value_and_grad`` (``loss.backward()``) on
the same reduced models, weights carried across by
``interop.lm_params_from_numpy``, tokens (and a VLM's image embeddings or
whisper's frames) from numpy seeds.  Gradient leaves are matched by their
checkpoint keys (``train.checkpoint.flatten``, ``repro``'s path names).

Bounds.  In f32 the port computes ``repro``'s function: over seeds 0-2 on
a CPU container the loss read at most 2.7e-7 relative and the worst
gradient leaf 3.5e-6 of its max|g| (gemma3-12b's windowed layers; every
other family under 1.8e-6), held at 1e-6 and 1e-4.  In bf16 (qwen3-4b)
the two frameworks round the bf16 GEMMs around the attention core in other
orders: the loss read 2.6e-4 relative and the worst leaf 1.7e-2 of its
max|g| over three seeds, held at 1e-3 and 4e-2.  The CPU runs B10's plain
version under ``FlashAttentionFn``, so its backward
(``flash_attention_gqa_bwd``) is the one these gradients go through."""
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.interop import lm_params_from_numpy
from repro_torch.models import transformer as T
from repro_torch.train.checkpoint import flatten
from repro_torch.train.step import make_loss_fn, value_and_grad

CPU = torch.device("cpu")
B, S = 2, 16
ARCHS = ["qwen3-4b", "gemma3-12b", "mixtral-8x22b", "recurrentgemma-2b",
         "xlstm-125m", "llama-3.2-vision-90b", "whisper-large-v3"]
LOSS_RTOL = {"float32": 1e-6, "bfloat16": 1e-3}
GRAD_RTOL = {"float32": 1e-4, "bfloat16": 4e-2}


@pytest.fixture(scope="module")
def J():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jget
    from repro.configs import reduced_config as jreduced
    from repro.models import encdec as JE
    from repro.models import transformer as JT
    from repro.train import step as JS
    return types.SimpleNamespace(jax=jax, jnp=jnp, get_config=jget,
                                 reduced_config=jreduced, T=JT, E=JE, S=JS)


def _inputs(J, arch: str, dt: str, seed: int):
    """(JAX cfg, port cfg, JAX params, port params, JAX batch, port
    batch) of the reduced ``arch`` in ``dt``."""
    jcfg = J.reduced_config(J.get_config(arch))
    tcfg = reduced_config(get_config(arch))
    audio = jcfg.family == "audio"
    init = J.E.init_encdec_params if audio else J.T.init_params
    jp = init(jcfg, J.jax.random.PRNGKey(seed), getattr(J.jnp, dt))
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, jcfg.vocab, (B, jcfg.encoder.dec_len if audio
                                        else S)).astype(np.int32)
    jb = {"tokens": J.jnp.asarray(toks)}
    tb = {"tokens": torch.from_numpy(toks).long()}
    if audio or "cross_attn" in jcfg.pattern:
        key = "frames" if audio else "aux"
        n = jcfg.encoder.n_frames if audio else jcfg.n_image_tokens
        src = J.jnp.asarray(rng.standard_normal((B, n, jcfg.d_model))
                            .astype(np.float32), getattr(J.jnp, dt))
        jb[key] = src
        tb[key] = lm_params_from_numpy(np.asarray(src), CPU)
    tp = lm_params_from_numpy(J.jax.tree.map(np.asarray, jp), CPU)
    return jcfg, tcfg, jp, tp, jb, tb


def _jflat(J, tree) -> dict:
    """``repro``'s leaves by checkpoint key, as f32 numpy."""
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path): np.asarray(leaf, np.float32)
            for path, leaf in J.jax.tree_util.tree_flatten_with_path(tree)[0]}


def _worst_leaf(tgrads, jgrads) -> tuple[float, str]:
    """The largest max|Δg| / max|g| over the leaves, and its key."""
    assert list(tgrads) == list(jgrads)
    worst, where = 0.0, ""
    for key, want in jgrads.items():
        got = tgrads[key].float().numpy()
        assert got.shape == want.shape, key
        scale = float(np.abs(want).max())
        err = float(np.abs(got - want).max()) / (scale or 1.0)
        if err > worst:
            worst, where = err, key
    return worst, where


def _check(J, arch: str, dt: str, seed: int) -> None:
    jcfg, tcfg, jp, tp, jb, tb = _inputs(J, arch, dt, seed)
    jloss, jgrads = J.jax.value_and_grad(J.S.make_loss_fn(jcfg))(jp, jb)
    tloss, tgrads = value_and_grad(make_loss_fn(tcfg), tp, tb)
    assert tloss.dtype == torch.float32 and tloss.dim() == 0
    rel = abs(float(tloss) - float(jloss)) / abs(float(jloss))
    assert rel <= LOSS_RTOL[dt], (arch, dt, rel)
    for t in flatten(tgrads).values():
        assert t.grad is None
    worst, where = _worst_leaf(flatten(tgrads), _jflat(J, jgrads))
    assert worst <= GRAD_RTOL[dt], (arch, dt, where, worst)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_repro_f32(J, arch):
    _check(J, arch, "float32", 0)


def test_loss_and_gradients_match_repro_bf16(J):
    _check(J, "qwen3-4b", "bfloat16", 1)


def test_every_parameter_gets_a_gradient():
    """No leaf of reduced qwen3-4b is cut from the graph: the projections
    before the attention core and its norms included."""
    cfg = reduced_config(get_config("qwen3-4b"))
    params = T.init_params(cfg, 0, dtype=torch.float32, device=CPU)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (B, S)))
    loss, grads = value_and_grad(make_loss_fn(cfg), params,
                                 {"tokens": toks})
    zero = [k for k, g in flatten(grads).items() if not bool(g.any())]
    assert zero == [] and bool(torch.isfinite(loss))


@pytest.mark.parametrize("arch", ["qwen3-4b", "llama-3.2-vision-90b",
                                  "whisper-large-v3"])
def test_remat_equals_no_remat_bit_for_bit(arch):
    """Checkpointed units (``cfg.remat``) recompute the same activations:
    loss and every gradient leaf bit for bit the run without remat."""
    base = reduced_config(get_config(arch))
    audio = base.family == "audio"
    rng = np.random.default_rng(4)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, base.vocab, (B, base.encoder.dec_len if audio else S)))}
    if audio or "cross_attn" in base.pattern:
        n = base.encoder.n_frames if audio else base.n_image_tokens
        batch["frames" if audio else "aux"] = torch.from_numpy(
            rng.standard_normal((B, n, base.d_model)).astype(np.float32))
    from repro_torch.models import encdec as E
    init = E.init_encdec_params if audio else T.init_params
    params = init(base, 0, dtype=torch.float32, device=CPU)
    runs = [value_and_grad(make_loss_fn(base.with_(remat=r)), params, batch)
            for r in (False, True)]
    (l0, g0), (l1, g1) = runs
    assert torch.equal(l0, l1)
    for key, g in flatten(g0).items():
        assert torch.equal(g, flatten(g1)[key]), key


def test_remat_checkpoints_each_unit_only_under_grad(monkeypatch):
    """``forward_train`` checkpoints each pattern unit when ``cfg.remat``
    is set and grad is enabled, and never under ``torch.no_grad``."""
    import repro_torch.models.transformer as TM
    cfg = reduced_config(get_config("gemma3-12b")).with_(remat=True)
    params = T.init_params(cfg, 0, dtype=torch.float32, device=CPU)
    calls = []
    real = TM.checkpoint

    def counting(fn, *args, **kw):
        calls.append(kw)
        return real(fn, *args, **kw)
    monkeypatch.setattr(TM, "checkpoint", counting)
    toks = torch.zeros((1, 8), dtype=torch.long)
    with torch.no_grad():
        T.forward_train(cfg, params, toks)
    assert calls == []
    for p in flatten(params).values():
        p.requires_grad_(True)
    T.loss_fn(cfg, params, toks).backward()
    assert len(calls) == cfg.n_units
    assert all(kw["use_reentrant"] is False for kw in calls)
