"""The port's LM serving path (prefill -> compress the cache -> compressed
decode) against the JAX package's, on reduced configs of qwen3-4b (GQA,
qk-norm), granite-20b (MQA) and qwen1.5-32b (QKV bias), with the JAX
weights carried across by ``lm_params_from_numpy`` and the same
numpy-seeded tokens.

The port's attention cores round as the JAX package's do for bf16
inputs (the probabilities, and the dequantized K/V of the compressed
cache, to bf16), but the bf16 matmuls around them sum in another order,
so logits agree to bf16 rounding: they are held at 2e-2·max|ref|, the
bound ``tests/test_serving.py`` uses between its own serving modes
(measured: at most 0.53% on a CPU container, raw decode
included, which never reaches B11); compressed decode at 1e-2 (measured
0.529%, 0.532% while B11 kept K/V and P in f32).  Codes are held to the
measured quantize_kv tolerance (ROADMAP §C): XLA's ``log2`` is not
correctly rounded."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCH_IDS, get_config, reduced_config
from repro_torch.interop import lm_cache_from_numpy, lm_params_from_numpy
from repro_torch.models import attention as A
from repro_torch.models import transformer as T
from repro_torch.serving import make_decode_step, make_prefill_step
from repro_torch.serving import kvcache as KV

CPU = torch.device("cpu")
ARCHS = ["qwen3-4b", "granite-20b", "qwen1.5-32b"]
LOGIT_RTOL = 2e-2
DECODE_RTOL = 1e-2             # compressed decode: measured 0.529%
B, S, STEPS = 2, 20, 4
# quantize_kv against XLA's on the same input (1,048,576 bf16 normals, 3
# seeds, builders' CPU container): |dcode| = 1 in 4.96e-5 to 6.29e-5 of
# the codes, scales within 1 ulp
CODE_DIFF_SHARE = 2e-4


@pytest.fixture(scope="module")
def J():
    pytest.importorskip("jax")
    import types

    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jget
    from repro.configs import reduced_config as jreduced
    from repro.models import transformer as JT
    from repro.serving import kvcache as JKV
    return types.SimpleNamespace(jax=jax, jnp=jnp, get_config=jget,
                                 reduced_config=jreduced, T=JT, KV=JKV)


def _np_tree(J, tree):
    return J.jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module", params=ARCHS)
def model(request, J):
    """(arch, JAX cfg, port cfg, JAX params, port params, tokens)."""
    arch = request.param
    jcfg = J.reduced_config(J.get_config(arch))
    tcfg = reduced_config(get_config(arch))
    jp = J.T.init_params(jcfg, J.jax.random.PRNGKey(3))
    tp = lm_params_from_numpy(_np_tree(J, jp), CPU)
    toks = np.random.default_rng(0).integers(0, jcfg.vocab, (B, S)) \
        .astype(np.int32)
    return arch, jcfg, tcfg, jp, tp, toks


def _err(a, b):
    return float(np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32))
                 .max())


def _tok(toks, lo, hi=None):
    return torch.from_numpy(toks[:, lo:hi]).long()


def test_train_prefill_and_raw_decode_match_repro(J, model):
    arch, jcfg, tcfg, jp, tp, toks = model
    jnp = J.jnp
    ref = np.asarray(J.T.forward_train(jcfg, jp, jnp.asarray(toks)))
    scale = np.abs(ref).max()
    assert _err(T.forward_train(tcfg, tp, _tok(toks, 0)), ref) \
        < LOGIT_RTOL * scale
    jlp, jc = J.T.forward_prefill(jcfg, jp, jnp.asarray(toks[:, :S - STEPS]),
                                  max_len=S)
    tlp, tc = T.forward_prefill(tcfg, tp, _tok(toks, 0, S - STEPS),
                                max_len=S)
    assert _err(tlp, jlp) < LOGIT_RTOL * scale
    jleaves = J.jax.tree.leaves(jc)
    tleaves = [tc["units"][0]["k"], tc["units"][0]["v"]]
    assert [tuple(x.shape) for x in jleaves] == \
        [tuple(x.shape) for x in tleaves]
    for jl, tl in zip(jleaves, tleaves):
        assert tl.dtype == torch.bfloat16
        assert _err(tl.float(), jl) < LOGIT_RTOL * np.abs(
            np.asarray(jl, np.float32)).max()
    step = make_decode_step(tcfg)
    for i in range(STEPS):
        pos = S - STEPS + i
        jtok = jnp.asarray(toks[:, pos:pos + 1])
        jlg, jc = J.T.forward_decode(jcfg, jp, jtok, jc, pos)
        tlg, tc = step(tp, {"token": _tok(toks, pos, pos + 1), "cache": tc,
                            "pos": pos})
        jlg = np.asarray(jlg)
        assert _err(tlg, jlg) < LOGIT_RTOL * np.abs(jlg).max(), (arch, pos)


def test_compressed_cache_leaves_match_repro(J, model):
    """Both packages compress the same (JAX) prefill cache: sign bytes
    equal, codes within one in a measured share, scales within 1 ulp."""
    arch, jcfg, tcfg, jp, tp, toks = model
    _, jc = J.T.forward_prefill(jcfg, jp, J.jnp.asarray(toks), max_len=S + 4)
    jq = J.KV.compress_prefill_cache(jc)
    tq = KV.compress_prefill_cache(lm_cache_from_numpy(_np_tree(J, jc), CPU))
    jentry, tentry = jq["units"][0], tq["units"][0]
    assert sorted(jentry) == sorted(tentry)
    n = diff = 0
    for key in jentry:
        j, t = np.asarray(jentry[key]), tentry[key].numpy()
        assert t.dtype == j.dtype and t.shape == j.shape, key
        if key.startswith("signs"):
            np.testing.assert_array_equal(t, j)
        elif key.startswith("codes"):
            d = np.abs(t.astype(np.int64) - j.astype(np.int64))
            assert d.max() <= 1, key
            n, diff = n + d.size, diff + int((d != 0).sum())
        else:
            ulp = np.abs(t.view(np.int32).astype(np.int64)
                         - j.view(np.int32).astype(np.int64))
            assert ulp.max() <= 1, key
    assert diff <= CODE_DIFF_SHARE * n + 1


def test_quantize_kv_within_the_measured_tolerance(J):
    """quantize_kv on 2^20 bf16 normals against XLA's, and dequantize_kv on
    the same codes; plus test_serving's 3% round-trip bound."""
    x = np.random.default_rng(0).standard_normal((4, 256, 8, 128))
    jx = J.jnp.asarray(x, J.jnp.bfloat16)
    jq = J.KV.quantize_kv(jx)
    tx = lm_cache_from_numpy(np.asarray(jx), CPU)
    tq = KV.quantize_kv(tx)
    d = np.abs(tq["codes"].numpy().astype(np.int64)
               - np.asarray(jq["codes"]).astype(np.int64))
    assert d.max() <= 1 and (d != 0).mean() <= CODE_DIFF_SHARE
    np.testing.assert_array_equal(tq["signs"].numpy(), np.asarray(jq["signs"]))
    ulp = np.abs(tq["scale"].numpy().view(np.int32).astype(np.int64)
                 - np.asarray(jq["scale"]).view(np.int32).astype(np.int64))
    assert ulp.max() <= 1
    same = {k: torch.from_numpy(np.array(v)) for k, v in jq.items()}
    jd = np.asarray(J.KV.dequantize_kv(jq, J.jnp.float32))
    td = KV.dequantize_kv(same, torch.float32).numpy()
    np.testing.assert_allclose(td, jd, rtol=1e-6, atol=0)
    xf = tx.float().numpy()
    xh = KV.dequantize_kv(tq).float().numpy()
    nz = np.abs(xf) > np.abs(xf).max() * 2 ** -15
    assert (np.abs(xh[nz] - xf[nz]) / np.abs(xf[nz])).max() < 0.03
    assert KV.kv_bytes_ratio(128) > 1.7


def test_compressed_decode_matches_repro(J, model):
    arch, jcfg, tcfg, jp, tp, toks = model
    jnp = J.jnp
    _, jc = J.T.forward_prefill(jcfg, jp, jnp.asarray(toks[:, :S - STEPS]),
                                max_len=S)
    _, tc = T.forward_prefill(tcfg, tp, _tok(toks, 0, S - STEPS), max_len=S)
    jq = J.KV.compress_prefill_cache(jc)
    tq = KV.compress_prefill_cache(tc)
    step = KV.make_compressed_decode_step(tcfg)
    for i in range(STEPS):
        pos = S - STEPS + i
        jtok = jnp.asarray(toks[:, pos:pos + 1])
        jlg, jq = J.T.forward_decode(jcfg, jp, jtok, jq, pos)
        tlg, tq = step(tp, {"token": _tok(toks, pos, pos + 1), "cache": tq,
                            "pos": pos})
        jlg = np.asarray(jlg)
        assert _err(tlg, jlg) < DECODE_RTOL * np.abs(jlg).max(), (arch, pos)


#: f32 compressed decode of the reduced qwen3-4b against repro's: the port
#: rounds K/V, the probabilities and the attention output to bf16 as
#: repro's decode does whatever the model's dtype; measured at most
#: 2.07e-7·max|ref| over the 4 steps (CPU container, 1, 2 and 6 threads),
#: held at 3x that
F32_DECODE_RTOL = 6e-7


def test_f32_compressed_decode_matches_repro(J):
    jnp = J.jnp
    jcfg = J.reduced_config(J.get_config("qwen3-4b"))
    tcfg = reduced_config(get_config("qwen3-4b"))
    jp = J.T.init_params(jcfg, J.jax.random.PRNGKey(3), dtype=jnp.float32)
    tp = lm_params_from_numpy(_np_tree(J, jp), CPU)
    toks = np.random.default_rng(0).integers(0, jcfg.vocab, (B, S)) \
        .astype(np.int32)
    _, jc = J.T.forward_prefill(jcfg, jp, jnp.asarray(toks[:, :S - STEPS]),
                                max_len=S)
    _, tc = T.forward_prefill(tcfg, tp, _tok(toks, 0, S - STEPS), max_len=S)
    jq = J.KV.compress_prefill_cache(jc)
    tq = KV.compress_prefill_cache(tc)
    step = KV.make_compressed_decode_step(tcfg)
    for i in range(STEPS):
        pos = S - STEPS + i
        jlg, jq = J.T.forward_decode(jcfg, jp, jnp.asarray(
            toks[:, pos:pos + 1]), jq, pos)
        tlg, tq = step(tp, {"token": _tok(toks, pos, pos + 1), "cache": tq,
                            "pos": pos})
        jlg = np.asarray(jlg)
        assert tlg.dtype == torch.float32
        assert _err(tlg, jlg) < F32_DECODE_RTOL * np.abs(jlg).max(), pos


def test_prefill_decode_matches_own_train_forward(model):
    """The port alone, as tests/test_serving.py holds the JAX package:
    prefill + raw decode, and prefill + compressed decode, against
    forward_train's logits."""
    arch, _, tcfg, _, tp, toks = model
    ref = T.forward_train(tcfg, tp, _tok(toks, 0))
    scale = float(ref.abs().max())
    prefill = make_prefill_step(tcfg, max_len=S)
    lp, cache = prefill(tp, {"tokens": _tok(toks, 0, S - STEPS)})
    assert float((lp - ref[:, S - STEPS - 1]).abs().max()) < LOGIT_RTOL * scale
    qcache = KV.compress_prefill_cache(cache)
    for i in range(STEPS):
        pos = S - STEPS + i
        tok = _tok(toks, pos, pos + 1)
        lg, cache = T.forward_decode(tcfg, tp, tok, cache, pos)
        lq, qcache = T.forward_decode(tcfg, tp, tok, qcache, pos)
        assert float((lg - ref[:, pos]).abs().max()) < LOGIT_RTOL * scale
        assert float((lq - ref[:, pos]).abs().max()) < 5e-2 * scale, pos


def test_decode_writes_the_cache_in_place(model):
    arch, _, tcfg, _, tp, toks = model
    _, cache = T.forward_prefill(tcfg, tp, _tok(toks, 0, 8), max_len=12)
    qcache = KV.compress_prefill_cache(cache)
    leaf, qleaf = cache["units"][0]["k"], qcache["units"][0]["codes_k"]
    assert not leaf[:, :, 8].any() and not qleaf[:, :, 8].any()
    _, c2 = T.forward_decode(tcfg, tp, _tok(toks, 8, 9), cache, 8)
    _, q2 = T.forward_decode(tcfg, tp, _tok(toks, 8, 9), qcache, 8)
    assert c2["units"][0]["k"] is leaf and q2["units"][0]["codes_k"] is qleaf
    assert leaf[:, :, 8].any() and qleaf[:, :, 8].any()
    assert not leaf[:, :, 9].any()
    with pytest.raises(ValueError, match="do not fit"):
        T.forward_decode(tcfg, tp, _tok(toks, 8, 9), cache, 12)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_configs_equal_the_jax_packages(J, arch):
    jcfg = J.get_config(arch)
    tcfg = get_config(arch)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(reduced_config(tcfg)) == \
        dataclasses.asdict(J.reduced_config(jcfg))
    assert tcfg.param_count() == jcfg.param_count()
    assert tcfg.layer_kinds() == jcfg.layer_kinds()
    assert tcfg.n_units == jcfg.n_units


def test_full_qwen3_params_on_meta_match_the_jax_tree(J):
    """init_params at full size on the meta device: every leaf's shape and
    dtype equal the JAX package's; 4,022,468,096 elements, which is
    param_count() (4,022,456,320) plus the qk-norm and final-norm scales
    it leaves out (36 * 2 * 128 + 2560)."""
    cfg = get_config("qwen3-4b")
    tp = T.init_params(cfg, device=torch.device("meta"))
    jcfg = J.get_config("qwen3-4b")
    jshape = J.jax.eval_shape(
        lambda: J.T.init_params(jcfg, J.jax.random.PRNGKey(0)))
    jl = J.jax.tree_util.tree_flatten_with_path(jshape)[0]
    tl = J.jax.tree_util.tree_flatten_with_path(tp)[0]
    assert [p for p, _ in tl] == [p for p, _ in jl]
    for (path, t), (_, j) in zip(tl, jl):
        assert tuple(t.shape) == tuple(j.shape), path
        assert str(t.dtype).split(".")[-1] == str(j.dtype), path
    n = sum(t.numel() for _, t in tl)
    assert n == 4_022_468_096
    assert cfg.param_count() == 4_022_456_320
    assert n == cfg.param_count() + cfg.n_layers * 2 * cfg.hd + cfg.d_model


def test_unported_moe_windows_and_cross_attention_raise():
    dense = reduced_config(get_config("qwen3-4b"))
    prm = A.init_attn_params(None, dense, device=CPU)
    x = torch.zeros((1, 4, dense.d_model), dtype=torch.bfloat16)
    pos = torch.arange(4)
    with pytest.raises(NotImplementedError, match="A12g"):
        A.attention_full(x, prm, dense.with_(seq_parallel_attn=True), pos)


def test_lm_trees_cross_bit_for_bit(J):
    """bf16 leaves arrive as ml_dtypes arrays (np.asarray of a JAX bf16
    array) and cross bit for bit; uint8 and f32 leaves keep their dtype;
    the tensors are writable copies."""
    jnp = J.jnp
    rng = np.random.default_rng(1)
    w = jnp.asarray(rng.standard_normal((3, 5)), jnp.bfloat16)
    tree = {"w": [w], "n": (jnp.zeros((4,), jnp.float32),),
            "c": jnp.asarray(rng.integers(0, 255, (2, 8)), jnp.uint8)}
    out = lm_params_from_numpy(_np_tree(J, tree), CPU)
    assert isinstance(out["w"], list) and isinstance(out["n"], tuple)
    assert out["w"][0].dtype == torch.bfloat16
    np.testing.assert_array_equal(out["w"][0].view(torch.int16).numpy(),
                                  np.asarray(w).view(np.int16))
    assert out["n"][0].dtype == torch.float32
    assert out["c"].dtype == torch.uint8
    np.testing.assert_array_equal(out["c"].numpy(), np.asarray(tree["c"]))
    before = np.array(tree["c"])
    out["c"] += 1                        # writable, not the JAX buffer
    np.testing.assert_array_equal(np.asarray(tree["c"]), before)


@pytest.mark.cuda
def test_cuda_serving_run_goes_through_the_kernels_and_matches_cpu():
    """The reduced qwen3-4b on the card (kernels) against the same weights
    on the CPU (plain versions): prefill and compressed decode."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU form")
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import kv_dequant_attention as kd
    cfg = reduced_config(get_config("qwen3-4b"))
    card = torch.device("cuda", 0)
    tp = T.init_params(cfg, 0, device=CPU)
    cp = _to(tp, card)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (B, S)))
    runs = []
    fa.reset_launch_counts()
    kd.reset_launch_counts()
    for params, dev in ((tp, CPU), (cp, card)):
        lp, cache = T.forward_prefill(cfg, params, toks[:, :S - STEPS].to(dev),
                                      max_len=S)
        qc = KV.compress_prefill_cache(cache)
        out = [lp.cpu()]
        for i in range(STEPS):
            pos = S - STEPS + i
            tok = toks[:, pos:pos + 1].to(dev)
            lg, qc = T.forward_decode(cfg, params, tok, qc, pos)
            out.append(lg.cpu())
        runs.append(out)
    assert fa.launch_counts["flash_attention"] == cfg.n_layers
    assert kd.launch_counts["kv_dequant_decode_attention"] == \
        cfg.n_layers * STEPS
    for a, b in zip(*runs):
        assert float((a - b).abs().max()) < LOGIT_RTOL * float(a.abs().max())


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(v, dev) for v in tree)
    return tree.to(dev)
