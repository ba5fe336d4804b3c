"""Sliding-window attention, ring caches and gemma3-12b on the port (ROADMAP
A12b) against the JAX package: a reduced gemma3-12b (12 layers of 5 local
: 1 global, hd 16, window 8) with ``repro``'s weights carried across by
``lm_params_from_numpy``, a 12-token prompt (longer than the window, so
prefill's window binds and the local layers' caches are rings) and 8
decode steps that wrap the rings again.

Tolerances.  In f32 the port computes ``repro``'s function: train,
prefill and raw decode agree to 1e-6·max|ref| (measured 4.3e-7 to 6.2e-7
on a CPU container), held at 1e-4.  Compressed decode rounds as
``repro``'s does (K/V and the probabilities to bf16, the attention output
to bf16: ``repro`` dequantizes the cache to bf16 whatever the model's
dtype): measured at most 4.71e-7·max|ref| over the 8 steps on a CPU
container at 1, 2 and 6 threads, held at 1.5e-6 (it was 0.94% while the
port's B11 rounded nothing for an f32 q; ROADMAP queue C).  In bf16,
the dtype served, 12 layers of rounding in two frameworks' orders (XLA's
CPU backend also rounds each op of ``jax.nn.silu`` to bf16) put the two
1.2% to 2.7% apart, and ``repro``'s own bf16 run lies 0.9% to 1.8% from its
f32 run of the same weights (3 seeds): held at 4e-2.  Codes of the
compressed cache are held to the measured ``quantize_kv`` tolerance
(``tests/test_torch_serving_slice.py``)."""
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.interop import lm_cache_from_numpy, lm_params_from_numpy
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import kv_dequant_attention as kd
from repro_torch.kernels import ref
from repro_torch.models import attention as A
from repro_torch.models import transformer as T
from repro_torch.serving import kvcache as KV

CPU = torch.device("cpu")
ARCH = "gemma3-12b"
B, PROMPT, STEPS = 2, 12, 8
MAX_LEN = PROMPT + STEPS
TOL = {"float32": 1e-4, "bfloat16": 4e-2}
# f32: 3x the measured 4.71e-7 (see the docstring)
COMPRESSED_TOL = {"float32": 1.5e-6, "bfloat16": 4e-2}
CODE_DIFF_SHARE = 2e-4         # tests/test_torch_serving_slice.py's


@pytest.fixture(scope="module")
def J():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jget
    from repro.configs import reduced_config as jreduced
    from repro.models import attention as JA
    from repro.models import transformer as JT
    from repro.serving import kvcache as JKV
    return types.SimpleNamespace(jax=jax, jnp=jnp, get_config=jget,
                                 reduced_config=jreduced, A=JA, T=JT, KV=JKV)


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def model(request, J):
    """(dtype name, JAX cfg, port cfg, JAX params, port params, tokens)."""
    jcfg = J.reduced_config(J.get_config(ARCH))
    tcfg = reduced_config(get_config(ARCH))
    jp = J.T.init_params(jcfg, J.jax.random.PRNGKey(3),
                         dtype=getattr(J.jnp, request.param))
    tp = lm_params_from_numpy(J.jax.tree.map(np.asarray, jp), CPU)
    toks = np.random.default_rng(0).integers(0, jcfg.vocab, (B, MAX_LEN)) \
        .astype(np.int32)
    return request.param, jcfg, tcfg, jp, tp, toks


def _rel(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _tok(toks, lo, hi=None):
    return torch.from_numpy(toks[:, lo:hi]).long()


def test_reduced_config_is_the_slice_the_tests_name():
    cfg = reduced_config(get_config(ARCH))
    assert (cfg.n_layers, cfg.hd, cfg.sliding_window) == (12, 16, 8)
    assert cfg.pattern == ("attn_local",) * 5 + ("attn",)
    assert PROMPT > cfg.sliding_window
    T.check_supported(cfg)


def test_train_prefill_and_raw_decode_match_repro(J, model):
    dt, jcfg, tcfg, jp, tp, toks = model
    jnp = J.jnp
    ref_train = np.asarray(J.T.forward_train(jcfg, jp, jnp.asarray(toks)))
    assert _rel(T.forward_train(tcfg, tp, _tok(toks, 0)), ref_train) < TOL[dt]
    jlp, jc = J.T.forward_prefill(jcfg, jp, jnp.asarray(toks[:, :PROMPT]),
                                  max_len=MAX_LEN)
    tlp, tc = T.forward_prefill(tcfg, tp, _tok(toks, 0, PROMPT),
                                max_len=MAX_LEN)
    assert _rel(tlp, jlp) < TOL[dt]
    for i in range(STEPS):
        pos = PROMPT + i
        jlg, jc = J.T.forward_decode(jcfg, jp, jnp.asarray(
            toks[:, pos:pos + 1]), jc, pos)
        tlg, tc = T.forward_decode(tcfg, tp, _tok(toks, pos, pos + 1), tc,
                                   pos)
        assert _rel(tlg, jlg) < TOL[dt], (dt, pos)
    # the rings after the steps: every leaf against repro's
    for jl, tl in zip(J.jax.tree.leaves(jc), _leaves(tc)):
        assert tuple(tl.shape) == jl.shape
        assert _rel(tl.float(), jl) < TOL[dt]


def test_compressed_decode_matches_repro(J, model):
    dt, jcfg, tcfg, jp, tp, toks = model
    jnp = J.jnp
    _, jc = J.T.forward_prefill(jcfg, jp, jnp.asarray(toks[:, :PROMPT]),
                                max_len=MAX_LEN)
    _, tc = T.forward_prefill(tcfg, tp, _tok(toks, 0, PROMPT),
                              max_len=MAX_LEN)
    jq, tq = J.KV.compress_prefill_cache(jc), KV.compress_prefill_cache(tc)
    step = KV.make_compressed_decode_step(tcfg)
    for i in range(STEPS):
        pos = PROMPT + i
        jlg, jq = J.T.forward_decode(jcfg, jp, jnp.asarray(
            toks[:, pos:pos + 1]), jq, pos)
        tlg, tq = step(tp, {"token": _tok(toks, pos, pos + 1), "cache": tq,
                            "pos": pos})
        assert _rel(tlg, jlg) < COMPRESSED_TOL[dt], (dt, pos)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def test_ring_cache_layout_and_compressed_leaves_match_repro(J):
    """Prefill's cache: local layers keep the last W positions, p at slot
    p % W, as repro's (f32: to 1e-5); compressing repro's bf16 prefill
    cache in both packages gives sign bytes equal, codes within one in a
    measured share and scales within 1 ulp, every leaf, rings included."""
    jnp = J.jnp
    jcfg = J.reduced_config(J.get_config(ARCH))
    tcfg = reduced_config(get_config(ARCH))
    toks = np.random.default_rng(4).integers(0, jcfg.vocab, (B, PROMPT)) \
        .astype(np.int32)
    jp = J.T.init_params(jcfg, J.jax.random.PRNGKey(1), dtype=jnp.float32)
    tp = lm_params_from_numpy(J.jax.tree.map(np.asarray, jp), CPU)
    _, jc = J.T.forward_prefill(jcfg, jp, jnp.asarray(toks), max_len=MAX_LEN)
    _, tc = T.forward_prefill(tcfg, tp, _tok(toks, 0), max_len=MAX_LEN)
    W = tcfg.sliding_window
    for i, kind in enumerate(tcfg.pattern):
        want = W if kind == "attn_local" else MAX_LEN
        for key in ("k", "v"):
            jl, tl = np.asarray(jc["units"][i][key]), tc["units"][i][key]
            assert tl.shape[2] == want
            np.testing.assert_allclose(tl.numpy(), jl, rtol=1e-5, atol=1e-5)
    jb = J.T.init_params(jcfg, J.jax.random.PRNGKey(1))
    _, jc = J.T.forward_prefill(jcfg, jb, jnp.asarray(toks), max_len=MAX_LEN)
    jq = J.KV.compress_prefill_cache(jc)
    tq = KV.compress_prefill_cache(lm_cache_from_numpy(
        J.jax.tree.map(np.asarray, jc), CPU))
    n = diff = 0
    for jentry, tentry in zip(jq["units"], tq["units"]):
        assert sorted(jentry) == sorted(tentry)
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


def test_prefill_ring_holds_position_p_at_slot_p_mod_w():
    """Port alone, exactly: a local layer's ring after a prompt of S > W
    holds the k of position p (from a windowless prefill of the same
    weights, whose layer-0 k does not depend on the window) at slot p % W
    for the last W positions."""
    cfg = reduced_config(get_config(ARCH))
    params = T.init_params(cfg, 0, device=CPU)
    W = cfg.sliding_window
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab, (B, PROMPT)))
    _, ring = T.forward_prefill(cfg, params, toks, max_len=MAX_LEN)
    _, flat = T.forward_prefill(cfg.with_(sliding_window=MAX_LEN), params,
                                toks, max_len=MAX_LEN)
    k_ring, k_flat = ring["units"][0]["k"][0], flat["units"][0]["k"][0]
    assert k_ring.shape[1] == W and k_flat.shape[1] == MAX_LEN
    for p in range(PROMPT - W, PROMPT):
        assert torch.equal(k_ring[:, p % W], k_flat[:, p])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,W,hd", [(12, 8, 16), (40, 8, 32), (33, 5, 16),
                                    (16, 16, 64), (24, 1, 16)])
def test_windowed_b10_plain_version_matches_repro_masked_attention(
        J, dtype, S, W, hd):
    """flash_attention_gqa(window=W) on the CPU (B10's plain version)
    against repro's attention core with attention_full's mask (causal and
    i - j < W; _gqa_scores, softmax, _gqa_out), GQA 4/2 heads; f32 at the
    Pallas tests' 2e-4, bf16 within one bf16 step of the output."""
    jnp = J.jnp
    rng = np.random.default_rng(S * W + hd)
    q, k, v = (rng.standard_normal((2, S, h, hd)) for h in (4, 2, 2))
    jdt = getattr(jnp, dtype)
    jq, jk, jv = (jnp.asarray(x, jdt) for x in (q, k, v))
    cfg = types.SimpleNamespace(n_kv_heads=2, n_rep=2)
    s = J.A._gqa_scores(jq, jk, cfg)
    i = jnp.arange(S)[:, None]
    j = jnp.arange(S)[None, :]
    s = jnp.where(((i >= j) & (i - j < W))[None, None, None], s, ref.NEG_INF)
    want = np.asarray(J.A._gqa_out(J.jax.nn.softmax(s, axis=-1), jv, cfg)
                      .astype(jnp.float32)).reshape(2, S, 4, hd)
    tq, tk, tv = (torch.from_numpy(np.array(x.astype(jnp.float32)))
                  .to(getattr(torch, dtype)) for x in (jq, jk, jv))
    got = fa.flash_attention_gqa(tq, tk, tv, window=W).float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    else:
        lim = 2.0 ** -7 * np.maximum(np.abs(got), np.abs(want)) + 1e-6
        assert (np.abs(got - want) <= lim).all()


@pytest.mark.parametrize("S,W", [(16, 8), (32, 8), (24, 4)])
def test_banded_path_equals_banded_window_attention(J, S, W):
    """cfg.banded_local_attn takes the same windowed B10 call:
    attention_full with it (S a multiple of W, S >= 2W: where repro takes
    _banded_window_attention) against repro's attention_full, and the
    windowed core against _banded_window_attention itself (f32)."""
    jnp = J.jnp
    jcfg = J.reduced_config(J.get_config(ARCH)).with_(banded_local_attn=True)
    tcfg = reduced_config(get_config(ARCH)).with_(banded_local_attn=True)
    from repro.models.layers import Param
    jp = J.A.init_attn_params(Param(J.jax.random.PRNGKey(7)), jcfg,
                              dtype=jnp.float32)
    tp = lm_params_from_numpy(J.jax.tree.map(np.asarray, jp), CPU)
    x = np.random.default_rng(S + W).standard_normal((2, S, jcfg.d_model))
    jx = jnp.asarray(x, jnp.float32)
    want, _ = J.A.attention_full(jx, jp, jcfg, jnp.arange(S), window=W)
    got, _ = A.attention_full(torch.from_numpy(x).float(), tp, tcfg,
                              torch.arange(S), window=W)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)
    rng = np.random.default_rng(W)
    hd, G, rep = jcfg.hd, jcfg.n_kv_heads, jcfg.n_rep
    q = rng.standard_normal((2, S, G * rep, hd)).astype(np.float32)
    k, v = (rng.standard_normal((2, S, G, hd)).astype(np.float32)
            for _ in range(2))
    band = np.asarray(J.A._banded_window_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jcfg, W))
    core = fa.flash_attention_gqa(*(torch.from_numpy(a) for a in (q, k, v)),
                                  window=W)
    np.testing.assert_allclose(core.reshape(2, S, -1).numpy(), band,
                               rtol=2e-4, atol=2e-4)


def _cache(rng, B_, T_, G, hd):
    leaves = []
    for _ in range(2):
        qz = KV.quantize_kv(torch.from_numpy(
            rng.standard_normal((B_, T_, G, hd))).bfloat16())
        leaves += [qz["codes"], qz["signs"], qz["scale"]]
    return leaves


def _windowed_attention(q, k, v, keep):
    """f32 softmax attention of q (B, 1, Hq, hd) over k/v (B, n, G, hd),
    keys where ``keep`` (n,)."""
    B_, _, Hq, hd = q.shape
    G = k.shape[2]
    qh = q[:, 0].reshape(B_, G, Hq // G, hd).float()
    s = torch.einsum("bgrd,btgd->bgrt", qh, k.float()) * hd ** -0.5
    s = torch.where(keep, s, ref.NEG_INF)
    out = torch.einsum("bgrt,btgd->bgrd", torch.softmax(s, -1), v.float())
    return out.reshape(B_, 1, Hq, hd)


@pytest.mark.parametrize("W,pos", [(8, 3), (8, 7), (8, 8), (8, 21),
                                   (16, 100)])
def test_b11_needs_no_window_on_a_ring(W, pos):
    """A local layer's ring (T = W, token p at slot p % W): B11 over it,
    with no window, equals attention over the unrolled tokens 0..pos with
    the window mask pos - p < W (f32 q, so nothing is rounded)."""
    rng = np.random.default_rng(W + pos)
    G, hd = 2, 16
    logical = _cache(rng, 2, pos + 1, G, hd)         # token p at index p
    ring = [torch.zeros((2, W) + t.shape[2:], dtype=t.dtype)
            for t in logical]
    p = torch.arange(max(0, pos + 1 - W), pos + 1)
    for r, t in zip(ring, logical):
        r[:, p % W] = t[:, p]
    q = torch.from_numpy(rng.standard_normal((2, 1, 2 * G, hd))).float()
    got = kd.kv_dequant_decode_attention_gqa(
        q, *ring, torch.tensor(pos, dtype=torch.int32), window=W)
    k = ref.kv_dequant_ref(*logical[:3])
    v = ref.kv_dequant_ref(*logical[3:])
    keep = pos - torch.arange(pos + 1) < W
    torch.testing.assert_close(got, _windowed_attention(q, k, v, keep),
                               rtol=1e-5, atol=1e-6)


def test_b11_needs_no_window_on_a_cache_shorter_than_it():
    """A local layer's cache of max_len < W slots: pos - j < W never
    binds, so B11's j <= pos is the windowed mask; a windowed cache longer
    than W raises."""
    rng = np.random.default_rng(9)
    T_, W = 12, 32
    leaves = _cache(rng, 2, T_, 2, 16)
    q = torch.from_numpy(rng.standard_normal((2, 1, 4, 16))).float()
    k, v = ref.kv_dequant_ref(*leaves[:3]), ref.kv_dequant_ref(*leaves[3:])
    for pos in (0, 5, 11):
        j = torch.arange(T_)
        keep = (j <= pos) & (pos - j < W)
        torch.testing.assert_close(
            kd.kv_dequant_decode_attention_gqa(q, *leaves, pos, window=W),
            _windowed_attention(q, k, v, keep), rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="at most W slots"):
        kd.kv_dequant_decode_attention_gqa(q, *leaves, 3, window=8)
    with pytest.raises(ValueError, match="at most W slots"):
        ref.kv_dequant_decode_attention_gqa_ref(q, *leaves, 3, window=8)


def test_decode_caches_and_pos_checks_follow_the_ring():
    """init_decode_cache gives local layers min(max_len, W) slots; a host
    pos past max_len is refused only by a cache that is not a ring."""
    cfg = reduced_config(get_config(ARCH))
    W = cfg.sliding_window
    for max_len, want in ((20, W), (5, 5)):
        cache = T.init_decode_cache(cfg, 1, max_len, device=CPU)
        lens = [c["k"].shape[2] for c in cache["units"]]
        assert lens == [want] * 5 + [max_len]
    only_local = cfg.with_(pattern=("attn_local",), n_layers=2)
    ring = T.init_decode_cache(only_local, 1, 40, device=CPU)
    assert T.check_decode_pos(only_local, ring, 1000) == 1000
    with pytest.raises(ValueError, match="do not fit"):
        T.check_decode_pos(cfg, T.init_decode_cache(cfg, 1, 20, device=CPU),
                           20)


def test_full_gemma3_params_on_meta_match_the_jax_tree(J):
    """init_params at full size on the meta device: every leaf's shape and
    dtype equal the JAX package's; 11,765,419,776 elements, which is
    param_count() (11,765,391,360) plus the qk-norm and final-norm scales
    it leaves out (48 * 2 * 256 + 3840)."""
    cfg = get_config(ARCH)
    tp = T.init_params(cfg, device=torch.device("meta"))
    jshape = J.jax.eval_shape(
        lambda: J.T.init_params(J.get_config(ARCH), J.jax.random.PRNGKey(0)))
    jl = J.jax.tree_util.tree_flatten_with_path(jshape)[0]
    tl = J.jax.tree_util.tree_flatten_with_path(tp)[0]
    assert [p for p, _ in tl] == [p for p, _ in jl]
    for (path, t), (_, j) in zip(tl, jl):
        assert tuple(t.shape) == tuple(j.shape), path
        assert str(t.dtype).split(".")[-1] == str(j.dtype), path
    n = sum(t.numel() for _, t in tl)
    assert n == 11_765_419_776
    assert cfg.param_count() == 11_765_391_360
    assert n == cfg.param_count() + cfg.n_layers * 2 * cfg.hd + cfg.d_model
    cache = T.init_decode_cache(cfg, 8, 4096, device=torch.device("meta"))
    nbytes = [sum(c[k].numel() * 2 for k in ("k", "v"))
              for c in cache["units"]]
    assert sum(nbytes[:5]) == 2_684_354_560 and nbytes[5] == 2_147_483_648
    assert KV.kv_bytes_ratio(256) == pytest.approx(1.7534, abs=1e-4)


# -- on the card ------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU form")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("B_,S,Hq,G,hd,W", [
    (2, 300, 4, 2, 256, 64), (1, 1000, 8, 4, 256, 0), (2, 257, 2, 1, 256, 1),
    (1, 700, 4, 2, 128, 100), (2, 96, 4, 2, 64, 17), (1, 2048, 2, 1, 256,
                                                       1024)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_windowed_flash_kernel_matches_its_plain_version(card, B_, S, Hq,
                                                              G, hd, W, dtype):
    """B10 at hd 256 and with a window (tiles skipped and masked at the
    window's edge, a window of 1, one wider than some blocks) against its
    plain version: f32 at 2e-4, bf16 within the bf16 bound."""
    g = torch.Generator(device=card).manual_seed(S + W + hd)
    qkv = torch.randn((B_, S, Hq + 2 * G, hd), generator=g, device=card)
    qkv = qkv.to(getattr(torch, dtype))
    q, k, v = qkv[:, :, :Hq], qkv[:, :, Hq:Hq + G], qkv[:, :, Hq + G:]
    fa.reset_launch_counts()
    got = fa.flash_attention_gqa(q, k, v, window=W)
    assert fa.launch_counts["flash_attention"] == 1
    want = ref.flash_attention_gqa_ref(q, k, v, True, W)
    if dtype == "float32":
        torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)
    else:
        lim = 2.0 ** -8 * v.float().abs().max() + 2.0 ** -7 * torch.maximum(
            got.float().abs(), want.float().abs())
        assert bool(((got.float() - want.float()).abs() <= lim).all())


@pytest.mark.cuda
@pytest.mark.parametrize("T_,pos,q_dtype", [
    (1024, 1023, "bfloat16"), (1024, 5000, "bfloat16"), (4096, 2065, "float32"),
    (4096, 2065, "bfloat16"), (300, 64, "float32"), (4096, 0, "bfloat16")])
def test_cuda_b11_at_hd_256_with_a_device_pos(card, T_, pos, q_dtype):
    """B11 at hd 256 (gemma3's global layers and rings) with pos a 0-d
    int32 tensor on the card, against its plain version; the same launch
    with the grid a host int would size (splits at live) agrees bit for
    bit."""
    g = torch.Generator(device=card).manual_seed(T_ + pos)
    leaves = []
    for _ in range(2):
        qz = KV.quantize_kv(torch.randn((2, T_, 2, 256), generator=g,
                                        device=card).bfloat16())
        leaves += [qz["codes"], qz["signs"], qz["scale"]]
    q = torch.randn((2, 1, 4, 256), generator=g, device=card) \
        .to(getattr(torch, q_dtype))
    dpos = torch.tensor(pos, dtype=torch.int32, device=card)
    got = kd.kv_dequant_decode_attention_gqa(q, *leaves, dpos)
    want = ref.kv_dequant_decode_attention_gqa_ref(q, *leaves, dpos)
    if q_dtype == "float32":
        torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)
    else:
        v = ref.kv_dequant_ref(*leaves[3:])
        lim = 2.0 ** -8 * v.abs().max() + 2.0 ** -7 * torch.maximum(
            got.abs(), want.abs())
        assert bool(((got - want).abs() <= lim).all())
    qh = q[:, 0].unflatten(1, (2, 2))
    heads = tuple(t.transpose(1, 2) for t in leaves)
    host = kd._launch(qh, heads, dpos, card,
                      grid_live=min(T_, pos + 1)).reshape(got.shape)
    assert torch.equal(host, got)


#: the reduced gemma3 on the card through the kernels, against the same run
#: with the kernels' plain versions patched in (on the card) and against
#: the CPU run, of max|logits| at every step.  f32 weights take the
#: kernels' f32 arithmetic (split TF32 in B10), and compressed decode
#: rounds K/V, p and its output to bf16 as repro's does, B11's KV_BF16
#: build rounding p after its normalisation as its plain version does: up
#: to 1.62e-3 against both (one H100; 1.8e-3 before that rounding), where a
#: pwrel code flips at a rounding tie between the two runs' keys and moves
#: one key element by 4.5%.  bf16, the served dtype: 12 layers of
#: rounding carry the kernels' unnormalised-P rounding (2^-8 max|v| an
#: attention call) to 2.2%-2.3% (one H100), as they carry the CPU's other
#: GEMM order to 1.2%-2.7% between the packages.
CARD_TOL = {"float32": (1e-2, 1e-2), "bfloat16": (4e-2, 4e-2)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_reduced_gemma3_on_the_card_matches_cpu(card, dtype):
    """The reduced gemma3-12b on the card through the kernels (windowed
    B10, B11 on rings) against the same run on the card with the two
    kernels' plain versions patched in, and against the CPU run: prefill
    and compressed decode past the window; 12 B10 launches, 12 B11 a step
    (CARD_TOL)."""
    from unittest import mock
    cfg = reduced_config(get_config(ARCH))
    tp = T.init_params(cfg, 0, dtype=getattr(torch, dtype), device=CPU)
    cp = _to(tp, card)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (B, MAX_LEN)))

    def run(params, dev):
        lp, cache = T.forward_prefill(cfg, params, toks[:, :PROMPT].to(dev),
                                      max_len=MAX_LEN)
        qc = KV.compress_prefill_cache(cache)
        out = [lp.cpu()]
        for i in range(STEPS):
            pos = PROMPT + i
            lg, qc = T.forward_decode(cfg, params,
                                      toks[:, pos:pos + 1].to(dev), qc, pos)
            out.append(lg.cpu())
        return out

    fa.reset_launch_counts()
    kd.reset_launch_counts()
    kernels = run(cp, card)
    assert fa.launch_counts["flash_attention"] == cfg.n_layers
    assert kd.launch_counts["kv_dequant_decode_attention"] == \
        cfg.n_layers * STEPS
    with mock.patch.object(A, "flash_attention_gqa",
                           ref.flash_attention_gqa_ref), \
            mock.patch.object(KV, "kv_dequant_decode_attention_gqa",
                              ref.kv_dequant_decode_attention_gqa_ref):
        plain = run(cp, card)
    on_cpu = run(tp, CPU)
    def rel(others):
        return max(float((a - b).abs().max()) / float(a.abs().max())
                   for a, b in zip(kernels, others))

    to_plain, to_cpu = CARD_TOL[dtype]
    assert rel(plain) < to_plain and rel(on_cpu) < to_cpu, \
        (rel(plain), rel(on_cpu))


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(v, dev) for v in tree)
    return tree.to(dev)
