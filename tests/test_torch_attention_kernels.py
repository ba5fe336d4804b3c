"""The port's attention kernels (B10 flash_attention, B11
kv_dequant_decode_attention) against the JAX package's Pallas kernels in
interpret mode, on the same numpy-seeded inputs, at rtol = atol = 2e-4 (the
Pallas tests' bound).  On the CPU the wrappers run their plain versions;
the `cuda`-marked cases hold the CUDA kernels against those on a card."""
import types

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import kv_dequant_attention as kd
from repro_torch.kernels import ref

TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(scope="module")
def J():
    """The JAX package's side (absent on the card's machine: the tests
    that need it skip there, the `cuda` ones run)."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.kernels.flash_attention import flash_attention
    from repro.kernels.kv_dequant_attention import (
        kv_dequant_decode_attention)
    from repro.models.attention import _gqa_out, _gqa_scores
    from repro.serving.kvcache import dequantize_kv, quantize_kv
    return types.SimpleNamespace(jax=jax, jnp=jnp, flash=flash_attention,
                                 kvdq=kv_dequant_decode_attention,
                                 quantize_kv=quantize_kv,
                                 dequantize_kv=dequantize_kv,
                                 scores=_gqa_scores, out=_gqa_out)


def _t(a):
    return torch.from_numpy(np.array(a))        # a writable copy


def _np(x):
    return np.asarray(x)


@pytest.mark.parametrize("BH,S,hd", [(2, 128, 64), (4, 256, 32),
                                     (1, 512, 128), (3, 96, 16)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_version_matches_pallas(J, BH, S, hd, causal):
    rng = np.random.default_rng(BH * 1000 + S)
    q, k, v = (rng.standard_normal((BH, S, hd)).astype(np.float32)
               for _ in range(3))
    jnp = J.jnp
    want = J.flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   causal=causal, q_tile=64, k_tile=64)
    got = fa.flash_attention(_t(q), _t(k), _t(v), causal=causal)
    assert got.dtype == torch.float32 and got.shape == (BH, S, hd)
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


@pytest.mark.parametrize("B,S,Hq,G,hd", [(2, 40, 8, 2, 16), (1, 100, 4, 1, 32),
                                         (1, 24, 4, 4, 64)])
def test_flash_gqa_form_matches_the_tpu_form_on_replicated_heads(J, B, S, Hq,
                                                                 G, hd):
    """The model layout (strided q/k/v slices, kv head h // rep) against
    the Pallas kernel on a replicated (B*Hq, S, hd) copy."""
    rng = np.random.default_rng(S)
    qkv = rng.standard_normal((B, S, Hq + 2 * G, hd)).astype(np.float32)
    tq = _t(qkv)
    q, k, v = tq[:, :, :Hq], tq[:, :, Hq:Hq + G], tq[:, :, Hq + G:]
    got = fa.flash_attention_gqa(q, k, v)
    rep = Hq // G

    def flat(x, r):       # (B, S, H, hd) -> (B*H*r, S, hd), heads repeated
        x = np.repeat(x, r, axis=2)
        return x.transpose(0, 2, 1, 3).reshape(-1, S, hd)

    jnp = J.jnp
    want = J.flash(jnp.asarray(flat(q.numpy(), 1)),
                   jnp.asarray(flat(k.numpy(), rep)),
                   jnp.asarray(flat(v.numpy(), rep)), causal=True)
    want = _np(want).reshape(B, Hq, S, hd).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    bf = fa.flash_attention_gqa(q.bfloat16(), k.bfloat16(), v.bfloat16())
    assert bf.dtype == torch.bfloat16


def _cache(J, rng, BG, T, hd):
    """(codes, signs, scale) of the JAX package's quantize_kv on seeded
    normals, in the TPU kernel's (BG, T, .) layout, as numpy."""
    kv = J.jnp.asarray(rng.standard_normal((BG, T, 1, hd)), J.jnp.float32)
    qz = J.quantize_kv(kv)
    return tuple(_np(qz[f])[:, :, 0] for f in ("codes", "signs", "scale"))


@pytest.mark.parametrize("BG,T,hd,rep,pos", [
    (2, 64, 32, 2, 63), (4, 128, 64, 1, 100), (1, 256, 16, 4, 17),
    (2, 96, 32, 2, 40), (1, 64, 16, 48, 0),
])
def test_kvdq_plain_version_matches_pallas(J, BG, T, hd, rep, pos):
    rng = np.random.default_rng(BG * 100 + T + pos)
    q = rng.standard_normal((BG, rep, hd)).astype(np.float32)
    cache = _cache(J, rng, BG, T, hd) + _cache(J, rng, BG, T, hd)
    want = J.kvdq(J.jnp.asarray(q), *(J.jnp.asarray(c) for c in cache), pos,
                  k_tile=32)
    got = kd.kv_dequant_decode_attention(_t(q), *(_t(c) for c in cache), pos)
    assert got.dtype == torch.float32 and got.shape == (BG, rep, hd)
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


def test_kvdq_serving_form_reads_views_of_a_stacked_cache(J):
    """The serving layout — one layer's views of a stacked (U, B, T, G, .)
    cache and q (B, 1, Hq, hd) — against the Pallas kernel on a
    rearranged (B*G, T, .) copy of that layer."""
    U, B, T, G, rep, hd, pos = 3, 2, 96, 2, 3, 32, 70
    rng = np.random.default_rng(5)
    leaves = []                  # codes/signs/scale of K, then of V
    for _ in range(2):
        per_layer = [_cache(J, rng, B * G, T, hd) for _ in range(U)]
        for f in range(3):
            leaves.append(np.stack([
                layer[f].reshape(B, G, T, -1).transpose(0, 2, 1, 3)
                for layer in per_layer]))          # (U, B, T, G, .)
    q = rng.standard_normal((B, 1, G * rep, hd)).astype(np.float32)
    u = 1
    views = [_t(x)[u] for x in leaves]
    got = kd.kv_dequant_decode_attention_gqa(_t(q), *views, pos)
    flat = [x[u].transpose(0, 2, 1, 3).reshape(B * G, T, -1) for x in leaves]
    want = J.kvdq(J.jnp.asarray(q.reshape(B * G, rep, hd)),
                  *(J.jnp.asarray(np.ascontiguousarray(c)) for c in flat),
                  pos, k_tile=32)
    np.testing.assert_allclose(got.numpy(),
                               _np(want).reshape(B, 1, G * rep, hd), **TOL)
    bf = kd.kv_dequant_decode_attention_gqa(_t(q).bfloat16(), *views, pos)
    assert bf.dtype == torch.float32


# -- compressed decode with a bf16 q: rounded as repro's serving decode -------

KVDQ_BF16_CASES = [(2, 96, 2, 3, 32, 70), (1, 600, 4, 4, 128, 517),
                   (2, 64, 1, 8, 64, 63), (2, 1000, 2, 4, 64, 999)]


def _serving_inputs(J, B, T, G, rep, hd, pos):
    """repro's quantize_kv of bf16 normals (B, T, G, hd) for K and V and a
    bf16 q (B, 1, Hq, hd), seeded; returns the JAX leaves, the port's
    copies of the six leaves and q."""
    jnp = J.jnp
    rng = np.random.default_rng(T + pos)
    jk, jv = (J.quantize_kv(jnp.asarray(rng.standard_normal((B, T, G, hd)),
                                        jnp.bfloat16)) for _ in range(2))
    jq = jnp.asarray(rng.standard_normal((B, 1, G * rep, hd)), jnp.bfloat16)
    leaves = [_t(d[f]) for d in (jk, jv) for f in ("codes", "signs", "scale")]
    q = _t(jq.astype(jnp.float32)).bfloat16()
    return jk, jv, jq, leaves, q


def _repro_decode_core(J, jk, jv, jq, pos):
    """repro's compressed_attention_decode core: dequantize_kv to bf16,
    _gqa_scores, the j <= pos mask, softmax, _gqa_out (bf16 probabilities
    and output), as (B, 1, Hq, hd) f32 numpy."""
    jnp = J.jnp
    B, _, Hq, hd = jq.shape
    G = jk["codes"].shape[2]
    cfg = types.SimpleNamespace(n_kv_heads=G, n_rep=Hq // G)
    ck, cv = J.dequantize_kv(jk), J.dequantize_kv(jv)
    s = J.scores(jq, ck, cfg)
    T = ck.shape[1]
    s = jnp.where((jnp.arange(T) <= pos)[None, None, None, None], s,
                  ref.NEG_INF)
    out = J.out(J.jax.nn.softmax(s, axis=-1), cv, cfg)
    return np.array(out.astype(jnp.float32)).reshape(B, 1, Hq, hd)


def bf16_bound(got, want, v):
    """The bf16 check of B10 and B11: |got - want| <= 2^-8·max|v| + one
    bf16 step (2^-7) of max(|got|, |want|).  The kernels round unnormalised
    probabilities to bf16 and the plain versions normalised ones.  Each
    rounding is within 2^-8 relative of the exact p (bf16's unit
    roundoff), so P·V could differ by 2^-7·max|v| if every rounding went
    the worst way at once; they do not line up, and the check holds the
    two to half that.  bf16 outputs then round apart by up to one step."""
    got, want = got.float(), want.float()
    lim = 2.0 ** -8 * v.float().abs().max() + \
        2.0 ** -7 * torch.maximum(got.abs(), want.abs())
    return bool(((got - want).abs() <= lim).all())


@pytest.mark.parametrize("B,T,G,rep,hd,pos", KVDQ_BF16_CASES)
def test_kvdq_bf16_plain_version_rounds_as_repro(J, B, T, G, rep, hd, pos):
    """For a bf16 q the plain version rounds the dequantized K/V and the
    probabilities to bf16, as repro's serving decode does.  Measured on
    these inputs: rounded to bf16 as repro's output is, it equals repro's
    core in all but 5 of 4,480 elements (all in one case; max |Δ| 2^-10,
    one bf16 step at an output of 0.13, where one probability rounds
    apart: XLA's and torch's softmax differ by an f32 ulp next to a bf16
    tie), where the f32 version it replaces differs in 2,458 (55%, max
    |Δ| 2^-8)."""
    jk, jv, jq, leaves, q = _serving_inputs(J, B, T, G, rep, hd, pos)
    want = _repro_decode_core(J, jk, jv, jq, pos)
    got = kd.kv_dequant_decode_attention_gqa(q, *leaves, pos)
    assert got.dtype == torch.float32
    new = got.bfloat16().float().numpy()
    old = kd.kv_dequant_decode_attention_gqa(q.float(), *leaves, pos) \
        .bfloat16().float().numpy()
    d_new, d_old = np.abs(new - want), np.abs(old - want)
    assert int((d_new != 0).sum()) <= 5
    assert float((d_old != 0).mean()) >= 0.3
    assert d_new.mean() <= d_old.mean() / 100
    assert d_new.max() <= 2.0 ** -10
    v = ref.kv_dequant_ref(*leaves[3:])
    assert bf16_bound(torch.from_numpy(new), torch.from_numpy(want), v)


@pytest.mark.parametrize("B,T,G,rep,hd,pos", KVDQ_BF16_CASES)
def test_emulated_kvdq_bf16_kernel_within_the_bound(J, B, T, G, rep, hd,
                                                    pos):
    """The kernel's bf16 arithmetic, emulated: K/V rounded to bf16, f32
    scores, per 256-token chunk p = exp(s - m_chunk) rounded to bf16
    unnormalised with the f32 sum of the unrounded p, the chunks combined
    in f32; against the plain version within bf16_bound (measured here:
    max |Δ| <= 4.9e-4·max|v|, against the bound's 2^-8·max|v| = 3.9e-3)."""
    _, _, _, leaves, q = _serving_inputs(J, B, T, G, rep, hd, pos)
    Hq = G * rep
    k, v = (ref.kv_dequant_ref(*leaves[i:i + 3]).bfloat16().float()
            .transpose(1, 2) for i in (0, 3))               # (B, G, T, hd)
    qh = q[:, 0].float().reshape(B, G, rep, hd)
    s = qh @ k.transpose(-1, -2) * hd ** -0.5               # (B, G, rep, T)
    live = min(T, pos + 1)
    ms, sums, accs = [], [], []
    for t0 in range(0, live, kd.CHUNK):
        sc = s[..., t0:min(t0 + kd.CHUNK, live)]
        m = sc.amax(-1, keepdim=True)
        p = torch.exp(sc - m)
        ms.append(m)
        sums.append(p.sum(-1, keepdim=True))
        accs.append(p.bfloat16().float() @ v[:, :, t0:t0 + p.shape[-1]])
    mx = torch.stack(ms).amax(0)
    w = [torch.exp(m - mx) for m in ms]
    out = sum(a * x for a, x in zip(accs, w)) / sum(
        s_ * x for s_, x in zip(sums, w))
    got = out.reshape(B, 1, Hq, hd)
    want = kd.kv_dequant_decode_attention_gqa(q, *leaves, pos)
    assert bf16_bound(got, want, v)


def test_wrappers_reject_bad_operands():
    x = torch.zeros((2, 16, 32))
    with pytest.raises(ValueError, match="equal"):
        fa.flash_attention(x, x, x[:, :8])
    with pytest.raises(ValueError, match="no kernel for device"):
        fa.flash_attention(*(x.to("meta") for _ in range(3)))
    with pytest.raises(ValueError, match="G \\| Hq"):
        fa.flash_attention_gqa(torch.zeros((1, 4, 3, 16)),
                               torch.zeros((1, 4, 2, 16)),
                               torch.zeros((1, 4, 2, 16)))
    codes = torch.zeros((2, 8, 32), dtype=torch.uint8)
    signs = torch.zeros((2, 8, 4), dtype=torch.uint8)
    scale = torch.zeros((2, 8, 1))
    q = torch.zeros((2, 1, 32))
    with pytest.raises(ValueError, match="host int"):
        kd.kv_dequant_decode_attention(q, codes, signs, scale, codes, signs,
                                       scale, torch.tensor(3))
    with pytest.raises(ValueError, match="do not form"):
        kd.kv_dequant_decode_attention(q, codes, signs[:, :, :2], scale,
                                       codes, signs, scale, 3)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU form")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("BH,S,hd,causal", [(2, 128, 64, True),
                                            (3, 96, 16, False),
                                            (2, 1000, 128, True)])
def test_cuda_flash_kernel_matches_its_plain_version(card, BH, S, hd, causal):
    g = torch.Generator(device=card).manual_seed(S)
    q, k, v = torch.randn((3, BH, S, hd), generator=g, device=card)
    fa.reset_launch_counts()
    got = fa.flash_attention(q, k, v, causal=causal)
    assert fa.launch_counts["flash_attention"] == 1
    want = ref.flash_attention_ref(q, k, v, causal)
    torch.testing.assert_close(got, want, **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("BG,T,hd,rep,pos", [(2, 64, 32, 2, 63),
                                             (2, 1000, 64, 4, 999),
                                             (1, 512, 128, 48, 0)])
def test_cuda_kvdq_kernel_matches_its_plain_version(card, BG, T, hd, rep,
                                                    pos):
    from repro_torch.serving.kvcache import quantize_kv
    g = torch.Generator(device=card).manual_seed(T)
    q = torch.randn((BG, rep, hd), generator=g, device=card)
    cache = []
    for _ in range(2):
        qz = quantize_kv(torch.randn((BG, T, 1, hd), generator=g,
                                     device=card))
        cache += [qz[f][:, :, 0] for f in ("codes", "signs", "scale")]
    kd.reset_launch_counts()
    got = kd.kv_dequant_decode_attention(q, *cache, pos)
    assert kd.launch_counts["kv_dequant_decode_attention"] == 1
    want = ref.kv_dequant_decode_attention_ref(q, *cache, pos)
    torch.testing.assert_close(got, want, **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,Hq,G,hd", [(2, 128, 4, 2, 16),
                                         (1, 200, 4, 1, 32),
                                         (2, 96, 8, 8, 64),
                                         (1, 1000, 8, 2, 128),
                                         (1, 77, 2, 1, 128)])
def test_cuda_flash_kernel_bf16_gqa_matches_its_plain_version(card, B, S, Hq,
                                                              G, hd):
    """bf16 q/k/v in the model's layout (slices of one projection, kv head
    h // rep), ragged S included, on the tensor cores."""
    g = torch.Generator(device=card).manual_seed(S + hd)
    qkv = torch.randn((B, S, Hq + 2 * G, hd), generator=g,
                      device=card).bfloat16()
    q, k, v = qkv[:, :, :Hq], qkv[:, :, Hq:Hq + G], qkv[:, :, Hq + G:]
    fa.reset_launch_counts()
    got = fa.flash_attention_gqa(q, k, v)
    torch.cuda.synchronize()
    assert fa.launch_counts["flash_attention"] == 1
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    assert bf16_bound(got, ref.flash_attention_gqa_ref(q, k, v), v)


@pytest.mark.cuda
@pytest.mark.parametrize("BH,S,hd,causal", [(4, 256, 32, True),
                                            (2, 333, 64, False),
                                            (1, 512, 128, True)])
def test_cuda_flash_kernel_f32_on_odd_strides(card, BH, S, hd, causal):
    """f32 q/k/v whose strides are not 16-byte multiples (the kernel's
    element-copy path) against the plain version."""
    g = torch.Generator(device=card).manual_seed(BH + S)
    x = torch.randn((BH, S, 3 * hd + 1), generator=g, device=card)
    q, k, v = x[:, :, :hd], x[:, :, hd:2 * hd], x[:, :, 2 * hd:3 * hd]
    got = fa.flash_attention(q, k, v, causal=causal)
    torch.testing.assert_close(got, ref.flash_attention_ref(q, k, v, causal),
                               **TOL)
