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


#: the H100 build of B11's partial kernel: the blocks it runs at once (132
#: SMs, two blocks an SM), tokens a tile and query rows a block (the
#: library reports them to kd.grid on a card; here they are stated)
H100_SLOTS, H100_TILE, H100_ROWS = 264, 128, 4


def _tiled_gqa(q, leaves, pos, slots, tile=H100_TILE):
    """ref.kv_dequant_decode_attention_tiled_ref in the serving layout, on
    the spans the kernel takes for ``slots`` blocks at once."""
    B, _, Hq, hd = q.shape
    T, G = leaves[0].shape[1:3]
    _, span = kd.splits(B * G * -(-(Hq // G) // H100_ROWS),
                        min(T, pos + 1), slots, tile)
    out = ref.kv_dequant_decode_attention_tiled_ref(
        q[:, 0].unflatten(1, (G, Hq // G)),
        *(t.transpose(1, 2) for t in leaves), pos, span, tile)
    return out.reshape(B, 1, Hq, hd)


@pytest.mark.parametrize("B,T,G,rep,hd,pos", KVDQ_BF16_CASES)
@pytest.mark.parametrize("slots", [H100_SLOTS, 4])
def test_emulated_kvdq_bf16_kernel_within_the_bound(J, B, T, G, rep, hd,
                                                    pos, slots):
    """The kernel's bf16 arithmetic, as its plain version in its own order
    (ref.kv_dequant_decode_attention_tiled_ref: K/V rounded to bf16, f32
    scores, p rounded to bf16 relative to each block's running max over
    its tiles, the splits combined), on the H100's grid and on one of few
    splits with long spans, against the plain version within bf16_bound
    (measured here: max |Δ| <= 4.9e-4·max|v|, against the bound's
    2^-8·max|v| = 3.9e-3)."""
    _, _, _, leaves, q = _serving_inputs(J, B, T, G, rep, hd, pos)
    got = _tiled_gqa(q, leaves, pos, slots)
    want = kd.kv_dequant_decode_attention_gqa(q, *leaves, pos)
    assert bf16_bound(got, want, ref.kv_dequant_ref(*leaves[3:]))


@pytest.mark.parametrize("B,T,G,rep,hd,pos", KVDQ_BF16_CASES)
@pytest.mark.parametrize("slots,tile", [(H100_SLOTS, H100_TILE), (4, 64),
                                        (1, 1 << 20)])
def test_tiled_plain_version_equals_the_plain_one_for_an_f32_q(
        J, B, T, G, rep, hd, pos, slots, tile):
    """For an f32 q nothing is rounded, so the plain version in the
    kernel's order (spans, tiles, running max, the spans combined) is the
    plain version up to f32 sums in another order: on the H100's grid, on
    few spans of short tiles and on one tile of every token."""
    _, _, _, leaves, q = _serving_inputs(J, B, T, G, rep, hd, pos)
    q = q.float()
    torch.testing.assert_close(
        _tiled_gqa(q, leaves, pos, slots, tile),
        kd.kv_dequant_decode_attention_gqa(q, *leaves, pos),
        rtol=1e-5, atol=1e-6)


# -- kv_dtype: the compressed decode of an f32 model rounds as repro's -------

def _kvdq_ref_before_kv_dtype(q, codes_k, signs_k, scale_k, codes_v,
                              signs_v, scale_v, pos):
    """ref.kv_dequant_decode_attention_ref as it stood before it took
    ``kv_dtype``, frozen here: K/V and p rounded to bf16 for a bf16 q
    only."""
    k = ref.kv_dequant_ref(codes_k, signs_k, scale_k)
    v = ref.kv_dequant_ref(codes_v, signs_v, scale_v)
    p_dtype = None
    if q.dtype == torch.bfloat16:
        k, v = k.bfloat16().float(), v.bfloat16().float()
        p_dtype = torch.bfloat16
    mask = torch.arange(codes_k.shape[-2]) <= pos
    return ref._attend(q.float(), k, v, mask, p_dtype)


@pytest.mark.parametrize("B,T,G,rep,hd,pos", KVDQ_BF16_CASES)
def test_kvdq_plain_versions_without_kv_dtype_are_unchanged(J, B, T, G, rep,
                                                            hd, pos):
    """``kv_dtype=None`` (the default) keeps the plain versions what they
    were, bit for bit, for an f32 and a bf16 q: an f32 q stays f32
    throughout (the Pallas kernel's semantics); and a bf16 q rounds the
    same with ``kv_dtype=torch.bfloat16`` as without."""
    _, _, _, leaves, qb = _serving_inputs(J, B, T, G, rep, hd, pos)
    heads = [t.transpose(1, 2) for t in leaves]
    for q in (qb.float(), qb):
        qh = q[:, 0].unflatten(1, (G, rep))
        want = _kvdq_ref_before_kv_dtype(qh, *heads, pos)
        for kw in ({}, {"kv_dtype": None}):
            assert torch.equal(
                ref.kv_dequant_decode_attention_ref(qh, *heads, pos, **kw),
                want)
            assert torch.equal(
                kd.kv_dequant_decode_attention_gqa(q, *leaves, pos, **kw),
                want.reshape(B, 1, G * rep, hd))
        _, span = kd.splits(B * G, min(T, pos + 1), H100_SLOTS, H100_TILE)
        tiled = ref.kv_dequant_decode_attention_tiled_ref(
            qh, *heads, pos, span, H100_TILE)
        assert torch.equal(tiled, ref.kv_dequant_decode_attention_tiled_ref(
            qh, *heads, pos, span, H100_TILE, kv_dtype=None))
    assert torch.equal(
        kd.kv_dequant_decode_attention_gqa(qb, *leaves, pos),
        kd.kv_dequant_decode_attention_gqa(qb, *leaves, pos,
                                           kv_dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="kv_dtype"):
        kd.kv_dequant_decode_attention_gqa(qb.float(), *leaves, pos,
                                           kv_dtype=torch.float16)


@pytest.mark.parametrize("B,T,G,rep,hd,pos", KVDQ_BF16_CASES)
def test_kvdq_kv_dtype_rounds_an_f32_q_as_repro(J, B, T, G, rep, hd, pos):
    """An f32 q with ``kv_dtype=torch.bfloat16`` rounds the dequantized
    K/V and the probabilities to bf16 (q stays f32), as repro's serving
    decode of an f32 model does: rounded to bf16 as repro's output is, it
    equals repro's core in all but a few elements (measured on these
    inputs: 5 of 4,480, all in one case, max |Δ| 2^-10, one bf16 step),
    where the f32 default differs in 50% to 58%.  Its form in the
    kernel's order lies within the bf16 bound."""
    jk, jv, jq, leaves, qb = _serving_inputs(J, B, T, G, rep, hd, pos)
    q = qb.float()
    want = _repro_decode_core(J, jk, jv, jq.astype(J.jnp.float32), pos)
    got = kd.kv_dequant_decode_attention_gqa(q, *leaves, pos,
                                             kv_dtype=torch.bfloat16)
    assert got.dtype == torch.float32
    new = got.bfloat16().float().numpy()
    old = kd.kv_dequant_decode_attention_gqa(q, *leaves, pos) \
        .bfloat16().float().numpy()
    d_new, d_old = np.abs(new - want), np.abs(old - want)
    assert int((d_new != 0).sum()) <= 5
    assert float((d_old != 0).mean()) >= 0.3
    assert d_new.max() <= 2.0 ** -10
    heads = [t.transpose(1, 2) for t in leaves]
    qh = q[:, 0].unflatten(1, (G, rep))
    _, span = kd.splits(B * G, min(T, pos + 1), H100_SLOTS, H100_TILE)
    tiled = ref.kv_dequant_decode_attention_tiled_ref(
        qh, *heads, pos, span, H100_TILE, kv_dtype=torch.bfloat16)
    assert bf16_bound(tiled.reshape(got.shape), got,
                      ref.kv_dequant_ref(*leaves[3:]))


@pytest.mark.parametrize("blocks,live,slots,tile", [
    (64, 4096, 264, 128), (64, 2049, 264, 128), (64, 2080, 264, 128),
    (2, 65, 264, 128), (2, 64, 264, 128), (1, 1, 264, 128),
    (300, 4096, 264, 128), (8, 4096, 264, 128), (12, 1000, 5, 128),
    (64, 4096, 264, 64), (7, 333, 40, 32)])
def test_splits_cover_the_live_tokens_in_whole_tiles(blocks, live, slots,
                                                     tile):
    """The kernel's grid: spans of whole tiles that cover [0, live) with
    a non-empty last one, as many as fit the card's slots (one at least,
    one a tile at most)."""
    n, span = kd.splits(blocks, live, slots, tile)
    assert span % tile == 0 and span > 0
    assert (n - 1) * span < live <= n * span
    assert 1 <= n <= max(1, slots // blocks)
    assert n <= -(-live // tile)


# -- the kernel's dequantize, emulated on int32 views -------------------------

def _as_i64(x: torch.Tensor) -> torch.Tensor:
    """The bit pattern of an f32 tensor as non-negative int64."""
    return x.view(torch.int32).long() & 0xFFFFFFFF


def _from_i64(b: torch.Tensor) -> torch.Tensor:
    b = torch.where(b >= 2 ** 31, b - 2 ** 32, b)
    return b.to(torch.int32).view(torch.float32)


def _bf16_rne_bits(b: torch.Tensor) -> torch.Tensor:
    """bf16 round to nearest even by integer arithmetic on the bit pattern,
    (x + 0x7fff + bit 16 of x) & 0xffff0000 (uint32): what dequant4's
    cvt.rn.bf16x2.f32 does to each value, kept in its f32 container."""
    return ((b + 0x7FFF + ((b >> 16) & 1)) & 0xFFFF0000) & 0xFFFFFFFF


def _emulated_dequant(codes, signs, scale, bf16: bool) -> torch.Tensor:
    """csrc/attention.cu::dequant4 on int views: d = float(0x4b000000 |
    (c ^ 255)) - 2^23, x = scale - d·step (two f32 roundings), exp2, +0 where
    d = 255, bf16 round to nearest even on the bits, the sign as bit 31."""
    c = codes.long()
    d = _from_i64(0x4B000000 | (c ^ 0xFF)) - 8388608.0
    step = torch.tensor(ref.KV_STEP, dtype=torch.float32)
    x = scale - d * step
    mag = torch.where(d == 255.0, torch.zeros_like(x), torch.exp2(x))
    bits = _as_i64(mag)
    if bf16:
        bits = _bf16_rne_bits(bits)
    shifts = torch.arange(8)
    neg = ((signs.long().unsqueeze(-1) >> shifts) & 1).reshape(codes.shape)
    return _from_i64(bits | neg << 31)


@pytest.mark.parametrize("bf16", [False, True])
def test_kernel_dequantize_equals_the_plain_operations_bit_for_bit(bf16):
    """The magic-number code -> float, the sign by bit 31 and the bf16
    rounding on the bits give the plain version's values bit for bit (bf16:
    rounded as .bfloat16() does) over all 256 codes x both signs x scales
    from -150 to 130; and where the kernel takes ex2.approx.ftz (scales >=
    -100) every exp2 argument of a live code is >= -126, so flushing
    subnormals changes nothing."""
    scales = torch.cat([torch.arange(-150.0, 130.0, 0.25),
                        torch.tensor([-126.0, -110.0, -100.0, -99.75])])
    n = len(scales)
    codes = torch.arange(256).to(torch.uint8).repeat(3 * n, 1)
    signs = torch.zeros((3 * n, 32), dtype=torch.uint8)
    signs[n:2 * n] = 255
    signs[2 * n:] = torch.from_numpy(
        np.random.default_rng(7).integers(0, 256, (n, 32), dtype=np.uint8))
    scale = scales.repeat(3).reshape(-1, 1)
    got = _emulated_dequant(codes, signs, scale, bf16)
    want = ref.kv_dequant_ref(codes, signs, scale)
    if bf16:
        want = want.bfloat16().float()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert bool((got[:n, 0].view(torch.int32) == 0).all()) and bool(
        (got[n:2 * n, 0].view(torch.int32) == -2 ** 31).all())  # +0, -0
    d = 255.0 - torch.arange(1, 256, dtype=torch.float32)
    x = torch.tensor(-100.0) - d * torch.tensor(ref.KV_STEP)
    assert float(x.min()) >= -126.0


def test_integer_bf16_rounding_equals_torch_including_ties():
    """The integer bf16 rounding against .bfloat16() on random bit patterns,
    exact ties (low half 0x8000) with an even and an odd bf16 below them,
    values one step either side of a tie, the largest finite f32 and inf;
    NaN never reaches it (exp2 of a finite argument)."""
    rng = np.random.default_rng(11)
    rand = rng.integers(0, 2 ** 32, 200_000, dtype=np.uint64)
    hi = rng.integers(0, 0x7F7F, 4096, dtype=np.uint64) << 16
    ties = np.concatenate([hi | 0x8000, hi | 0x7FFF, hi | 0x8001,
                           (hi | 0x10000) | 0x8000])
    ends = np.array([0x7F7FFFFF, 0x7F800000, 0x00000001, 0x00008000,
                     0x00018000, 0xFF7FFFFF, 0x80008000], dtype=np.uint64)
    bits = np.concatenate([rand, ties, ends, ends | 0x80000000])
    b = torch.from_numpy(bits.astype(np.int64))
    x = _from_i64(b)
    keep = ~torch.isnan(x)
    got = _from_i64(_bf16_rne_bits(b))[keep]
    want = x[keep].bfloat16().float()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


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
                                       scale, torch.tensor([3]))
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
@pytest.mark.parametrize("BG,T,hd,rep,pos,q_dtype", [
    (2, 64, 32, 2, 63, "float32"), (2, 1000, 64, 4, 999, "float32"),
    (1, 512, 128, 48, 0, "float32"),
    # (tiles of 128 tokens, kKvTile) pos just past a tile (a second split
    # of one token), a tile's last token, rep not a multiple of the
    # kernel's 4 rows, a span's edge of the serve-like grid; bf16 q as
    # serve calls it
    (2, 1000, 128, 4, 128, "float32"), (2, 1000, 128, 4, 127, "bfloat16"),
    (2, 1000, 64, 3, 256, "float32"), (64, 1100, 128, 4, 1024, "bfloat16"),
    (64, 1100, 128, 4, 767, "float32"), (3, 300, 16, 5, 299, "bfloat16")])
def test_cuda_kvdq_kernel_matches_its_plain_version(card, BG, T, hd, rep,
                                                    pos, q_dtype):
    from repro_torch.serving.kvcache import quantize_kv
    g = torch.Generator(device=card).manual_seed(T)
    q = torch.randn((BG, rep, hd), generator=g, device=card) \
        .to(getattr(torch, q_dtype))
    cache = []
    for _ in range(2):
        qz = quantize_kv(torch.randn((BG, T, 1, hd), generator=g,
                                     device=card))
        cache += [qz[f][:, :, 0] for f in ("codes", "signs", "scale")]
    kd.reset_launch_counts()
    got = kd.kv_dequant_decode_attention(q, *cache, pos)
    assert kd.launch_counts["kv_dequant_decode_attention"] == 1
    want = ref.kv_dequant_decode_attention_ref(q, *cache, pos)
    if q_dtype == "bfloat16":
        # within the bf16 bound of the plain version, and far closer to it
        # in the kernel's own order (chip_smoke.py's KV_ORDER_TOL, 2^-15)
        v = ref.kv_dequant_ref(*cache[3:])
        assert bf16_bound(got, want, v)
        _, span, tile = kd.grid(BG, rep, hd, min(T, pos + 1), q.dtype, card)
        torch.testing.assert_close(
            got, ref.kv_dequant_decode_attention_tiled_ref(q, *cache, pos,
                                                           span, tile),
            rtol=0.0, atol=2.0 ** -15 * float(v.abs().max()))
    else:
        torch.testing.assert_close(got, want, **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,G,rep,hd,pos", [
    (2, 1000, 2, 4, 128, 999), (2, 1000, 2, 4, 128, 127),
    (8, 4096, 8, 4, 128, 2050), (1, 600, 4, 3, 64, 517),
    (2, 1024, 8, 2, 256, 1500), (3, 300, 1, 5, 16, 299)])
def test_cuda_kvdq_kv_bf16_build_matches_its_plain_version(card, B, T, G,
                                                           rep, hd, pos):
    """The f32-q build that rounds K/V and p to bf16 (``KV_BF16``, what
    the compressed decode of an f32 model launches; p normalised, in two
    passes) against its plain version within the bf16 bound, and within
    2^-15·max|v| of the plain version in the kernel's order on the
    kernel's own spans."""
    from repro_torch.serving.kvcache import quantize_kv
    g = torch.Generator(device=card).manual_seed(T + hd)
    q = torch.randn((B, 1, G * rep, hd), generator=g, device=card)
    leaves = []
    for _ in range(2):
        qz = quantize_kv(torch.randn((B, T, G, hd), generator=g,
                                     device=card))
        leaves += [qz[f] for f in ("codes", "signs", "scale")]
    kd.reset_launch_counts()
    got = kd.kv_dequant_decode_attention_gqa(q, *leaves, pos,
                                             kv_dtype=torch.bfloat16)
    assert kd.launch_counts["kv_dequant_decode_attention"] == 1
    want = ref.kv_dequant_decode_attention_gqa_ref(q, *leaves, pos,
                                                   kv_dtype=torch.bfloat16)
    v = ref.kv_dequant_ref(*leaves[3:])
    assert bf16_bound(got, want, v)
    _, span, tile = kd.grid(B * G, rep, hd, min(T, pos + 1), q.dtype, card,
                            kv_dtype=torch.bfloat16)
    tiled = ref.kv_dequant_decode_attention_tiled_ref(
        q[:, 0].unflatten(1, (G, rep)),
        *(t.transpose(1, 2) for t in leaves), pos, span, tile,
        kv_dtype=torch.bfloat16)
    torch.testing.assert_close(got, tiled.reshape(got.shape), rtol=0.0,
                               atol=2.0 ** -15 * float(v.abs().max()))
    f32 = kd.kv_dequant_decode_attention_gqa(q, *leaves, pos)
    assert not torch.equal(f32, got)


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
