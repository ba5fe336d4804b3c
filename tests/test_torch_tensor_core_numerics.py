"""The arithmetic of the tensor-core kernels, emulated on the CPU.

B6 (``gemm_planes`` at K >= 64) and B10 (``flash_attention``) run their
products on the card's tensor cores (``csrc/gate_apply.cu``,
``csrc/attention.cu``), which cannot run here.  This file emulates what
they compute, in torch on the CPU, and holds it against the JAX package:

* split TF32 for f32 operands: x = big + small, both rounded to TF32
  (nearest, ties away from zero, on the bit pattern of the int32 view:
  ``(bits + 2^12) & ~(2^13 - 1)``), each product as small*big + big*small
  + big*big with f32 sums.  Emulated B6 at K = 64 and 128 is within the
  GEMM tolerance (rtol = atol = 1e-4) of ``repro``'s Pallas ``gemm_planes``
  and emulated f32 B10 within 2e-4 of its Pallas ``flash_attention``
  (interpret mode), while plain TF32 (one product of the rounded
  operands) misses both: the split is what the tolerances rest on;
* bf16 MMAs for bf16 operands: products exact in f32, sums in f32, the
  unnormalised probabilities rounded to bf16 for P·V.  The plain version
  of ``flash_attention_gqa`` now rounds the normalised probabilities to
  bf16, as ``repro.models.attention._gqa_out`` does: it agrees with
  ``repro``'s attention core far more closely than the f32-probability
  version it replaces, and the emulated kernel is within the smoke's bf16
  bound of it (2^-8 max|v| + one bf16 step).
"""
import types

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import gate_apply as tga
from repro_torch.kernels import ref

GATE_ATOL = 1e-4               # chip_smoke.GATE_ATOL; tests/test_kernels.py
ATTN_TOL = 2e-4                # the Pallas flash tests' rtol = atol
LOG2E = 1.4426950408889634


@pytest.fixture(scope="module")
def J():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from repro.kernels.flash_attention import flash_attention
    from repro.kernels.gate_apply import gemm_planes
    from repro.models.attention import _gqa_out, _gqa_scores
    return types.SimpleNamespace(jax=jax, jnp=jnp, flash=flash_attention,
                                 gemm=gemm_planes, scores=_gqa_scores,
                                 out=_gqa_out)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 -> its TF32 rounding (nearest, ties away), in an f32 tensor."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x: torch.Tensor):
    big = tf32(x)
    return big, tf32(x - big)


def mm_split(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in split TF32: three products of TF32 values (exact in f32),
    f32 sums, the small terms first."""
    ab, a_s = split(a)
    bb, b_s = split(b)
    return (a_s @ bb + ab @ b_s) + ab @ bb


def mm_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in plain TF32: one product of the rounded operands."""
    return tf32(a) @ tf32(b)


def test_tf32_rounding_is_nearest_ties_away():
    one = 1.0 + 2.0 ** -10                   # a TF32 value: 10 mantissa bits
    x = torch.tensor([1.0, one, 1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11,
                      -(1.0 + 2.0 ** -11), 1.0 + 2.0 ** -11 - 2.0 ** -23],
                     dtype=torch.float32)
    want = torch.tensor([1.0, one, one, 1.0 + 2 * 2.0 ** -10, -one, 1.0])
    assert torch.equal(tf32(x), want)
    big, small = split(x)
    # the split keeps 22 significant bits: exact for all but the last
    assert torch.equal((big + small)[:5], x[:5])
    assert bool(((big + small - x).abs() <= 2.0 ** -22 * x.abs()).all())
    assert bool((tf32(big) == big).all()) and bool((tf32(small) == small).all())


def _gemm_emulated(mm, ar, ai, br, bi):
    """B6's complex product as the kernel folds it: Cr = Ar Br + (-Ai) Bi,
    Ci = Ar Bi + Ai Br."""
    return mm(ar, br) + mm(-ai, bi), mm(ar, bi) + mm(ai, br)


def _violation(got, want, tol):
    """max(|got - want| - tol·|want|): <= tol passes rtol = atol = tol."""
    return float((np.abs(got - want) - tol * np.abs(want)).max())


@pytest.mark.parametrize("R,K", [(256, 64), (512, 128), (1024, 128)])
def test_split_tf32_gemm_planes_matches_pallas(J, R, K):
    rng = np.random.default_rng(R + K)
    ar, ai = rng.standard_normal((2, R, K)).astype(np.float32)
    br, bi = rng.standard_normal((2, K, K)).astype(np.float32)
    jr, ji = (np.asarray(x) for x in J.gemm(
        *map(J.jnp.asarray, (ar, ai, br, bi)), interpret=True))
    t = [torch.from_numpy(x) for x in (ar, ai, br, bi)]
    cr, ci = _gemm_emulated(mm_split, *t)
    assert max(_violation(cr.numpy(), jr, GATE_ATOL),
               _violation(ci.numpy(), ji, GATE_ATOL)) <= GATE_ATOL
    # the wrapper's plain version on the CPU (the kernel's yardstick on
    # the card) agrees with the emulation as closely
    pr, pi = tga.gemm_planes(*t)
    assert float((pr - cr).abs().max()) <= GATE_ATOL
    assert float((pi - ci).abs().max()) <= GATE_ATOL
    # plain TF32 misses the bound by two orders of magnitude (measured
    # 1.4e-2 to 2.3e-2 over rtol·|want| at these shapes)
    cr1, ci1 = _gemm_emulated(mm_plain, *t)
    assert max(_violation(cr1.numpy(), jr, GATE_ATOL),
               _violation(ci1.numpy(), ji, GATE_ATOL)) > 10 * GATE_ATOL


def _flash_emulated(mm, q, k, v, causal):
    """B10's f32 arithmetic: scores through ``mm``, masked to -2^30,
    p = exp2(s·c - m·c) with c = hd^-0.5·log2 e, P·V through ``mm`` over
    the f32 sum of p."""
    S, hd = q.shape[-2:]
    c = LOG2E / np.sqrt(hd)
    s = mm(q, k.transpose(-1, -2))
    if causal:
        keep = torch.ones((S, S), dtype=torch.bool).tril()
        s = torch.where(keep, s, torch.tensor(ref.NEG_INF))
    m = s.amax(-1, keepdim=True)
    p = torch.exp2(s * c - m * c)
    return mm(p, v) / p.sum(-1, keepdim=True)


@pytest.mark.parametrize("BH,S,hd", [(2, 128, 64), (4, 256, 32),
                                     (1, 512, 128), (3, 96, 16)])
@pytest.mark.parametrize("causal", [True, False])
def test_split_tf32_flash_attention_matches_pallas(J, BH, S, hd, causal):
    """The shapes of tests/test_torch_attention_kernels.py."""
    rng = np.random.default_rng(BH * 1000 + S)
    q, k, v = (rng.standard_normal((BH, S, hd)).astype(np.float32)
               for _ in range(3))
    jnp = J.jnp
    want = np.asarray(J.flash(jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(v), causal=causal, q_tile=64,
                              k_tile=64))
    t = [torch.from_numpy(x) for x in (q, k, v)]
    got = _flash_emulated(mm_split, *t, causal).numpy()
    assert _violation(got, want, ATTN_TOL) <= ATTN_TOL
    if causal:
        # plain TF32 misses 2e-4 (measured 7.0e-4 to 1.0e-3 beyond
        # rtol·|want| on these causal cases)
        plain = _flash_emulated(mm_plain, *t, causal).numpy()
        assert _violation(plain, want, ATTN_TOL) > 2 * ATTN_TOL


def _bf16_inputs(B, S, Hq, G, hd, seed):
    rng = np.random.default_rng(seed)
    qkv = torch.from_numpy(rng.standard_normal(
        (B, S, Hq + 2 * G, hd)).astype(np.float32)).bfloat16()
    return qkv[:, :, :Hq], qkv[:, :, Hq:Hq + G], qkv[:, :, Hq + G:]


def _repro_core(J, q, k, v):
    """repro's attention_full core on bf16 q/k/v: _gqa_scores -> causal
    mask -> softmax -> _gqa_out, as (B, S, Hq, hd) f32 numpy."""
    jnp = J.jnp
    B, S, Hq, hd = q.shape
    G = k.shape[2]
    cfg = types.SimpleNamespace(n_kv_heads=G, n_rep=Hq // G)
    jq, jk, jv = (jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
                  for x in (q, k, v))
    s = J.scores(jq, jk, cfg)
    i, j = jnp.arange(S)[:, None], jnp.arange(S)[None, :]
    s = jnp.where((i >= j)[None, None, None], s, ref.NEG_INF)
    out = J.out(J.jax.nn.softmax(s, axis=-1), jv, cfg)
    return np.asarray(out.astype(jnp.float32)).reshape(B, S, Hq, hd)


def _bf16_bound(got, want, v):
    """chip_smoke's bf16 check: 2^-8 max|v| + one bf16 step (2^-7) of
    max(|got|, |want|)."""
    lim = 2.0 ** -8 * float(v.float().abs().max()) + \
        2.0 ** -7 * np.maximum(np.abs(got), np.abs(want))
    return bool((np.abs(got - want) <= lim).all())


@pytest.mark.parametrize("B,S,Hq,G,hd", [(2, 40, 8, 2, 16),
                                         (1, 100, 4, 1, 32),
                                         (1, 24, 4, 4, 64),
                                         (2, 128, 8, 2, 128)])
def test_bf16_plain_version_rounds_probabilities_as_repro(J, B, S, Hq, G,
                                                          hd):
    """Measured on these inputs: the plain version that rounds P agrees
    with repro's core in all but at most 14 of 262,144 elements (mean
    |Δ| <= 4.3e-7, max 2^-9); the f32-P version it replaces differs in
    12–30% of elements (mean |Δ| 3.0e-4 to 5.2e-4, max 2^-6)."""
    q, k, v = _bf16_inputs(B, S, Hq, G, hd, seed=S)
    want = _repro_core(J, q, k, v)
    new = fa.flash_attention_gqa(q, k, v)
    assert new.dtype == torch.bfloat16
    new = new.float().numpy()
    old = ref.flash_attention_gqa_ref(q.float(), k.float(), v.float()) \
        .bfloat16().float().numpy()
    d_new, d_old = np.abs(new - want), np.abs(old - want)
    assert float((d_new != 0).mean()) <= 1e-3
    assert float((d_old != 0).mean()) >= 0.1
    assert d_new.mean() <= d_old.mean() / 100
    assert d_new.max() <= d_old.max()
    assert _bf16_bound(new, want, v)


@pytest.mark.parametrize("B,S,Hq,G,hd", [(2, 40, 8, 2, 16),
                                         (2, 128, 8, 2, 128),
                                         (1, 300, 4, 1, 64)])
def test_emulated_bf16_kernel_within_the_bf16_bound(B, S, Hq, G, hd):
    """The bf16 kernel's arithmetic (exact products, f32 sums, p =
    exp2(s·c - m·c) rounded to bf16 unnormalised, divided by the f32 sum
    of p) against the plain version within 2^-8 max|v| + one bf16 step."""
    q, k, v = _bf16_inputs(B, S, Hq, G, hd, seed=7 * S)
    rep = Hq // G
    qh = q.float().permute(0, 2, 1, 3)                    # (B, Hq, S, hd)
    kh = k.float().permute(0, 2, 1, 3).repeat_interleave(rep, dim=1)
    vh = v.float().permute(0, 2, 1, 3).repeat_interleave(rep, dim=1)
    c = LOG2E / np.sqrt(hd)
    s = qh @ kh.transpose(-1, -2)
    s = torch.where(torch.ones((S, S), dtype=torch.bool).tril(), s,
                    torch.tensor(ref.NEG_INF))
    m = s.amax(-1, keepdim=True)
    p = torch.exp2(s * c - m * c)
    out = (p.bfloat16().float() @ vh) / p.sum(-1, keepdim=True)
    got = out.bfloat16().float().permute(0, 2, 1, 3).numpy()
    want = ref.flash_attention_gqa_ref(q, k, v).float().numpy()
    assert _bf16_bound(got, want, v)
