"""kernels/ops.py: the port's public kernel wrappers against the JAX
package's (``repro.kernels.ops``, Pallas in interpret mode) on the same
numpy-seeded inputs, and — on a card — against the port's own CPU run.

Tolerances: ``apply_fused_gate`` within rtol/atol 1e-4 of ``repro``'s and
of the dense ``apply_matrix`` (those of ``tests/test_kernels.py``);
quantize/dequantize within the pwrel tolerance of ROADMAP.md (sign words
and flags equal, codes within 1, dequantize on identical codes within rtol
1e-5); packing bit for bit.  Two parts of that tolerance are measured at
b_r = 1e-3 and scale (ROADMAP C): a code differs where XLA's log2 error
straddles a rounding boundary, with odds of about error/step, so the 0.1%
share of differing codes at b_r = 1e-3 is scaled by step(1e-3)/step(b_r);
and ``l_max`` is held within 1 ulp of the correctly rounded log2 of
max|x|, since near max|x| = 1 the JAX package's is off by more.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.dense_engine import apply_matrix as t_apply_matrix
from repro_torch.kernels import gate_apply as tga
from repro_torch.kernels import ops as tops

GATE_TOL = dict(rtol=1e-4, atol=1e-4)
CODE_SHARE = 1e-3


@pytest.fixture
def jops():
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.core.dense_engine import apply_matrix
    from repro.kernels import ops
    return jnp, ops, apply_matrix


def _amps(rng, nv):
    return (rng.standard_normal(2 ** nv)
            + 1j * rng.standard_normal(2 ** nv)).astype(np.complex64)


def _unitary(rng, K):
    m = rng.standard_normal((K, K)) + 1j * rng.standard_normal((K, K))
    q, r = np.linalg.qr(m)
    return (q * (np.diag(r) / np.abs(np.diag(r)))).astype(np.complex64)


@pytest.mark.parametrize("nv,k", [(5, 1), (6, 2), (8, 3), (10, 4), (12, 5),
                                  (9, 2)])
@pytest.mark.parametrize("diag", [False, True])
def test_apply_fused_gate_matches_repro_and_the_dense_oracle(jops, nv, k,
                                                             diag):
    jnp, jk, j_apply = jops
    rng = np.random.default_rng(nv * 10 + k + diag)
    amps = _amps(rng, nv)
    vq = tuple(int(q) for q in rng.choice(nv, size=k, replace=False))
    if diag:
        d = np.exp(1j * rng.uniform(0, 2 * np.pi, 2 ** k)).astype(np.complex64)
        mat, full = d, np.diag(d)
    else:
        mat = full = _unitary(rng, 2 ** k)
    want = np.asarray(jk.apply_fused_gate(jnp.asarray(amps), jnp.asarray(mat),
                                          vq, nv, diag=diag, interpret=True))
    tga.reset_launch_counts()
    got = tops.apply_fused_gate(torch.from_numpy(amps), torch.from_numpy(mat),
                                vq, nv, diag)
    assert sum(tga.launch_counts.values()) == 0    # CPU: plain versions
    assert got.dtype == torch.complex64 and got.shape == (2 ** nv,)
    np.testing.assert_allclose(got.numpy(), want, **GATE_TOL)
    dense = t_apply_matrix(torch.from_numpy(amps), torch.from_numpy(full),
                           vq, nv)
    np.testing.assert_allclose(got.numpy(), dense.numpy(), **GATE_TOL)
    np.testing.assert_allclose(
        dense.numpy(), np.asarray(j_apply(jnp.asarray(amps),
                                          jnp.asarray(full), vq, nv)),
        **GATE_TOL)


def _plane(rng, n, span=60.0):
    x = (2.0 ** rng.uniform(-span, 0.0, n)
         * rng.choice([-1.0, 1.0], n)).astype(np.float32)
    x[rng.random(n) < 0.02] = 0.0
    return x


@pytest.mark.parametrize("n", [128, 1024, 4096])
@pytest.mark.parametrize("b_r", [1e-2, 1e-3, 1e-4])
def test_quantize_and_dequantize_block_within_the_pwrel_tolerance(jops, n,
                                                                  b_r):
    jnp, jk, _ = jops
    rng = np.random.default_rng(n + int(1 / b_r))
    x = _plane(rng, n)
    jc, jp, jf, jl = (np.array(a) for a in jk.quantize_block(
        jnp.asarray(x), b_r, interpret=True))
    tc, tp, tf, tl = tops.quantize_block(torch.from_numpy(x), b_r)
    assert tc.shape == (n,) and tc.dtype == torch.int32
    assert tl.shape == () and tl.dtype == torch.float32
    share = CODE_SHARE * max(1.0, np.log1p(1e-3) / np.log1p(b_r))
    d = np.abs(tc.numpy().astype(np.int64) - jc.astype(np.int64))
    assert d.max() <= 1 and np.count_nonzero(d) <= share * n
    np.testing.assert_array_equal(tp.numpy(), jp)
    np.testing.assert_array_equal(tf.numpy(), jf)
    exact = np.float32(np.log2(np.abs(x).astype(np.float64).max()))
    assert abs(np.float32(tl) - exact) <= np.spacing(np.abs(exact))
    # dequantize on the JAX package's codes, signs and l_max
    want = np.asarray(jk.dequantize_block(jnp.asarray(jc), jnp.asarray(jp),
                                          jl, b_r, interpret=True))
    got = tops.dequantize_block(torch.from_numpy(jc.astype(np.int32)),
                                torch.from_numpy(jp), float(jl), b_r).numpy()
    normal = np.abs(want) >= np.float32(2.0 ** -126)
    np.testing.assert_allclose(got[normal], want[normal], rtol=1e-5, atol=0)
    np.testing.assert_array_equal(got[want == 0], 0.0)
    # the same codes as int16 u16 bits read back alike
    as_u16 = torch.from_numpy(jc.astype(np.uint16).view(np.int16))
    np.testing.assert_array_equal(
        tops.dequantize_block(as_u16, torch.from_numpy(jp), float(jl),
                              b_r).numpy(), got)


@pytest.mark.parametrize("n", [128, 384, 4096])
def test_packing_wrappers_are_bit_equal_to_repro(jops, n):
    jnp, jk, _ = jops
    rng = np.random.default_rng(n)
    codes = rng.integers(0, 65536, n).astype(np.int32)
    jw = np.array(jk.pack_codes(jnp.asarray(codes), interpret=True))
    tw = tops.pack_codes(torch.from_numpy(codes)).numpy()
    np.testing.assert_array_equal(tw, jw)
    np.testing.assert_array_equal(tw.view("<u2").reshape(-1), codes)
    np.testing.assert_array_equal(
        tops.unpack_codes(torch.from_numpy(tw)).numpy(),
        np.asarray(jk.unpack_codes(jnp.asarray(jw), interpret=True)))
    bits = rng.random(n) < 0.5
    jb = np.array(jk.pack_sign_bitmap(jnp.asarray(bits), interpret=True))
    for b in (bits, bits.astype(np.int32), bits.astype(np.int64)):
        np.testing.assert_array_equal(
            tops.pack_sign_bitmap(torch.from_numpy(b)).numpy(), jb)
    back = tops.unpack_sign_bitmap(torch.from_numpy(jb))
    assert back.dtype == torch.bool
    np.testing.assert_array_equal(
        back.numpy(),
        np.asarray(jk.unpack_sign_bitmap(jnp.asarray(jb), interpret=True)))
    np.testing.assert_array_equal(back.numpy(), bits)


def test_wrappers_want_lane_aligned_streams():
    with pytest.raises(ValueError, match="not lane-aligned"):
        tops.quantize_block(torch.zeros(100), 1e-3)
    with pytest.raises(ValueError, match="not lane-aligned"):
        tops.pack_codes(torch.zeros(130, dtype=torch.int32))
    with pytest.raises(ValueError, match="not lane-aligned"):
        tops.pack_sign_bitmap(torch.zeros(64, dtype=torch.bool))


@pytest.mark.cuda
@pytest.mark.parametrize("diag", [False, True])
def test_cuda_ops_launch_their_kernels_and_match_the_cpu(diag):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU form")
    from repro_torch.kernels import pack as tpack

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(5)
    nv, vq = 16, (3, 9, 0)
    amps = torch.from_numpy(_amps(rng, nv))
    mat = (np.exp(1j * rng.uniform(0, 2 * np.pi, 8)).astype(np.complex64)
           if diag else _unitary(rng, 8))
    mat = torch.from_numpy(mat)
    want = tops.apply_fused_gate(amps, mat, vq, nv, diag)
    tga.reset_launch_counts()
    got = tops.apply_fused_gate(amps.to(dev), mat.to(dev), vq, nv, diag)
    torch.cuda.synchronize()
    name = "diag_apply" if diag else "gemm_planes"
    assert tga.launch_counts[name] == 1
    assert sum(tga.launch_counts.values()) == 1
    torch.testing.assert_close(got.cpu(), want, **GATE_TOL)
    # the packing wrappers on the card equal their CPU runs bit for bit
    codes = torch.from_numpy(rng.integers(0, 65536, 4096).astype(np.int32))
    bits = torch.from_numpy(rng.random(4096) < 0.5)
    tpack.reset_launch_counts()
    assert torch.equal(tops.pack_codes(codes.to(dev)).cpu(),
                       tops.pack_codes(codes))
    assert torch.equal(tops.pack_sign_bitmap(bits.to(dev)).cpu(),
                       tops.pack_sign_bitmap(bits))
    assert tpack.launch_counts["pack_codes_tiles"] == 1
    assert tpack.launch_counts["pack_bitmap_tiles"] == 1
