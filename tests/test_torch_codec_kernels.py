"""The codec kernels' plain versions against the JAX package's Pallas
kernels (interpret mode), the fused wave wrappers against the two plain
calls in sequence, the wrappers' dispatch rules, and — on a card — the
CUDA kernels against their plain versions and the device-codec path
against its CPU run.

Tolerances are the pwrel tolerance of ROADMAP.md: sign words, flags and
zero escapes equal; codes within 1, in at most 0.1% of elements (XLA's
``log2`` is not correctly rounded); pack/unpack bit-exact; dequantize on
identical codes within rtol 1e-5 for normal floats (exp2 differs by a few
ulp between libraries).  Within the port, the fused wrappers and the plain
calls run the same torch arithmetic over differently laid-out buffers
(vectorised and scalar tails of the CPU's log2/exp2 can round apart by an
ulp), so codes there are held to the same ±1 and decode to rtol 1e-6.
"""
import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.kernels import codec as tcodec
from repro_torch.kernels import pack as tpack
from repro_torch.kernels import quantize as tquant
from repro_torch.kernels import ref

TINY = np.float32(2.0 ** -126)            # smallest normal f32
CODE_SHARE = 1e-3


def _step(b_r):
    return float(2.0 * np.log2(1.0 + b_r))


def _plane(rng, n, span=60.0):
    """Log-uniform magnitudes over ``span`` octaves with random signs and
    2% exact zeros; the last quarter is a state-like slice."""
    x = (2.0 ** rng.uniform(-span, 0.0, n)
         * rng.choice([-1.0, 1.0], n)).astype(np.float32)
    x[rng.random(n) < 0.02] = 0.0
    q = n // 4
    if q:
        z = rng.standard_normal(q)
        x[-q:] = (z / np.linalg.norm(z)).astype(np.float32)
    return x


def _l_max(x):
    m = np.abs(x).max()
    return np.array([[np.log2(m) if m > 0 else 0.0]], np.float32)


def _codes_close(a, b, size):
    d = np.abs(np.asarray(a, np.int64) - np.asarray(b, np.int64))
    assert d.max(initial=0) <= 1
    assert np.count_nonzero(d) <= CODE_SHARE * size


ROWS = [1, 8, 24, 33]
B_RS = [1e-2, 1e-3, 1e-4]


@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("b_r", B_RS)
def test_plain_versions_match_pallas_interpret(rows, b_r):
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.kernels import pack as jpack
    from repro.kernels import quantize as jquant

    rng = np.random.default_rng(rows)
    x = _plane(rng, rows * 128).reshape(rows, 128)
    lm = _l_max(x)
    step = _step(b_r)
    jc, jp, jf = (np.array(a) for a in jquant.quantize_tiles(
        jnp.asarray(x), jnp.asarray(lm), step, interpret=True))
    tc, tp, tf = (a.numpy() for a in tquant.quantize_tiles(
        torch.from_numpy(x), torch.from_numpy(lm), step))
    np.testing.assert_array_equal(tp, jp)                 # sign words
    np.testing.assert_array_equal(tf, jf)                 # tile flags
    np.testing.assert_array_equal(tc == 0, jc == 0)       # zero escapes
    _codes_close(tc, jc, x.size)

    # pack / unpack: bit-exact, both ways
    jw = np.array(jpack.pack_codes_tiles(jnp.asarray(jc), interpret=True))
    tw = tpack.pack_codes_tiles(torch.from_numpy(jc)).numpy()
    np.testing.assert_array_equal(tw, jw)
    np.testing.assert_array_equal(
        tpack.unpack_codes_tiles(torch.from_numpy(jw)).numpy(), jc)
    np.testing.assert_array_equal(
        np.asarray(jpack.unpack_codes_tiles(jnp.asarray(tw),
                                            interpret=True)), jc)

    # dequantize on identical codes
    jd = np.asarray(jquant.dequantize_tiles(
        jnp.asarray(jc), jnp.asarray(jp), jnp.asarray(lm), step,
        interpret=True))
    td = tquant.dequantize_tiles(torch.from_numpy(jc), torch.from_numpy(jp),
                                 torch.from_numpy(lm), step).numpy()
    normal = np.abs(td) >= TINY
    np.testing.assert_allclose(td[normal], jd[normal], rtol=1e-5, atol=0)
    np.testing.assert_array_equal(td[jc == 0], 0.0)
    np.testing.assert_array_equal(jd[jc == 0], 0.0)


@pytest.mark.parametrize("tile_rows", [1, 3, 8])
def test_flags_follow_the_tile_rule(tile_rows):
    rows = 24
    x = np.zeros((rows, 128), np.float32)
    x[0, 5] = -0.5                          # tile 0: one negative
    x[rows - 1] = -1.0                      # last row all negative
    lm = _l_max(x)
    _, _, flags = tquant.quantize_tiles(torch.from_numpy(x),
                                        torch.from_numpy(lm), _step(1e-3),
                                        tile_rows=tile_rows)
    tr = ref.tile_rows_for(rows, tile_rows)
    f = flags.numpy()
    assert f.shape == (rows // tr, 3)
    assert f[0].tolist() == [0, 0, 0]
    assert f[1:-1].tolist() == [[1, 1, 0]] * (rows // tr - 2)
    assert f[-1].tolist() == ([0, 0, 1] if tr == 1 else [0, 0, 0])


def _stack(rng, R, nb, n):
    """(R, 2, nb*n) f32 stack; plane q = 2*(r*nb + i) + c."""
    planes = np.stack([_plane(rng, n) for _ in range(2 * R * nb)])
    planes[-1] = 0.0                        # an all-zero plane
    return planes.reshape(R, nb, 2, n).transpose(0, 2, 1, 3) \
        .reshape(R, 2, nb * n).copy()


def _plane_rows(stack, n):
    R, _, N = stack.shape
    return stack.reshape(R, 2, N // n, n).transpose(0, 2, 1, 3) \
        .reshape(-1, n)


@pytest.mark.parametrize("n", [77, 192, 1000])
@pytest.mark.parametrize("b_r", B_RS)
def test_fused_wrappers_equal_the_plain_calls_in_sequence(n, b_r):
    """encode_planes = quantize_tiles -> pack_codes_tiles per padded plane
    (cut back to n codes and ceil(n/32) sign words), and decode_planes =
    unpack_codes_tiles -> dequantize_tiles, on the CPU."""
    rng = np.random.default_rng(n)
    R, nb = 2, 2
    stack = torch.from_numpy(_stack(rng, R, nb, n))
    step = _step(b_r)
    l_max = tcodec.plane_l_max(stack, n)
    codes, signs, flags = tcodec.encode_planes(stack, n, l_max, step,
                                               flags_tile_rows=8)
    P = 2 * R * nb
    rows = -(-n // 128)
    words = -(-n // 32)
    assert codes.shape == (P, n) and codes.dtype == torch.int16
    assert signs.shape == (P, words) and signs.dtype == torch.int32
    x_rows = _plane_rows(stack.numpy(), n)
    for q in range(P):
        x = np.zeros(rows * 128, np.float32)
        x[:n] = x_rows[q]
        m = np.abs(x).max()
        want_l = np.float32(np.log2(m) if m > 0 else 0.0)
        assert abs(float(l_max[q]) - want_l) <= abs(np.spacing(want_l))
        lm = l_max[q].reshape(1, 1)
        c, p, f = ref.quantize_tiles_ref(torch.from_numpy(x.reshape(rows, 128)),
                                         lm, step, 8)
        u16 = ref.pack_codes_tiles_ref(c).numpy().view("<u2").reshape(-1)
        _codes_close(codes[q].numpy().view("<u2"), u16[:n], n)
        np.testing.assert_array_equal(signs[q].numpy(),
                                      p.numpy().reshape(-1)[:words])
        np.testing.assert_array_equal(flags[q].numpy(), f.numpy())

        # decode the fused codes both ways
        pc = np.zeros(rows * 128, "<u2")
        pc[:n] = codes[q].numpy().view("<u2")
        packed = torch.from_numpy(pc.view(np.int32).reshape(rows, 64).copy())
        ps = np.zeros(rows * 4, np.int32)
        ps[:words] = signs[q].numpy()
        want = ref.dequantize_tiles_ref(
            ref.unpack_codes_tiles_ref(packed),
            torch.from_numpy(ps.reshape(rows, 4)), lm, step).reshape(-1)[:n]
        out = torch.full_like(stack, np.nan)
        tcodec.decode_planes(codes, signs, l_max, step, out, n)
        got = _plane_rows(out.numpy(), n)[q]
        np.testing.assert_allclose(got, want.numpy(), rtol=1e-6, atol=0)
        np.testing.assert_array_equal(got[want.numpy() == 0], 0.0)


def test_decode_through_a_plane_map_fills_the_named_planes():
    rng = np.random.default_rng(5)
    n, R, nb = 100, 1, 3
    stack = torch.from_numpy(_stack(rng, R, nb, n))
    step = _step(1e-3)
    l_max = tcodec.plane_l_max(stack, n)
    codes, signs, _ = tcodec.encode_planes(stack, n, l_max, step)
    full = tcodec.decode_planes(codes, signs, l_max, step,
                                torch.empty_like(stack), n)
    keep = torch.tensor([0, 1, 4, 5], dtype=torch.int32)   # blocks 0 and 2
    out = torch.full_like(stack, 7.0)
    tcodec.decode_planes(codes[keep.long()], signs[keep.long()],
                         l_max[keep.long()], step, out, n, keep)
    got, want = _plane_rows(out.numpy(), n), _plane_rows(full.numpy(), n)
    np.testing.assert_allclose(got[[0, 1, 4, 5]], want[[0, 1, 4, 5]],
                               rtol=1e-6, atol=0)
    assert (got[[2, 3]] == 7.0).all()       # block 1 left alone


def test_wrappers_check_their_inputs():
    x = torch.zeros((4, 128))
    with pytest.raises(ValueError):
        tquant.quantize_tiles(torch.zeros((4, 100)), torch.zeros((1, 1)), 0.1)
    with pytest.raises(ValueError):
        tcodec.encode_planes(torch.zeros((1, 2, 10)), 3, torch.zeros(6), 0.1)
    with pytest.raises(ValueError):
        tcodec.decode_planes(torch.zeros((4, 10), dtype=torch.int16),
                             torch.zeros((4, 1), dtype=torch.int32),
                             torch.zeros(4), 0.1, torch.zeros((1, 2, 30)), 10)
    with pytest.raises(ValueError, match="plane map"):
        tcodec.decode_planes(torch.zeros((2, 10), dtype=torch.int16),
                             torch.zeros((2, 1), dtype=torch.int32),
                             torch.zeros(2), 0.1, torch.zeros((1, 2, 30)), 10,
                             torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError, match="no kernel for device"):
        tquant.quantize_tiles(x.to("meta"), torch.zeros((1, 1), device="meta"),
                              0.1)


def test_a_failed_build_raises_and_never_falls_back(monkeypatch):
    """The launchers reach the CUDA build or raise: a failed nvcc surfaces
    as the error, never as a silent run of the plain version."""
    from repro_torch.kernels import build

    def no_build(name):
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu")

    monkeypatch.setattr(build, "load", no_build)
    monkeypatch.setattr(tcodec, "_fns", None)
    before = dict(tcodec.launch_counts)
    with pytest.raises(RuntimeError, match="nvcc failed for csrc/codec.cu"):
        tcodec.launch_encode(torch.zeros(1), (0, 0, 1, 1), 1,
                             torch.zeros(1), 0.1, torch.zeros(1),
                             torch.zeros(1), None)
    with pytest.raises(RuntimeError, match="nvcc failed for csrc/codec.cu"):
        tcodec.launch_decode(torch.zeros(1), torch.zeros(1), torch.zeros(1),
                             0.1, None, 1, 1, torch.zeros(1), (0, 0, 1, 1))
    assert tcodec.launch_counts == before


@pytest.mark.cuda
@pytest.mark.parametrize("n", [77, 192, 4097, 1 << 16])
def test_cuda_kernels_match_their_plain_versions(n):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU form")
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(n)
    stack = torch.from_numpy(_stack(rng, 2, 2, n)).to(dev)
    step = _step(1e-3)
    l_max = tcodec.plane_l_max(stack, n)
    tcodec.reset_launch_counts()
    ck, sk, fk = tcodec.encode_planes(stack, n, l_max, step,
                                      flags_tile_rows=8)
    cr, sr, fr = ref.encode_planes_ref(stack, n, l_max, step, 8)
    assert torch.equal(sk, sr) and torch.equal(fk, fr)
    _codes_close(ck.cpu().numpy().view("<u2"), cr.cpu().numpy().view("<u2"),
                 ck.numel())
    out_k = tcodec.decode_planes(ck, sk, l_max, step,
                                 torch.empty_like(stack), n)
    out_r = ref.decode_planes_ref(ck, sk, l_max, step,
                                  torch.empty_like(stack), n)
    torch.testing.assert_close(out_k, out_r, rtol=1e-6, atol=0)
    assert tcodec.launch_counts == {"encode": 1, "decode": 1}
    # the standalone code packers launch their own kernels (csrc/pack.cu)
    flat = (ck.to(torch.int32) & 0xFFFF).reshape(-1)
    codes = flat[:flat.numel() // 128 * 128].reshape(-1, 128)
    words = tpack.pack_codes_tiles(codes)
    assert torch.equal(words, ref.pack_codes_tiles_ref(codes))
    assert torch.equal(tpack.unpack_codes_tiles(words), codes)


@pytest.mark.cuda
def test_cuda_device_codec_run_goes_through_the_kernels_and_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU form")
    from repro_torch.kernels import codec, gate_apply

    tc = repro_torch.build_circuit("qft", 14)
    cpu_state, cpu_stats = repro_torch.simulate_bmqsim(
        tc, repro_torch.EngineConfig(local_bits=8, codec_backend="device",
                                     devices=[torch.device("cpu")]))
    codec.reset_launch_counts()
    gate_apply.reset_launch_counts()
    state, stats = repro_torch.simulate_bmqsim(
        tc, repro_torch.EngineConfig(local_bits=8, codec_backend="device"))
    assert codec.launch_counts["encode"] > 0
    assert codec.launch_counts["decode"] > 0
    assert gate_apply.launch_counts["gemm_planes_batch"] > 0
    # the card's gate products round apart from the CPU's, and its log2f /
    # exp2f (1 and 2 ulp) re-anchor each stage's l_max a little
    # differently: 0.9999986 measured on an H100
    assert repro_torch.fidelity(cpu_state, state) >= 0.99999
    for f in ("h2d_bytes", "d2h_bytes", "n_block_compressions",
              "n_block_decompressions", "n_stages"):
        assert getattr(stats, f) == getattr(cpu_stats, f), f
