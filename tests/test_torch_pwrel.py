"""The port's pwrel quantizer and host codec against the JAX package's.

The two are not bit-identical (XLA's CPU log2 is not correctly rounded;
torch's is), so they are held to the measured tolerance instead of byte
equality: equal sign bitmaps and zero escapes, l_max within 1 ulp, codes
within 1 in at most 0.1% of elements, dequantized values within rtol 1e-5
on the same codes, and every decoded normal float within b_r of its input
(plus the f32 slack both packages share: the exponent l_max - d*step is
rounded in f32, a few ulp of a value up to ~100, which adds well under 1%
of b_r on a 60-octave spread).
"""
import numpy as np
import pytest

pytest.importorskip("jax")
import torch

from repro.compression import codec as jcodec
from repro.compression import pwrel as jpwrel
from repro.compression.segments import BlockSegments as JSegments
from repro_torch.compression import codec as tcodec
from repro_torch.compression import pwrel as tpwrel
from repro_torch.compression.segments import BlockSegments as TSegments

B_R = 1e-3
TINY = np.float32(2.0 ** -126)            # smallest normal f32
BOUND = B_R * 1.01                        # b_r + the shared f32 slack


def _log_uniform(rng, n, span=60.0, zeros=0.02):
    mag = 2.0 ** rng.uniform(-span, 0.0, n)
    x = (mag * rng.choice([-1.0, 1.0], n)).astype(np.float32)
    x[rng.random(n) < zeros] = 0.0
    return x


def _state_like(rng, n):
    z = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    z /= np.linalg.norm(z)
    return z.real.astype(np.float32)


def _planes():
    rng = np.random.default_rng(7)
    return {
        "random": _log_uniform(rng, 4096),
        "state": _state_like(rng, 4096),
        "uniform_mag": (np.sign(rng.standard_normal(2048))
                        / np.sqrt(2048)).astype(np.float32),
        "zeros": np.zeros(1000, np.float32),
        "ragged_77": _log_uniform(rng, 77),
        "ragged_1000": _state_like(rng, 1000),
        "ragged_4097": _log_uniform(rng, 4097, span=100.0),
    }


PLANES = _planes()


def _both(x, params):
    jc, js, jl = jpwrel.quantize_plane(x, params)
    tc, ts, tl = tpwrel.quantize_plane(x, params)
    return ((np.asarray(jc).astype(np.int64), np.asarray(js),
             np.float32(jl)),
            (tc.numpy().astype(np.int64), ts.numpy(), np.float32(tl)))


@pytest.mark.parametrize("name", sorted(PLANES))
def test_quantize_within_measured_tolerance(name):
    x = PLANES[name]
    params = tpwrel.PwRelParams(b_r=B_R)
    (jc, js, jl), (tc, ts, tl) = _both(x, jpwrel.PwRelParams(b_r=B_R))
    np.testing.assert_array_equal(js, ts)                 # sign bitmaps
    np.testing.assert_array_equal(jc == 0, tc == 0)       # zero escapes
    assert abs(float(jl) - float(tl)) <= abs(np.spacing(np.float32(jl)))
    diff = np.abs(jc - tc)
    assert diff.max(initial=0) <= 1
    assert np.count_nonzero(diff) <= 1e-3 * x.size
    # the same codes dequantize alike in both packages
    jd = np.asarray(jpwrel.dequantize_plane(tc, ts, tl,
                                            jpwrel.PwRelParams(b_r=B_R)))
    td = tpwrel.dequantize_plane(tc, ts, tl, params).numpy()
    normal = np.abs(td) >= TINY
    np.testing.assert_allclose(td[normal], jd[normal], rtol=1e-5, atol=0)
    np.testing.assert_array_equal(td[~normal & (jd == 0)], 0.0)


@pytest.mark.parametrize("name", sorted(PLANES))
def test_each_package_round_trips_within_bound(name):
    x = PLANES[name]
    for mod in (jpwrel, tpwrel):
        params = mod.PwRelParams(b_r=B_R)
        codes, signs, l_max = mod.quantize_plane(x, params)
        y = np.asarray(mod.dequantize_plane(np.asarray(codes),
                                            np.asarray(signs),
                                            np.float32(l_max), params))
        normal = np.abs(x) >= TINY
        rel = np.abs(y[normal] - x[normal]) / np.abs(x[normal])
        assert rel.max(initial=0.0) <= BOUND, mod.__name__
        np.testing.assert_array_equal(y[x == 0], 0.0)


def _block(rng, n, kind):
    if kind == "zeros":
        return np.zeros(n, np.complex64)
    if kind == "state":
        z = rng.standard_normal(n) + 1j * rng.standard_normal(n)
        return (z / np.linalg.norm(z)).astype(np.complex64)
    re, im = _log_uniform(rng, n), _log_uniform(rng, n)
    return (re + 1j * im).astype(np.complex64)


@pytest.mark.parametrize("n", [77, 1000, 4096])
@pytest.mark.parametrize("kind", ["random", "state", "zeros"])
@pytest.mark.parametrize("direction", ["repro->port", "port->repro"])
def test_blocks_decode_across_packages(n, kind, direction):
    """A block written by either package's host codec decodes in the
    other within the bounds (wire bytes carried through to_bytes)."""
    rng = np.random.default_rng(n)
    amps = _block(rng, n, kind)
    if direction == "repro->port":
        seg = jcodec.encode_block_host(amps, jpwrel.PwRelParams(b_r=B_R))
        got = tcodec.decode_block_host(TSegments.from_bytes(seg.to_bytes()),
                                       tpwrel.PwRelParams(b_r=B_R))
        own = jcodec.decode_block_host(seg, jpwrel.PwRelParams(b_r=B_R))
    else:
        seg = tcodec.encode_block_host(amps, tpwrel.PwRelParams(b_r=B_R))
        got = jcodec.decode_block_host(JSegments.from_bytes(seg.to_bytes()),
                                       jpwrel.PwRelParams(b_r=B_R))
        own = tcodec.decode_block_host(seg, tpwrel.PwRelParams(b_r=B_R))
    assert got.dtype == np.complex64 and got.shape == (n,)
    for part in (np.real, np.imag):
        x, y, z = part(amps), part(got), part(own)
        normal = np.abs(x) >= TINY
        rel = np.abs(y[normal] - x[normal]) / np.abs(x[normal])
        assert rel.max(initial=0.0) <= BOUND
        np.testing.assert_allclose(y[normal], z[normal], rtol=1e-5, atol=0)
        np.testing.assert_array_equal(y[x == 0], 0.0)


def test_quantize_runs_on_the_tensor_device():
    x = torch.from_numpy(PLANES["state"])
    codes, signs, l_max = tpwrel.quantize_plane(x, tpwrel.PwRelParams())
    assert codes.device == x.device and codes.dtype == torch.int32
    assert signs.dtype == torch.bool and l_max.shape == ()
