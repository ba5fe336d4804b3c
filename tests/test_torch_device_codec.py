"""The port's device codec (``compression/device_codec.py``, on the CPU
where the kernels run their plain versions) against the JAX package's
(Pallas in interpret mode), on the same numpy-seeded blocks.

Framework-free quantities must be equal: wire sizes, the bytes each
direction counts, and the wire ``segments_to_wire`` rebuilds from one
stored block.  Codes are held to the pwrel tolerance of ROADMAP.md
(signs and zero escapes equal, codes within 1 in at most 0.1% of the
encoded elements, ``l_max`` within 1 ulp), decoded values to rtol 1e-5 of the
other package's decode of the same block and to 1.01·b_r of the input
(b_r plus the f32 slack of ROADMAP C), for normal floats.
"""
import numpy as np
import pytest

pytest.importorskip("jax")
import jax
import torch

from repro.compression import codec as jcodec
from repro.compression import device_codec as jdc
from repro.compression.pwrel import PwRelParams as JParams
from repro.compression.segments import BlockSegments as JSegments
from repro_torch.compression import codec as tcodec
from repro_torch.compression import device_codec as tdc
from repro_torch.compression.pwrel import PwRelParams as TParams
from repro_torch.compression.segments import BlockSegments as TSegments

CPU = torch.device("cpu")
B_R = 1e-3
TINY = np.float32(2.0 ** -126)
BOUND = 1.01 * B_R
JP, TP = JParams(B_R), TParams(B_R)
JDEV = jax.devices()[0]


def _amps(n, n_blocks, seed):
    """Blocks of state-like, log-uniform (60 octaves) and zero amplitudes."""
    rng = np.random.default_rng(seed)
    out = []
    for b in range(n_blocks):
        kind = b % 3
        if kind == 0:
            z = rng.standard_normal(n) + 1j * rng.standard_normal(n)
            z /= np.linalg.norm(z)
        elif kind == 1:
            mag = 2.0 ** rng.uniform(-60, 0, (2, n))
            sgn = rng.choice([-1.0, 1.0], (2, n))
            z = mag[0] * sgn[0] + 1j * mag[1] * sgn[1]
            z[rng.random(n) < 0.02] = 0
        else:
            z = np.zeros(n)
        out.append(z)
    return np.concatenate(out).astype(np.complex64)


def _wires(amps, n_blocks):
    jw, jd2h = jdc.fetch_group_wire(
        jdc.encode_group_device(jax.device_put(amps, JDEV), n_blocks, JP))
    tw, td2h = tdc.fetch_group_wire(
        tdc.encode_group_device(torch.from_numpy(amps), n_blocks, TP))
    return (jw, jd2h), (tw, td2h)


def _close_parts(amps, got, ref):
    for part in (np.real, np.imag):
        x, y, z = part(amps), part(got), part(ref)
        normal = np.abs(x) >= TINY
        rel = np.abs(y[normal] - x[normal]) / np.abs(x[normal])
        assert rel.max(initial=0.0) <= BOUND
        np.testing.assert_allclose(y[normal], z[normal], rtol=1e-5, atol=0)
        np.testing.assert_array_equal(y[x == 0], 0.0)


CASES = [(n, k) for n in (192, 1024) for k in (1, 2, 4)]


@pytest.mark.parametrize("n,n_blocks", CASES)
def test_wire_sizes_bytes_and_codes_match_repro(n, n_blocks):
    amps = _amps(n, n_blocks, seed=n + n_blocks)
    (jw, jd2h), (tw, td2h) = _wires(amps, n_blocks)
    assert td2h == jd2h == n_blocks * 2 * (2 * n + tdc.sign_wire_bytes(n) + 4)
    assert len(tw) == len(jw) == n_blocks
    n_diff = 0
    for jpair, tpair in zip(jw, tw):
        for j, t in zip(jpair, tpair):
            assert t.nbytes == j.nbytes
            assert t.codes.dtype == np.dtype("<u2")
            assert t.codes.shape == j.codes.shape == (n,)
            assert t.sign_bytes.shape == j.sign_bytes.shape
            assert t.l_max.shape == j.l_max.shape == (1, 1)
            np.testing.assert_array_equal(t.sign_bytes, j.sign_bytes)
            jl, tl = np.float32(j.l_max[0, 0]), np.float32(t.l_max[0, 0])
            assert abs(jl - tl) <= abs(np.spacing(jl))
            jc, tc = j.codes.astype(np.int64), t.codes.astype(np.int64)
            np.testing.assert_array_equal(jc == 0, tc == 0)
            d = np.abs(jc - tc)
            assert d.max(initial=0) <= 1
            n_diff += np.count_nonzero(d)
    assert n_diff <= 1e-3 * amps.size * 2     # of all the wave's elements
    assert tdc.plane_geometry(n) == jdc.plane_geometry(n)
    assert tdc.sign_wire_bytes(n) == jdc.sign_wire_bytes(n)


@pytest.mark.parametrize("n,n_blocks", CASES)
def test_segments_to_wire_gives_equal_bytes(n, n_blocks):
    amps = _amps(n, n_blocks, seed=7 * n + n_blocks)
    for b in range(n_blocks):
        jseg = jcodec.encode_block_host(amps[b * n:(b + 1) * n], JP)
        tseg = TSegments.from_bytes(jseg.to_bytes())
        for j, t in zip(jdc.segments_to_wire(jseg),
                        tdc.segments_to_wire(tseg)):
            for f in ("codes", "sign_bytes", "l_max"):
                a, c = np.asarray(getattr(j, f)), np.asarray(getattr(t, f))
                assert a.dtype == c.dtype and a.shape == c.shape, f
                np.testing.assert_array_equal(c, a)


@pytest.mark.parametrize("n,n_blocks", CASES)
def test_port_device_blocks_decode_in_repro(n, n_blocks):
    """A block the port's device encoder wrote decodes in repro's host
    codec and in repro's device codec, within the tolerance."""
    amps = _amps(n, n_blocks, seed=3 * n + n_blocks)
    _, (tw, _) = _wires(amps, n_blocks)
    for b, pair in enumerate(tw):
        blk = amps[b * n:(b + 1) * n]
        tseg = tdc.wire_to_segments(pair, n, params=TP)
        assert not tseg.is_raw
        own = tcodec.decode_block_host(tseg, TP)
        jseg = JSegments.from_bytes(tseg.to_bytes())
        _close_parts(blk, jcodec.decode_block_host(jseg, JP), own)
        jdev, h2d = jdc.decode_block_device(jdc.segments_to_wire(jseg), n,
                                            JP, JDEV)
        _close_parts(blk, np.asarray(jdev), own)
        assert h2d == 2 * (2 * n + tdc.sign_wire_bytes(n) + 4)


@pytest.mark.parametrize("n,n_blocks", CASES)
def test_repro_host_blocks_decode_in_the_port_device_codec(n, n_blocks):
    amps = _amps(n, n_blocks, seed=5 * n + n_blocks)
    jsegs = [jcodec.encode_block_host(amps[b * n:(b + 1) * n], JP)
             for b in range(n_blocks)]
    pairs = [tdc.segments_to_wire(TSegments.from_bytes(s.to_bytes()))
             for s in jsegs]
    got, h2d = tdc.decode_blocks_device(pairs, n, TP, CPU)
    _, jh2d = jdc.decode_blocks_device(
        [jdc.segments_to_wire(s) for s in jsegs], n, JP, JDEV)
    assert h2d == jh2d
    assert got.shape == (n_blocks, n) and got.dtype == torch.complex64
    for b, s in enumerate(jsegs):
        _close_parts(amps[b * n:(b + 1) * n], got[b].numpy(),
                     jcodec.decode_block_host(s, JP))
    one, moved = tdc.decode_block_device(pairs[0], n, TP, CPU)
    np.testing.assert_array_equal(one.numpy(), got[0].numpy())
    assert moved == h2d // n_blocks


def test_incompressible_block_takes_the_raw_escape_in_both_packages():
    n = 16                    # the segment headers outweigh a raw block
    rng = np.random.default_rng(0)
    amps = (rng.standard_normal(n) + 1j * rng.standard_normal(n)) \
        .astype(np.complex64)
    (jw, _), (tw, _) = _wires(amps, 1)
    jseg = jdc.wire_to_segments(jw[0], n, params=JP)
    tseg = tdc.wire_to_segments(tw[0], n, params=TP)
    assert jseg.is_raw and tseg.is_raw
    assert tseg.nbytes == jseg.nbytes == tseg.raw_nbytes + 8
    # the RAW bytes hold the lossy reconstruction, decoded by either host
    got = np.frombuffer(tseg.raw, np.complex64)
    _close_parts(amps, got, np.frombuffer(jseg.raw, np.complex64))
    _close_parts(amps, jcodec.decode_block_host(
        JSegments.from_bytes(tseg.to_bytes()), JP), got)
    # without params the wire is kept as pwrel segments
    assert not tdc.wire_to_segments(tw[0], n).is_raw
