"""Device-resident lossy codec (paper §4.3 on the accelerator).

The lossy half of the compressor runs *next to the compute*, so only the
compressed representation crosses the host↔device boundary.  Per real
plane of an n-amplitude block, the wire format is exact-sized:

    codes       (n,)              u16     — quantizer output
    sign_bytes  (4*ceil(n/32),)   uint8   — ballot-packed sign bits
                                            (LSB-first)
    l_max       (1, 1)            float32 — quantizer anchor scalar

i.e. ~2.13 bytes per element instead of 4 (f32) — ~4.25 vs 8 bytes per
complex amplitude — before the host lossless stage shrinks it further.

Encode path (device -> store): :func:`encode_wave` runs the ``l_max``
prologue and ONE fused quantize + pack launch over every block plane of a
wave (:func:`repro_torch.kernels.codec.encode_planes`);
:func:`wire_to_segments` runs the host lossless stage on the fetched wire.

Decode path (store -> device): :func:`segments_to_wire` inflates a block's
segments back to wire arrays; :func:`decode_wave` runs ONE fused unpack +
dequantize launch that writes every wire plane straight into the wave's
(R, 2, N) plane stack.

The kernels mask the ragged edge of a plane themselves: nothing is padded
and no pad crosses the boundary or reaches the store.  Stored blocks use
the host codec's :class:`BlockSegments` format, so the two backends are
interchangeable.  Codes are not byte-equal to the JAX package's (XLA's
``log2`` is not correctly rounded); they agree within the pwrel tolerance
of ROADMAP.md.  RAW-escape blocks are stored as the lossy reconstruction
(the device never ships raw amplitudes): same size bound, same error
bound.

On the host the wire is numpy (``codes`` as ``<u2``); on the device it is
torch, with the u16 codes held as int16 carrying the same bits.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..faults import fault_point
from ..kernels.codec import decode_planes, encode_planes, plane_l_max
from .lossless import decode_bitmap, decode_codes, encode_bitmap, encode_codes
from .pwrel import CODE_MAX, PwRelParams, log_step
from .segments import BlockSegments, PlaneSegments

__all__ = [
    "PlaneWire", "plane_geometry", "sign_wire_bytes",
    "encode_wave", "decode_wave",
    "encode_group_device", "encode_group_planes", "fetch_group_wire",
    "wire_to_segments", "segments_to_wire", "decode_block_device",
    "decode_blocks_device", "decode_blocks_planes",
]

_LANES = 128


class PlaneWire(NamedTuple):
    """One plane's boundary-crossing representation (device tensors or
    host numpy arrays)."""

    codes: torch.Tensor | np.ndarray        # (n,) u16 (int16 on device)
    sign_bytes: torch.Tensor | np.ndarray   # (4*ceil(n/32),) u8, LSB-first
    l_max: torch.Tensor | np.ndarray        # (1, 1) f32

    @property
    def nbytes(self) -> int:
        return int(self.codes.nbytes + self.sign_bytes.nbytes
                   + self.l_max.nbytes)


def plane_geometry(n: int) -> tuple[int, int]:
    """(rows, pad) for an n-element plane padded to 128-lane rows (the
    TPU kernels' layout; the CUDA kernels mask the edge instead)."""
    pad = (-n) % _LANES
    return (n + pad) // _LANES, pad


def sign_wire_bytes(n: int) -> int:
    """Sign-bitmap wire size: whole ballot words, 4 bytes per 32 elements."""
    return 4 * ((n + 31) // 32)


# --------------------------------------------------------------------------
# encode: device kernels -> wire -> host lossless stage
# --------------------------------------------------------------------------

def encode_wave(planes: torch.Tensor, n: int, params: PwRelParams):
    """Encode every block plane of an (R, 2, N) f32 stack of blocks of
    ``n`` on its device: the ``l_max`` prologue, then one fused launch.

    Returns device tensors ``(codes (P, n) int16 [u16 bits], sign_bytes
    (P, 4*ceil(n/32)) uint8, l_max (P,) f32)``, P = 2·R·N/n, plane
    ``2*(r*nb + i) + c`` = component ``c`` of block ``i`` of row ``r``.
    Queued on the current stream; nothing is fetched.
    """
    l_max = plane_l_max(planes, n)
    codes, signs, _ = encode_planes(planes, n, l_max, log_step(params.b_r))
    return codes, signs.view(torch.uint8), l_max


def _pairs(codes, sign_bytes, l_max) -> list[tuple[PlaneWire, PlaneWire]]:
    """Batch arrays of P planes -> per-block (re, im) PlaneWire pairs."""
    return [tuple(PlaneWire(codes[q], sign_bytes[q], l_max[q:q + 1]
                            .reshape(1, 1)) for q in (2 * b, 2 * b + 1))
            for b in range(codes.shape[0] // 2)]


def encode_group_planes(planes: torch.Tensor, n_blocks: int,
                        params: PwRelParams):
    """Dispatch the lossy encode of a planes-resident group on its device.

    Args:
        planes: (2, n_blocks * 2^b) f32 re/im plane stack (device-resident)
            — the stage compute's native representation.
        n_blocks: SV blocks in the group (2^m).
        params: pwrel bound.

    Returns:
        Tuple of ``(re: PlaneWire, im: PlaneWire)`` per block — device
        tensors, queued asynchronously (nothing is fetched yet).
    """
    planes = planes.to(torch.float32)
    wave = encode_wave(planes.unsqueeze(0), planes.shape[1] // n_blocks,
                       params)
    return tuple(_pairs(*wave))


def encode_group_device(amps: torch.Tensor, n_blocks: int,
                        params: PwRelParams):
    """Complex-tensor convenience over :func:`encode_group_planes` —
    identical stored bytes (a complex64's components are already f32)."""
    fault_point("codec.encode")
    planes = torch.stack([amps.real, amps.imag]).to(torch.float32)
    return encode_group_planes(planes, n_blocks, params)


def _host(t) -> np.ndarray:
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def fetch_group_wire(encoded) -> tuple[list[tuple[PlaneWire, PlaneWire]], int]:
    """Block on the device encode and fetch wire arrays to host numpy.

    Returns (per-block host PlaneWire pairs, total bytes moved d2h).
    """
    out, moved = [], 0
    for pair in encoded:
        host_pair = []
        for w in pair:
            h = PlaneWire(_host(w.codes).view("<u2"), _host(w.sign_bytes),
                          _host(w.l_max))
            moved += h.nbytes
            host_pair.append(h)
        out.append(tuple(host_pair))
    return out, moved


def _wire_plane_to_segments(w: PlaneWire, n: int,
                            prescan: bool) -> PlaneSegments:
    u16 = np.asarray(w.codes, dtype="<u2")
    bits = np.unpackbits(np.asarray(w.sign_bytes, dtype=np.uint8),
                         bitorder="little", count=n).astype(bool)
    return PlaneSegments(l_max=float(np.asarray(w.l_max).reshape(())),
                         codes=encode_codes(u16),
                         bitmap=encode_bitmap(bits, prescan))


def _wire_plane_to_f32(w: PlaneWire, n: int, step: float) -> np.ndarray:
    """Pure-numpy dequantize of a host wire plane (pwrel math, GIL-free)."""
    codes = np.asarray(w.codes, dtype="<u2")
    bits = np.unpackbits(np.asarray(w.sign_bytes, dtype=np.uint8),
                         bitorder="little", count=n).astype(bool)
    d = np.float32(CODE_MAX) - codes.astype(np.float32)
    mag = np.exp2(np.float32(np.asarray(w.l_max).reshape(()))
                  - d * np.float32(step)).astype(np.float32)
    mag[codes == 0] = 0.0
    return np.where(bits, -mag, mag).astype(np.float32)


def wire_to_segments(pair: tuple[PlaneWire, PlaneWire], n: int,
                     prescan: bool = True,
                     params: PwRelParams | None = None) -> BlockSegments:
    """Host lossless stage: fetched wire arrays -> structured block segments.

    When ``params`` is given, the host codec's never-inflate contract is
    honored: if the pwrel segments would exceed the raw block, the wire is
    dequantized on the host (pure numpy — the quantized data is all the
    device shipped, so the RAW bytes hold the reconstruction, not the
    pre-quantization amplitudes the host encoder would have stored).
    """
    seg = BlockSegments(n_amps=n, prescan=prescan,
                        re=_wire_plane_to_segments(pair[0], n, prescan),
                        im=_wire_plane_to_segments(pair[1], n, prescan))
    if params is not None and seg.nbytes >= seg.raw_nbytes + 8:
        step = log_step(params.b_r)
        amps = (_wire_plane_to_f32(pair[0], n, step)
                + 1j * _wire_plane_to_f32(pair[1], n, step)) \
            .astype(np.complex64)
        seg = BlockSegments(n_amps=n, raw=amps.tobytes())
    return seg


# --------------------------------------------------------------------------
# decode: host lossless stage -> wire -> device kernels
# --------------------------------------------------------------------------

def _segments_plane_to_wire(p: PlaneSegments, n: int,
                            prescan: bool) -> PlaneWire:
    u16 = np.asarray(decode_codes(p.codes, n))
    bits = decode_bitmap(p.bitmap, n, prescan)
    sign_bytes = np.packbits(bits, bitorder="little")
    want = sign_wire_bytes(n)
    if sign_bytes.size < want:
        sign_bytes = np.concatenate(
            [sign_bytes, np.zeros(want - sign_bytes.size, np.uint8)])
    l_max = np.asarray(p.l_max, dtype=np.float32).reshape(1, 1)
    return PlaneWire(u16, sign_bytes, l_max)


def segments_to_wire(seg: BlockSegments) -> tuple[PlaneWire, PlaneWire]:
    """Inflate a block's lossless segments to host wire arrays (GIL-free)."""
    assert not seg.is_raw, "RAW blocks bypass the device codec"
    return (_segments_plane_to_wire(seg.re, seg.n_amps, seg.prescan),
            _segments_plane_to_wire(seg.im, seg.n_amps, seg.prescan))


def decode_wave(codes: torch.Tensor, sign_bytes: torch.Tensor,
                l_max: torch.Tensor, n: int, params: PwRelParams,
                out: torch.Tensor, plane_map: torch.Tensor | None = None):
    """Decode P wire planes (device tensors as :func:`encode_wave` returns
    them) into the (R, 2, N) f32 stack ``out`` in one launch; wire plane
    ``j`` lands on stack plane ``plane_map[j]`` (default ``j``).  Returns
    ``out``; queued, never blocks."""
    signs = sign_bytes.view(torch.int32)
    return decode_planes(codes, signs, l_max.reshape(-1),
                         log_step(params.b_r), out, n, plane_map)


def decode_blocks_planes(pairs: list, n: int, params: PwRelParams,
                         device) -> tuple[torch.Tensor, int]:
    """Ship several blocks' wire arrays to ``device`` in three batched
    transfers and decode them in one kernel launch.

    Args:
        pairs: per-block ``(re, im)`` host :class:`PlaneWire` tuples.

    Returns (device f32 planes (len(pairs), 2, n), bytes moved h2d) — the
    stage compute's native representation; no complex64 is materialized.
    """
    planes = [w for pair in pairs for w in pair]
    codes = np.stack([np.asarray(w.codes, dtype="<u2") for w in planes])
    sign_bytes = np.stack([np.asarray(w.sign_bytes, np.uint8)
                           for w in planes])
    l_max = np.stack([np.asarray(w.l_max, np.float32).reshape(())
                      for w in planes])
    moved = codes.nbytes + sign_bytes.nbytes + l_max.nbytes
    dev = torch.device(device)
    out = torch.empty((len(pairs), 2, n), dtype=torch.float32, device=dev)
    decode_wave(torch.from_numpy(codes.view(np.int16)).to(dev),
                torch.from_numpy(sign_bytes).to(dev),
                torch.from_numpy(l_max).to(dev), n, params, out)
    return out, moved


def decode_blocks_device(pairs: list, n: int, params: PwRelParams,
                         device) -> tuple[torch.Tensor, int]:
    """Complex-tensor convenience over :func:`decode_blocks_planes`.

    Returns (device complex64 blocks (len(pairs), n), bytes moved h2d).
    """
    fault_point("codec.decode")
    planes, moved = decode_blocks_planes(pairs, n, params, device)
    return torch.complex(planes[:, 0], planes[:, 1]), moved


def decode_block_device(pair: tuple[PlaneWire, PlaneWire], n: int,
                        params: PwRelParams,
                        device) -> tuple[torch.Tensor, int]:
    """Single-block convenience over :func:`decode_blocks_device`."""
    blocks, moved = decode_blocks_device([pair], n, params, device)
    return blocks[0], moved
