"""Host block codec: pwrel lossy stage + lossless stage (paper §4.3).

Per complex SV block:

* re/im planes are pwrel-quantized (``pwrel.py``, torch f32 on the CPU)
  into uint16 codes + sign bitmaps + per-plane ``l_max``.
* the lossless stage (``lossless.py``) pre-scans the bitmaps and
  zlib-encodes the code streams.  If the payload would exceed the raw
  block, a RAW escape stores the original complex bytes — compression
  never inflates.

The structured result is a :class:`~repro_torch.compression.segments.BlockSegments`
(``encode_block_host`` / ``decode_block_host``) — the unit the two-level
store and the stage pipeline traffic in.  ``compress_complex_block`` /
``decompress_complex_block`` are the flat-bytes convenience API over the
same self-describing layout (see ``segments.py`` for the byte format).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .lossless import (decode_bitmap, decode_codes, encode_bitmap,
                       encode_codes, prescan_decode_bitmap,
                       prescan_encode_bitmap)
from ..faults import fault_point
from .pwrel import PwRelParams, dequantize_plane, quantize_plane
from .segments import BlockSegments, PlaneSegments

__all__ = [
    "CompressedBlock", "compress_complex_block", "decompress_complex_block",
    "encode_block_host", "decode_block_host",
    "prescan_encode_bitmap", "prescan_decode_bitmap",
]


@dataclass(frozen=True)
class CompressedBlock:
    """One compressed SV block as flat bytes, ready for the two-level store."""

    payload: bytes
    n_amps: int  # complex amplitudes in the block

    @property
    def nbytes(self) -> int:
        return len(self.payload)

    @property
    def raw_nbytes(self) -> int:
        return self.n_amps * 8  # complex64

    @property
    def ratio(self) -> float:
        return self.raw_nbytes / max(1, self.nbytes)


def _encode_plane_host(x: np.ndarray, params: PwRelParams,
                       prescan: bool) -> PlaneSegments:
    codes, signs, l_max = quantize_plane(x, params)
    return PlaneSegments(
        l_max=float(l_max),
        codes=encode_codes(codes.numpy().astype(np.uint16)),
        bitmap=encode_bitmap(signs.numpy(), prescan),
    )


def _decode_plane_host(p: PlaneSegments, n: int, params: PwRelParams,
                       prescan: bool) -> np.ndarray:
    codes = decode_codes(p.codes, n)
    signs = decode_bitmap(p.bitmap, n, prescan)
    return dequantize_plane(codes, signs, p.l_max, params).numpy()


def encode_block_host(amps: np.ndarray, params: PwRelParams,
                      prescan: bool = True) -> BlockSegments:
    """Compress a complex64 block entirely on the host.

    Args:
        amps: complex amplitudes, flattened to 1-D (any shape accepted).
        params: the point-wise relative bound (``PwRelParams.b_r``).
        prescan: RLE uniform bitmap chunks before zlib (§4.3 pre-scan).

    Returns:
        Structured segments; falls back to the RAW escape when the pwrel
        payload would be larger than the raw complex bytes.
    """
    amps = np.asarray(amps, dtype=np.complex64).reshape(-1)
    seg = BlockSegments(
        n_amps=amps.size, prescan=prescan,
        re=_encode_plane_host(amps.real.copy(), params, prescan),
        im=_encode_plane_host(amps.imag.copy(), params, prescan),
    )
    if seg.nbytes >= seg.raw_nbytes + 8:
        seg = BlockSegments(n_amps=amps.size, raw=amps.tobytes())
    return seg


def decode_block_host(seg: BlockSegments, params: PwRelParams) -> np.ndarray:
    """Inverse of :func:`encode_block_host` -> complex64 amplitudes (1-D)."""
    if seg.is_raw:
        return np.frombuffer(seg.raw, dtype=np.complex64,
                             count=seg.n_amps).copy()
    re = _decode_plane_host(seg.re, seg.n_amps, params, seg.prescan)
    im = _decode_plane_host(seg.im, seg.n_amps, params, seg.prescan)
    return (re + 1j * im).astype(np.complex64)


def compress_complex_block(amps: np.ndarray, params: PwRelParams,
                           prescan: bool = True) -> CompressedBlock:
    """complex64 block -> :class:`CompressedBlock` (pwrel payload or RAW).

    Args:
        amps: complex amplitudes; flattened to 1-D.
        params: :class:`~repro_torch.compression.pwrel.PwRelParams` — the
            point-wise relative error bound ``b_r``.
        prescan: enable the §4.3 bitmap pre-scan RLE.

    Returns:
        A :class:`CompressedBlock` whose ``payload`` is the self-describing
        byte layout documented in ``segments.py``; never larger than the
        raw block plus a fixed 8-byte header.
    """
    fault_point("codec.encode")
    amps = np.asarray(amps, dtype=np.complex64).reshape(-1)
    seg = encode_block_host(amps, params, prescan)
    return CompressedBlock(payload=seg.to_bytes(), n_amps=amps.size)


def decompress_complex_block(block: CompressedBlock | bytes,
                             params: PwRelParams) -> np.ndarray:
    """Inverse of :func:`compress_complex_block`.

    Args:
        block: a :class:`CompressedBlock` or its raw ``payload`` bytes.
        params: must carry the same ``b_r`` used to compress.

    Returns:
        The reconstructed complex64 amplitudes (1-D), each non-zero element
        within relative error ``b_r`` per real plane.
    """
    fault_point("codec.decode")
    blob = block.payload if isinstance(block, CompressedBlock) else block
    return decode_block_host(BlockSegments.from_bytes(blob), params)
