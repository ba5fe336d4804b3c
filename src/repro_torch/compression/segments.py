"""Structured compressed-block segments (paper §4.3 / §4.4 interface).

A compressed SV block is not an opaque blob: it is a small set of named
segments —

    {codes, bitmap, l_max}  per real plane  (+ a RAW escape variant)

and the pipeline wants them individually addressable: the device-resident
codec ships ``codes`` and ``bitmap`` across the host↔device boundary
without ever materializing the raw amplitudes on the host, and the
two-level store keeps the structure in its RAM tier so the hot path never
re-parses a byte stream.

``to_bytes`` / ``from_bytes`` give the self-describing wire layout used by
the disk spill tier and the legacy ``codec.compress_complex_block`` API:

    header   <BBHI>   fmt (1=pwrel, 2=raw) | prescan | reserved | n_amps
    per plane <fII>   l_max | len(codes) | len(bitmap)   then the two blobs
    (RAW:             header + n_amps raw complex64 bytes)
"""
from __future__ import annotations

import struct
from dataclasses import dataclass

__all__ = ["PlaneSegments", "BlockSegments", "FMT_PWREL", "FMT_RAW"]

FMT_PWREL = 1   # pwrel codes + bitmaps
FMT_RAW = 2     # raw complex64 escape

_HEAD = struct.Struct("<BBHI")
_PLANE_HEAD = struct.Struct("<fII")


@dataclass(frozen=True)
class PlaneSegments:
    """Lossless-encoded segments of one real plane of a block.

    Attributes:
        l_max:  block-max log2 magnitude (the quantizer anchor, §4.3 Alg. 2).
        codes:  zlib-compressed little-endian uint16 code stream.
        bitmap: sign bitmap — prescan blob (``lossless.prescan_encode_bitmap``)
                or zlib'd ``np.packbits`` stream, per ``BlockSegments.prescan``.
    """

    l_max: float
    codes: bytes
    bitmap: bytes

    @property
    def nbytes(self) -> int:
        return _PLANE_HEAD.size + len(self.codes) + len(self.bitmap)


@dataclass(frozen=True)
class BlockSegments:
    """One compressed SV block as named segments (two-level-store unit).

    Exactly one of (``re`` and ``im``) or ``raw`` is populated:
    pwrel-format blocks carry per-plane segments, RAW-escape blocks carry
    the original complex64 bytes.
    """

    n_amps: int
    prescan: bool = True
    re: PlaneSegments | None = None
    im: PlaneSegments | None = None
    raw: bytes | None = None

    @property
    def is_raw(self) -> bool:
        return self.raw is not None

    @property
    def nbytes(self) -> int:
        """Serialized size — what the store's byte accounting charges."""
        if self.is_raw:
            return _HEAD.size + len(self.raw)
        return _HEAD.size + self.re.nbytes + self.im.nbytes

    @property
    def raw_nbytes(self) -> int:
        return self.n_amps * 8  # complex64

    @property
    def ratio(self) -> float:
        return self.raw_nbytes / max(1, self.nbytes)

    def to_bytes(self) -> bytes:
        """Serialize to the self-describing wire layout (disk tier, legacy API)."""
        if self.is_raw:
            return _HEAD.pack(FMT_RAW, 0, 0, self.n_amps) + self.raw
        parts = [_HEAD.pack(FMT_PWREL, int(self.prescan), 0, self.n_amps)]
        for p in (self.re, self.im):
            parts.append(_PLANE_HEAD.pack(float(p.l_max), len(p.codes),
                                          len(p.bitmap)))
            parts.append(p.codes)
            parts.append(p.bitmap)
        return b"".join(parts)

    @classmethod
    def from_bytes(cls, blob: bytes) -> "BlockSegments":
        fmt, prescan, _, n = _HEAD.unpack_from(blob, 0)
        off = _HEAD.size
        if fmt == FMT_RAW:
            return cls(n_amps=n, raw=blob[off:off + n * 8])
        planes = []
        for _ in range(2):
            l_max, len_codes, len_bitmap = _PLANE_HEAD.unpack_from(blob, off)
            off += _PLANE_HEAD.size
            codes = blob[off:off + len_codes]
            off += len_codes
            bitmap = blob[off:off + len_bitmap]
            off += len_bitmap
            planes.append(PlaneSegments(l_max=l_max, codes=codes,
                                        bitmap=bitmap))
        return cls(n_amps=n, prescan=bool(prescan), re=planes[0],
                   im=planes[1])
