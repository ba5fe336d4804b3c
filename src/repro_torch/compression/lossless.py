"""Host-side lossless stage of the codec (paper §4.3 lines 15-17).

After the lossy half (device kernels or the ``pwrel`` reference) has turned
a plane into uint16 codes + a sign bitmap + ``l_max``, this module does the
part the paper keeps on the CPU, mirroring bitcomp's lossless stage:

* ``encode_codes`` / ``decode_codes`` — zlib the little-endian uint16 code
  stream (level 1, throughput-oriented).
* ``prescan_encode_bitmap`` / ``prescan_decode_bitmap`` — the bitmap
  *pre-scan*: split into chunks, drop all-0 / all-1 chunks (signs repeat
  over long ranges — the paper's warp-ballot observation), keep a 2-bit
  flag per chunk, zlib what remains.
Everything here is plain numpy + zlib and releases the GIL, so it runs in
the pipeline's worker threads.  (The device wire format's sign bytes are
LSB-first ``np.packbits(bitorder="little")`` layout — ``device_codec``
converts at the byte level directly.)
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

__all__ = [
    "encode_codes", "decode_codes",
    "prescan_encode_bitmap", "prescan_decode_bitmap",
    "encode_bitmap", "decode_bitmap",
    "ZLEVEL",
]

_CHUNK_BYTES = 128          # bitmap pre-scan chunk = 1024 bits
ZLEVEL = 1                  # throughput-oriented, like bitcomp

_FLAG_ZERO, _FLAG_ONE, _FLAG_MIXED = 0, 1, 2


# --------------------------------------------------------------------------
# uint16 code streams
# --------------------------------------------------------------------------

def encode_codes(codes: np.ndarray) -> bytes:
    """uint16 code array -> zlib'd little-endian byte stream."""
    codes = np.ascontiguousarray(codes, dtype="<u2")
    return zlib.compress(codes.tobytes(), ZLEVEL)


def decode_codes(blob: bytes, n: int) -> np.ndarray:
    """Inverse of :func:`encode_codes`; returns exactly ``n`` uint16 codes."""
    return np.frombuffer(zlib.decompress(blob), dtype="<u2", count=n)


# --------------------------------------------------------------------------
# sign bitmaps
# --------------------------------------------------------------------------

def prescan_encode_bitmap(bits: np.ndarray) -> bytes:
    """Pack a bool array to bits, RLE away uniform chunks, zlib the rest.

    Layout: u32 n_bits | u32 n_mixed | flags(2b/chunk, packed) | z(mixed).
    """
    bits = np.asarray(bits, dtype=bool).reshape(-1)
    packed = np.packbits(bits)  # big-endian bit order within bytes
    n = packed.size
    n_chunks = (n + _CHUNK_BYTES - 1) // _CHUNK_BYTES
    pad = n_chunks * _CHUNK_BYTES - n
    if pad:
        packed = np.concatenate([packed, np.zeros(pad, dtype=np.uint8)])
    chunks = packed.reshape(n_chunks, _CHUNK_BYTES)
    all_zero = (chunks == 0x00).all(axis=1)
    all_one = (chunks == 0xFF).all(axis=1)
    flags = np.full(n_chunks, _FLAG_MIXED, dtype=np.uint8)
    flags[all_zero] = _FLAG_ZERO
    flags[all_one] = _FLAG_ONE
    mixed = chunks[flags == _FLAG_MIXED]
    # pack 2-bit flags, 4 per byte
    fpad = (-len(flags)) % 4
    fl = np.concatenate([flags, np.zeros(fpad, dtype=np.uint8)]).reshape(-1, 4)
    fpacked = (fl[:, 0] | (fl[:, 1] << 2) | (fl[:, 2] << 4) | (fl[:, 3] << 6))
    zmixed = zlib.compress(mixed.tobytes(), ZLEVEL)
    head = struct.pack("<II", int(bits.size), int(mixed.shape[0]))
    return head + fpacked.astype(np.uint8).tobytes() + zmixed


def prescan_decode_bitmap(blob: bytes) -> np.ndarray:
    n_bits, n_mixed = struct.unpack_from("<II", blob, 0)
    n_bytes = (n_bits + 7) // 8
    n_chunks = (n_bytes + _CHUNK_BYTES - 1) // _CHUNK_BYTES
    f_len = (n_chunks + 3) // 4
    off = 8
    fpacked = np.frombuffer(blob, dtype=np.uint8, count=f_len, offset=off)
    off += f_len
    flags = np.empty(n_chunks, dtype=np.uint8)
    idx = np.arange(n_chunks)
    flags[:] = (fpacked[idx // 4] >> (2 * (idx % 4))) & 0x3
    mixed = np.frombuffer(zlib.decompress(blob[off:]), dtype=np.uint8)
    mixed = mixed.reshape(n_mixed, _CHUNK_BYTES) if n_mixed else \
        mixed.reshape(0, _CHUNK_BYTES)
    chunks = np.zeros((n_chunks, _CHUNK_BYTES), dtype=np.uint8)
    chunks[flags == _FLAG_ONE] = 0xFF
    chunks[flags == _FLAG_MIXED] = mixed
    packed = chunks.reshape(-1)[:n_bytes]
    return np.unpackbits(packed, count=n_bits).astype(bool)


def encode_bitmap(bits: np.ndarray, prescan: bool = True) -> bytes:
    """Bool sign array -> bitmap blob (prescan RLE or plain zlib'd packbits)."""
    if prescan:
        return prescan_encode_bitmap(bits)
    return zlib.compress(np.packbits(np.asarray(bits, bool)).tobytes(), ZLEVEL)


def decode_bitmap(blob: bytes, n: int, prescan: bool = True) -> np.ndarray:
    """Inverse of :func:`encode_bitmap`; returns ``n`` bools."""
    if prescan:
        return prescan_decode_bitmap(blob)
    return np.unpackbits(
        np.frombuffer(zlib.decompress(blob), dtype=np.uint8), count=n
    ).astype(bool)
