"""u16 code packing and sign-bitmap packing in the TPU kernels' layout.

The ports of the TPU kernels of ``repro/kernels/pack.py``, with their
signatures:

* ``pack_codes_tiles`` / ``unpack_codes_tiles`` — two u16 codes per int32
  word, element 2j in the low half and 2j+1 in the high half, so a
  little-endian view of the words is the row-major u16 code stream;
* ``pack_bitmap_tiles`` / ``unpack_bitmap_tiles`` — ballot-style sign
  packing, 32 lanes -> one int32 word, bit i of word w = lane 32w + i.

On a CUDA tensor each launches its hand-written kernel in ``csrc/pack.cu``
(see the note there for what bounds them); on a CPU tensor it runs its
plain version in :mod:`.ref`.  Any other device raises — there is no
fallback from a kernel.  The device codec's main path does not call the
code packers: its fused encode and decode kernels (``csrc/codec.cu``)
store and read the u16 stream directly.

:data:`launch_counts` counts each kernel's launches (CPU calls do not
count).  ``tile_rows`` is kept for the signatures; the results do not
depend on it.
"""
from __future__ import annotations

import ctypes

import torch

from . import build
from .codec import _cuda_device
from .ref import (pack_bitmap_tiles_ref, pack_codes_tiles_ref,
                  unpack_bitmap_tiles_ref, unpack_codes_tiles_ref)

__all__ = ["pack_codes_tiles", "unpack_codes_tiles", "pack_bitmap_tiles",
           "unpack_bitmap_tiles", "CODE_WORDS", "BITMAP_WORDS",
           "launch_counts", "reset_launch_counts"]

_LANES = 128
CODE_WORDS = _LANES // 2       # int32 words per row of packed u16 codes
BITMAP_WORDS = _LANES // 32    # int32 words per row of packed sign bits

#: kernel name -> launches since the last reset
launch_counts: dict[str, int] = {"pack_codes_tiles": 0,
                                 "unpack_codes_tiles": 0,
                                 "pack_bitmap_tiles": 0,
                                 "unpack_bitmap_tiles": 0}

_fns = None    # C entry points by kernel name, bound at first CUDA call


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _kernels() -> dict:
    global _fns
    if _fns is None:
        p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        _fns = build.bind("pack", {
            "pack_codes_tiles": ("pack_codes_i32", [p, p, i64, p]),
            "unpack_codes_tiles": ("unpack_codes_i32", [p, p, i64, p]),
            "pack_bitmap_tiles": ("pack_bitmap_i32", [p, i32, p, i64, p]),
            "unpack_bitmap_tiles": ("unpack_bitmap_i32", [p, p, i64, p]),
        }, "pack_error_string")
    return _fns


def _launch(name: str, dev: torch.device, *args) -> None:
    fns = _kernels()
    with torch.cuda.device(dev):
        rc = fns[name](*args, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           f"{fns['error'](rc).decode()} (cudaError {rc})")
    launch_counts[name] += 1


def _rows(t: torch.Tensor, width: int, name: str) -> int:
    if t.dim() != 2 or t.shape[1] != width or t.shape[0] == 0:
        raise ValueError(f"{name}: want (rows, {width}), got "
                         f"{tuple(t.shape)}")
    return t.shape[0]


def _need_i32(t: torch.Tensor, name: str) -> None:
    if t.dtype != torch.int32 or not t.is_contiguous():
        raise ValueError(f"{name}: want a contiguous int32 tensor, got "
                         f"{t.dtype} with strides {t.stride()}")


def pack_codes_tiles(codes: torch.Tensor, *, tile_rows: int = 8):
    """codes (rows, 128) int32 in [0, 65535] -> (rows, 64) int32 words."""
    rows = _rows(codes, _LANES, "pack_codes_tiles")
    dev = _cuda_device((codes,), "pack_codes_tiles")
    if dev is None:
        return pack_codes_tiles_ref(codes)
    _need_i32(codes, "pack_codes_tiles codes")
    words = torch.empty((rows, CODE_WORDS), dtype=torch.int32, device=dev)
    _launch("pack_codes_tiles", dev, codes.data_ptr(), words.data_ptr(),
            rows * CODE_WORDS)
    return words


def unpack_codes_tiles(packed: torch.Tensor, *, tile_rows: int = 8):
    """(rows, 64) int32 u16-pair words -> (rows, 128) int32 codes."""
    rows = _rows(packed, CODE_WORDS, "unpack_codes_tiles")
    dev = _cuda_device((packed,), "unpack_codes_tiles")
    if dev is None:
        return unpack_codes_tiles_ref(packed)
    _need_i32(packed, "unpack_codes_tiles packed")
    codes = torch.empty((rows, _LANES), dtype=torch.int32, device=dev)
    _launch("unpack_codes_tiles", dev, packed.data_ptr(), codes.data_ptr(),
            rows * CODE_WORDS)
    return codes


def pack_bitmap_tiles(bits: torch.Tensor, *, tile_rows: int = 8):
    """bits (rows, 128) bool or int32 (nonzero = set) -> (rows, 4) int32
    ballot words (LSB first).  The JAX package sums ``bit << lane`` over
    int32 bits, which agrees for bits in {0, 1}."""
    rows = _rows(bits, _LANES, "pack_bitmap_tiles")
    dev = _cuda_device((bits,), "pack_bitmap_tiles")
    if dev is None:
        return pack_bitmap_tiles_ref(bits)
    widths = {torch.bool: 1, torch.int32: 4}
    if bits.dtype not in widths or not bits.is_contiguous():
        raise ValueError("pack_bitmap_tiles: want contiguous bool or int32 "
                         f"bits, got {bits.dtype} with strides "
                         f"{bits.stride()}")
    words = torch.empty((rows, BITMAP_WORDS), dtype=torch.int32, device=dev)
    _launch("pack_bitmap_tiles", dev, bits.data_ptr(), widths[bits.dtype],
            words.data_ptr(), rows * _LANES)
    return words


def unpack_bitmap_tiles(packed: torch.Tensor, *, tile_rows: int = 8):
    """(rows, 4) int32 ballot words -> (rows, 128) int32 bits in {0, 1}."""
    rows = _rows(packed, BITMAP_WORDS, "unpack_bitmap_tiles")
    dev = _cuda_device((packed,), "unpack_bitmap_tiles")
    if dev is None:
        return unpack_bitmap_tiles_ref(packed)
    _need_i32(packed, "unpack_bitmap_tiles packed")
    bits = torch.empty((rows, _LANES), dtype=torch.int32, device=dev)
    _launch("unpack_bitmap_tiles", dev, packed.data_ptr(), bits.data_ptr(),
            rows * _LANES)
    return bits
