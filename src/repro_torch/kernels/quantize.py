"""Point-wise relative-error quantize / dequantize in the TPU kernels' layout.

``quantize_tiles`` and ``dequantize_tiles`` keep the signatures of
``repro/kernels/quantize.py``: a (rows, 128) f32 plane, a (1, 1) ``l_max``
and ``tile_rows`` for the per-tile flags.  On a CPU tensor they run the
plain versions in :mod:`.ref`; on a CUDA tensor they launch the kernels of
``csrc/codec.cu`` over the plane as one batch of one (with int32 codes, as
this layout holds them), counted in :data:`.codec.launch_counts`.  The
device codec's main path calls the fused wave wrappers of :mod:`.codec`
instead, which never hold int32 codes.
"""
from __future__ import annotations

import torch

from .codec import _cuda_device, _need, launch_decode, launch_encode
from .ref import dequantize_tiles_ref, quantize_tiles_ref, tile_rows_for

__all__ = ["quantize_tiles", "dequantize_tiles", "DEFAULT_TILE_ROWS"]

DEFAULT_TILE_ROWS = 8
_LANES = 128
_WORDS = _LANES // 32


def _check_rows(t: torch.Tensor, width: int, name: str) -> int:
    if t.dim() != 2 or t.shape[1] != width or t.shape[0] == 0:
        raise ValueError(f"{name}: want (rows, {width}), got "
                         f"{tuple(t.shape)}")
    return t.shape[0]


def _need_scalar(l_max: torch.Tensor, name: str) -> None:
    _need(l_max, torch.float32, f"{name} l_max")
    if l_max.numel() != 1:
        raise ValueError(f"{name}: l_max must hold one value, got "
                         f"{tuple(l_max.shape)}")


def quantize_tiles(x: torch.Tensor, l_max: torch.Tensor, step: float,
                   *, tile_rows: int = DEFAULT_TILE_ROWS):
    """x (rows, 128) f32, l_max (1, 1) f32 -> (codes (rows, 128) int32,
    packed sign words (rows, 4) int32, flags (rows/tr, 3) int32)."""
    rows = _check_rows(x, _LANES, "quantize_tiles")
    dev = _cuda_device((x, l_max), "quantize_tiles")
    if dev is None:
        return quantize_tiles_ref(x, l_max, step, tile_rows)
    _need(x, torch.float32, "quantize_tiles x")
    _need_scalar(l_max, "quantize_tiles")
    n = rows * _LANES
    tr = tile_rows_for(rows, tile_rows)
    codes = torch.empty((rows, _LANES), dtype=torch.int32, device=dev)
    packed = torch.empty((rows, _WORDS), dtype=torch.int32, device=dev)
    flags = torch.ones((rows // tr, 3), dtype=torch.int32, device=dev)
    launch_encode(x, (0, 0, n, 1), 1, l_max, step, codes, packed, flags,
                  tr * _LANES)
    return codes, packed, flags


def dequantize_tiles(codes: torch.Tensor, packed_signs: torch.Tensor,
                     l_max: torch.Tensor, step: float,
                     *, tile_rows: int = DEFAULT_TILE_ROWS) -> torch.Tensor:
    """codes (rows, 128) int32 + packed signs (rows, 4) int32 + l_max
    (1, 1) f32 -> (rows, 128) f32.  ``tile_rows`` is kept for the
    signature; the result does not depend on it."""
    rows = _check_rows(codes, _LANES, "dequantize_tiles")
    if tuple(packed_signs.shape) != (rows, _WORDS):
        raise ValueError(f"dequantize_tiles: signs {tuple(packed_signs.shape)}"
                         f" for {rows} rows")
    dev = _cuda_device((codes, packed_signs, l_max), "dequantize_tiles")
    if dev is None:
        return dequantize_tiles_ref(codes, packed_signs, l_max, step)
    _need(codes, torch.int32, "dequantize_tiles codes")
    _need(packed_signs, torch.int32, "dequantize_tiles signs")
    _need_scalar(l_max, "dequantize_tiles")
    n = rows * _LANES
    out = torch.empty((rows, _LANES), dtype=torch.float32, device=dev)
    launch_decode(codes, packed_signs, l_max, step, None, 1, 1, out,
                  (0, 0, n, 1))
    return out
