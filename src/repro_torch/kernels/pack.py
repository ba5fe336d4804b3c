"""u16 code packing in the TPU kernels' layout.

``pack_codes_tiles`` / ``unpack_codes_tiles`` keep the signatures of
``repro/kernels/pack.py``: two u16 codes per int32 word, element 2j in the
low half and 2j+1 in the high half, so a little-endian view of the words
is the row-major u16 code stream.  On the card that packing is not a
kernel of its own: the encode kernel of ``csrc/codec.cu`` stores u16 codes
directly and the decode kernel reads them (see
:func:`~repro_torch.kernels.codec.encode_planes`), so no int32 code array
reaches device memory.  These wrappers run their plain versions for CPU
tensors and raise for CUDA tensors, pointing there.
"""
from __future__ import annotations

import torch

from .codec import _cuda_device
from .ref import pack_codes_tiles_ref, unpack_codes_tiles_ref

__all__ = ["pack_codes_tiles", "unpack_codes_tiles", "CODE_WORDS"]

_LANES = 128
CODE_WORDS = _LANES // 2


def _cpu_only(t: torch.Tensor, name: str) -> None:
    if _cuda_device((t,), name) is not None:
        raise NotImplementedError(
            f"{name}: on CUDA the u16 packing is fused into the encode and "
            "decode kernels (csrc/codec.cu); call "
            "repro_torch.kernels.codec.encode_planes / decode_planes")


def pack_codes_tiles(codes: torch.Tensor, *, tile_rows: int = 8):
    """codes (rows, 128) int32 in [0, 65535] -> (rows, 64) int32 words.
    ``tile_rows`` is kept for the signature."""
    if codes.dim() != 2 or codes.shape[1] != _LANES:
        raise ValueError(f"codes must be (rows, {_LANES}), got "
                         f"{tuple(codes.shape)}")
    _cpu_only(codes, "pack_codes_tiles")
    return pack_codes_tiles_ref(codes)


def unpack_codes_tiles(packed: torch.Tensor, *, tile_rows: int = 8):
    """(rows, 64) int32 u16-pair words -> (rows, 128) int32 codes."""
    if packed.dim() != 2 or packed.shape[1] != CODE_WORDS:
        raise ValueError(f"packed must be (rows, {CODE_WORDS}), got "
                         f"{tuple(packed.shape)}")
    _cpu_only(packed, "unpack_codes_tiles")
    return unpack_codes_tiles_ref(packed)
