"""Public wrappers around the hand-written kernels, by the JAX package's
names (``repro/kernels/ops.py``).

Each runs on the device of the tensors it is given: on a CUDA tensor the
kernels of ``csrc/`` launch, on a CPU tensor their plain versions run.
The JAX package's ``default_interpret`` (a switch of Pallas' interpret
mode) has no counterpart: the tensor's device makes that choice here.

* :func:`apply_fused_gate` — one fused unitary on a flat group array:
  the qubit-minor transpose as a torch ``permute``, then the
  ``gemm_planes`` (dense) or ``diag_apply`` (diagonal) kernel on the
  re/im planes, then the inverse permutation.  The per-gate stage compute
  (``EngineConfig(gate_schedule=False)``) calls it once per fused gate.
* :func:`quantize_block` / :func:`dequantize_block` — pwrel on one plane,
  through ``quantize_tiles`` / ``dequantize_tiles`` (the codec kernels).
* :func:`pack_codes` / :func:`unpack_codes` and :func:`pack_sign_bitmap`
  / :func:`unpack_sign_bitmap` — the boundary packing of ``csrc/pack.cu``.

Codes come back as int32 in [0, 65535] (the JAX package returns uint16;
torch has no general uint16 arithmetic) and are taken as any integer
tensor; an int16 tensor is read as the u16 bits it carries.
"""
from __future__ import annotations

import numpy as np
import torch

from ..compression.pwrel import log_step
from . import gate_apply as _ga
from . import pack as _pk
from . import quantize as _qz

__all__ = ["apply_fused_gate", "quantize_block", "dequantize_block",
           "pack_codes", "unpack_codes",
           "pack_sign_bitmap", "unpack_sign_bitmap"]

_LANES = 128


# --------------------------------------------------------------------------
# fused gate application (the per-gate stage compute)
# --------------------------------------------------------------------------

def apply_fused_gate(amps: torch.Tensor, mat: torch.Tensor,
                     vqubits: tuple[int, ...], nv: int,
                     diag: bool) -> torch.Tensor:
    """Apply a fused unitary to a flat 2^nv complex64 group array.

    ``mat`` is the (2^k, 2^k) unitary — or its (2^k,) diagonal if
    ``diag`` — on the array's device.  Returns a new complex64 array.
    """
    k = len(vqubits)
    K = 2 ** k
    axes = [nv - 1 - q for q in vqubits]
    rest = [a for a in range(nv) if a not in axes]
    perm = rest + [axes[j] for j in range(k - 1, -1, -1)]
    t = amps.reshape((2,) * nv).permute(perm).reshape(-1, K)
    ar = t.real.contiguous()             # .real/.imag are strided views
    ai = t.imag.contiguous()
    mat = mat.to(torch.complex64)
    if diag:
        cr, ci = _ga.diag_apply(ar, ai, mat.real.contiguous(),
                                mat.imag.contiguous())
    else:
        b = mat.T                        # C = A @ U^T
        cr, ci = _ga.gemm_planes(ar, ai, b.real, b.imag)
    out = torch.complex(cr, ci)
    inv = np.argsort(np.asarray(perm)).tolist()
    return out.reshape((2,) * nv).permute(inv).reshape(-1)


# --------------------------------------------------------------------------
# pwrel quantize / dequantize (device half of the compressor)
# --------------------------------------------------------------------------

def _lane_rows(x: torch.Tensor, what: str) -> int:
    n = x.shape[0]
    if x.dim() != 1 or n % _LANES:
        raise ValueError(f"{what} size {tuple(x.shape)} not lane-aligned "
                         f"(want (N,) with N % {_LANES} == 0)")
    return n // _LANES


def _codes_i32(codes: torch.Tensor) -> torch.Tensor:
    if codes.dtype == torch.int16:       # u16 bits
        return codes.to(torch.int32) & 0xFFFF
    return codes.to(torch.int32)


def quantize_block(x: torch.Tensor, b_r: float):
    """f32 plane (N,) with N % 128 == 0 -> (codes (N,) int32 in
    [0, 65535], packed signs (N/128, 4) int32, tile flags, l_max ()
    f32)."""
    x = x.to(torch.float32)
    rows = _lane_rows(x, "plane")
    max_abs = x.abs().max()
    l_max = torch.where(max_abs > 0,
                        torch.log2(torch.clamp(max_abs, min=1e-45)),
                        torch.zeros_like(max_abs)).reshape(1, 1)
    codes, packed, flags = _qz.quantize_tiles(
        x.reshape(rows, _LANES).contiguous(), l_max, log_step(b_r))
    return codes.reshape(-1), packed, flags, l_max.reshape(())


def dequantize_block(codes: torch.Tensor, packed_signs: torch.Tensor,
                     l_max, b_r: float) -> torch.Tensor:
    """codes (N,) + packed signs (N/128, 4) int32 + l_max -> f32 (N,)."""
    rows = _lane_rows(codes, "code stream")
    l_max = torch.as_tensor(l_max, dtype=torch.float32,
                            device=codes.device).reshape(1, 1)
    out = _qz.dequantize_tiles(_codes_i32(codes).reshape(rows, _LANES),
                               packed_signs.to(torch.int32).contiguous(),
                               l_max, log_step(b_r))
    return out.reshape(-1)


# --------------------------------------------------------------------------
# boundary packing (device wire format of the §4.3 codec)
# --------------------------------------------------------------------------

def pack_codes(codes: torch.Tensor) -> torch.Tensor:
    """codes (N,) in [0, 65535], N % 128 == 0 -> (N/128, 64) int32
    u16-pair words; a little-endian host view of the result is the
    row-major u16 code stream."""
    rows = _lane_rows(codes, "code stream")
    return _pk.pack_codes_tiles(_codes_i32(codes).reshape(rows, _LANES))


def unpack_codes(packed: torch.Tensor) -> torch.Tensor:
    """(rows, 64) int32 u16-pair words -> (rows*128,) int32 codes."""
    return _pk.unpack_codes_tiles(packed).reshape(-1)


def pack_sign_bitmap(bits: torch.Tensor) -> torch.Tensor:
    """bits (N,) bool/int, N % 128 == 0 -> (N/128, 4) int32 ballot words
    (LSB = lowest lane), as the pack fused into :func:`quantize_block`."""
    rows = _lane_rows(bits, "bitmap")
    if bits.dtype not in (torch.bool, torch.int32):
        bits = bits.to(torch.int32)
    return _pk.pack_bitmap_tiles(bits.reshape(rows, _LANES).contiguous())


def unpack_sign_bitmap(packed: torch.Tensor) -> torch.Tensor:
    """(rows, 4) int32 ballot words -> (rows*128,) bool signs."""
    return _pk.unpack_bitmap_tiles(packed).reshape(-1) == 1
