"""Point-wise relative-error quantization (paper §4.3, Alg. 2) — torch f32.

Scheme (per real plane of a complex SV block):

1. sign bitmap          s_i = (x_i < 0)                       (1 bit/elem)
2. log transform        L_i = log2 |x_i|
3. absolute-bound       quantize L with step 2*b_a, b_a = log2(1 + b_r)
   quantization         => point-wise relative error <= b_r  (Eq. 1/2)

Codes are anchored at the block maximum:  code = CODE_MAX - round((l_max -
L)/step), clipped to [1, CODE_MAX]; code 0 is the exact-zero escape.  With
uint16 codes and b_r = 1e-3 the representable dynamic range below the block
max is ~189 log2 units (~10^57): anything smaller is quantized to exact 0.

All arithmetic is float32 on whatever device the plane lives on (the host
codec hands it CPU tensors).  ``torch.round`` rounds half to even, like
``jnp.round``.  The result is NOT bit-identical to the JAX package's
quantizer: XLA's CPU ``log2`` is not correctly rounded, so a code can differ
by exactly 1 at a rounding tie and ``exp2`` by a few ulp; both stay inside
the ``b_r`` bound.  Subnormal magnitudes (|x| < 2^-126) are quantized from
their true log2 here, where XLA flushes them to zero.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

__all__ = [
    "PwRelParams", "quantize_plane", "dequantize_plane",
    "CODE_MAX", "log_step",
]

CODE_MAX = 65535  # uint16 code space; 0 = exact zero escape


def log_step(b_r: float) -> float:
    """Quantization step in log2 domain: 2 * b_a = 2 * log2(1 + b_r)."""
    return float(2.0 * np.log2(1.0 + b_r))


@dataclass(frozen=True)
class PwRelParams:
    b_r: float = 1e-3  # the paper's default point-wise relative bound

    @property
    def step(self) -> float:
        return log_step(self.b_r)


def _tensor(x, np_dtype) -> torch.Tensor:
    """A torch view of ``x`` (tensors pass through; numpy inputs are
    converted on the host, copying only when read-only or of another
    dtype)."""
    if isinstance(x, torch.Tensor):
        return x
    a = np.asarray(x, dtype=np_dtype)
    if not a.flags.writeable:
        a = a.copy()
    return torch.from_numpy(a)


def quantize_plane(x, params: PwRelParams):
    """f32 plane -> (int32 codes in [0, CODE_MAX], bool signs, f32 l_max
    0-d tensor), all on ``x``'s device."""
    x = _tensor(x, np.float32).to(torch.float32)
    step = torch.tensor(params.step, dtype=torch.float32, device=x.device)
    absx = x.abs()
    signs = x < 0
    max_abs = absx.max()
    l_max = torch.where(max_abs > 0,
                        torch.log2(torch.clamp(max_abs, min=1e-45)),
                        torch.zeros((), dtype=torch.float32, device=x.device))
    L = torch.log2(torch.clamp(absx, min=1e-45))    # -149.. subnormal floor
    d = torch.round((l_max - L) / step)
    codes_f = torch.where(absx <= 0, torch.zeros_like(d), CODE_MAX - d)
    codes = torch.clamp(codes_f, 0.0, float(CODE_MAX)).to(torch.int32)
    return codes, signs, l_max


def dequantize_plane(codes, signs, l_max, params: PwRelParams) -> torch.Tensor:
    """Inverse of :func:`quantize_plane` -> f32 plane on ``codes``' device."""
    codes = _tensor(codes, np.int32).to(torch.int32)
    dev = codes.device
    signs = _tensor(signs, np.bool_).to(device=dev, dtype=torch.bool)
    l_max = torch.as_tensor(l_max, dtype=torch.float32, device=dev)
    step = torch.tensor(params.step, dtype=torch.float32, device=dev)
    d = CODE_MAX - codes.to(torch.float32)
    mag = torch.exp2(l_max - d * step)
    mag = torch.where(codes == 0, torch.zeros_like(mag), mag)
    return torch.where(signs, -mag, mag)
