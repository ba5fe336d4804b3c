"""Primitive layers: norms, RoPE, initializers (functions on tensors).

The port of ``repro/models/layers.py``.  ``Param`` (a JAX key splitter)
becomes a ``torch.Generator`` that every initializer draws from in turn;
``maybe_constrain`` has no counterpart, since the port runs on one card
with no mesh.
"""
from __future__ import annotations

import math

import torch

from ..core.devices import resolve_device

__all__ = ["rms_norm", "rope", "rope_cos_sin", "dense_init"]


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMS norm over the last axis, times ``(1 + scale)``, in f32; returns
    ``x``'s dtype."""
    dt = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + scale.to(torch.float32))).to(dt)


def rope_cos_sin(positions: torch.Tensor, head_dim: int,
                 theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """positions (..., S) int -> cos/sin (..., S, head_dim/2) f32."""
    half = head_dim // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=positions.device) / half)
    ang = positions.to(torch.float32)[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def rope(x: torch.Tensor, cos: torch.Tensor,
         sin: torch.Tensor) -> torch.Tensor:
    """Half-split rotary embedding (not interleaved).

    x: (B, S, H, hd); cos/sin: (B, S, hd/2) or (S, hd/2).
    """
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    while cos.ndim < x.ndim:    # (S, hd/2) or (B, S, hd/2) -> (B,S,1,hd/2)
        cos = cos[..., None, :] if cos.ndim == x.ndim - 1 else cos[None]
        sin = sin[..., None, :] if sin.ndim == x.ndim - 1 else sin[None]
    o1 = x1 * cos - x2 * sin
    o2 = x2 * cos + x1 * sin
    return torch.cat([o1, o2], dim=-1).to(x.dtype)


def dense_init(gen: torch.Generator | None, shape, in_axis=0,
               dtype=torch.bfloat16, device=None) -> torch.Tensor:
    """Truncated-normal fan-in init: N(0, 1) cut to (-2, 2), times
    ``fan_in ** -0.5``, drawn in f32 from ``gen`` and cast to ``dtype``.

    ``in_axis`` (an int or a tuple of axes) names the fan-in axes of
    ``shape``.  On the ``meta`` device nothing is drawn; ``device=None``
    means ``cuda:0``.
    """
    device = resolve_device(device)
    fan_in = (shape[in_axis] if isinstance(in_axis, int)
              else math.prod(shape[a] for a in in_axis))
    std = (1.0 / max(1, fan_in)) ** 0.5
    w = torch.empty(shape, dtype=torch.float32, device=device)
    if w.device.type != "meta":
        torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return w.mul_(std).to(dtype)
