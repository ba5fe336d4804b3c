"""Feed-forward blocks: SwiGLU (llama-family) / GeLU (whisper).

The port of ``repro/models/mlp.py``; activations stay in the weights'
dtype (bf16), as there.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.devices import resolve_device
from .layers import dense_init

__all__ = ["init_mlp_params", "mlp"]


def init_mlp_params(gen, d_model: int, d_ff: int, act: str,
                    dtype=torch.bfloat16, device=None, lead=()) -> dict:
    """The block's weights, each with the leading (stacking) axes
    ``lead``; ``device=None`` means ``cuda:0``."""
    device = resolve_device(device)

    def w(shape):
        return dense_init(gen, lead + shape, len(lead), dtype, device)

    prm = {"w_in": w((d_model, d_ff)), "w_out": w((d_ff, d_model))}
    if act == "silu":                 # gated
        prm["w_gate"] = w((d_model, d_ff))
    return prm


def mlp(x: torch.Tensor, prm: dict, act: str = "silu") -> torch.Tensor:
    h = x @ prm["w_in"]
    if act == "silu":
        h = F.silu(x @ prm["w_gate"]) * h
    else:
        h = F.gelu(h, approximate="tanh")     # jax.nn.gelu's default
    return h @ prm["w_out"]
