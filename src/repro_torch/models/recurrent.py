"""RG-LRU temporal-mixing block (RecurrentGemma / Griffin, arXiv:2402.19427).

The port of ``repro/models/recurrent.py``.  Two width-``w`` branches from
x — a gate branch (GeLU) and a signal branch (short causal conv1d, then
the RG-LRU) — multiplied and projected back:

    r_t = sigmoid(W_a x_t)        a_t = exp(c * softplus(Λ) * (-r_t))
    i_t = sigmoid(W_i x_t)
    h_t = a_t ⊙ h_{t-1} + sqrt(1 - a_t^2) ⊙ (i_t ⊙ x_t)

``repro`` runs the recurrence over a sequence with
``jax.lax.associative_scan``; torch has none, so :func:`_linear_scan` is
a log-depth doubling scan (Hillis–Steele) over time in f32, which
combines the pairs in another tree than XLA's: the states agree to f32
rounding (``tests/test_torch_recurrent.py`` states the measured
difference).  Decode is the O(1) single-step update.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.devices import resolve_device
from .config import ModelConfig
from .layers import dense_init

__all__ = ["init_rglru_params", "rglru_full", "rglru_decode",
           "init_rglru_state"]

_C = 8.0  # Griffin's gate sharpness constant


def init_rglru_params(gen, cfg: ModelConfig, dtype=torch.bfloat16,
                      device=None, lead=()) -> dict:
    """The block's weights, each with the leading (stacking) axes
    ``lead``; ``device=None`` means ``cuda:0``."""
    d = cfg.d_model
    w = cfg.rglru_width or d
    device = resolve_device(device)

    def dense(shape, dt=dtype):
        return dense_init(gen, lead + shape, len(lead), dt, device)

    return {
        "w_x": dense((d, w)),                       # signal branch
        "w_g": dense((d, w)),                       # gate branch
        "w_out": dense((w, d)),
        "conv_w": dense((cfg.conv1d_width, w)),
        "conv_b": torch.zeros(lead + (w,), dtype=dtype, device=device),
        "w_a": dense((w, w)),                       # recurrence gate
        "w_i": dense((w, w)),                       # input gate
        "lam": torch.full(lead + (w,), 0.65, dtype=torch.float32,
                          device=device),           # Λ init
    }


def _gates(u: torch.Tensor, prm: dict):
    """u: (..., w) f32 conv output -> (a, beta*u_gated) recurrence coeffs."""
    r = torch.sigmoid(u @ prm["w_a"].to(u.dtype))
    i = torch.sigmoid(u @ prm["w_i"].to(u.dtype))
    log_a = -_C * F.softplus(prm["lam"]) * r
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-6))
    return a, beta * (i * u)


def _causal_conv(x: torch.Tensor, prm: dict,
                 state: torch.Tensor | None = None):
    """Depthwise causal conv1d, width K.  x: (B, S, w).

    ``state`` carries the trailing K-1 inputs for decode; returns
    (out, new_state), the new state a new tensor.
    """
    K = prm["conv_w"].shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], K - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                 # (B, S+K-1, w)
    S = x.shape[1]
    out = xp[:, 0:S, :] * prm["conv_w"][0]
    for i in range(1, K):
        out = out + xp[:, i:i + S, :] * prm["conv_w"][i]
    new_state = xp[:, -(K - 1):, :] if K > 1 else pad
    return out + prm["conv_b"], new_state


def _linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t from h_{-1} = 0 over axis 1, as a doubling
    scan: after the round of offset o, (a_t, b_t) compose the steps
    (t - 2o, t]; log2(S) rounds."""
    S = a.shape[1]
    off = 1
    while off < S:
        b = torch.cat([b[:, :off], a[:, off:] * b[:, :-off] + b[:, off:]],
                      dim=1)
        a = torch.cat([a[:, :off], a[:, off:] * a[:, :-off]], dim=1)
        off *= 2
    return b


def rglru_full(x: torch.Tensor, prm: dict, cfg: ModelConfig):
    """Train/prefill pass. x: (B, S, d) -> (out, (h_last, conv_state))."""
    gate = F.gelu(x @ prm["w_g"], approximate="tanh")
    u, conv_state = _causal_conv(x @ prm["w_x"], prm)
    a, b = _gates(u.to(torch.float32), prm)
    h = _linear_scan(a, b)
    h_last = h[:, -1, :]                            # f32, decode state
    out = (h.to(x.dtype) * gate) @ prm["w_out"]
    return out, (h_last, conv_state)


def init_rglru_state(cfg: ModelConfig, batch: int, n_layers: int,
                     dtype=torch.bfloat16, device=None) -> dict:
    w = cfg.rglru_width or cfg.d_model
    device = resolve_device(device)
    return {
        "h": torch.zeros((n_layers, batch, w), dtype=torch.float32,
                         device=device),
        "conv": torch.zeros((n_layers, batch, cfg.conv1d_width - 1, w),
                            dtype=dtype, device=device),
    }


def rglru_decode(x: torch.Tensor, prm: dict, cfg: ModelConfig,
                 h_prev: torch.Tensor, conv_state: torch.Tensor):
    """One-token step. x: (B, 1, d) -> (out, h_new, conv_state_new), the
    new states new tensors (the caller writes them into its cache)."""
    gate = F.gelu(x @ prm["w_g"], approximate="tanh")
    u, conv_state = _causal_conv(x @ prm["w_x"], prm, state=conv_state)
    a, b = _gates(u.to(torch.float32), prm)         # (B, 1, w)
    h = a[:, 0] * h_prev + b[:, 0]
    out = (h[:, None, :].to(x.dtype) * gate) @ prm["w_out"]
    return out, h, conv_state
