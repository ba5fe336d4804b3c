"""xLSTM blocks (arXiv:2405.04517): mLSTM (matrix memory) + sLSTM (scalar).

The port of ``repro/models/xlstm.py``.  mLSTM — exponential-gated
matrix-memory LSTM.  Train/prefill uses the paper's parallel (quadratic)
form, an S x S gated-attention-like matrix with log-domain max
stabilisation; decode the O(1) recurrent form

    C_t = f_t C_{t-1} + i_t v_t k_t^T        (per head, C: hd x hd)
    n_t = f_t n_{t-1} + i_t k_t
    h_t = o_t ⊙ (C_t q_t) / max(|n_t·q_t|, exp(-m_t))

sLSTM — scalar-memory LSTM with exponential gating and a true nonlinear
recurrence (h feeds back into the gates): ``repro``'s ``lax.scan`` over
time is a Python loop over time here.

Both sit in the paper's block: up-projection with a SiLU gate branch,
mixer, down-projection.  Their states are f32, as ``repro``'s.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.devices import resolve_device
from .config import ModelConfig
from .layers import dense_init

__all__ = [
    "init_mlstm_params", "mlstm_full", "mlstm_decode", "init_mlstm_state",
    "init_slstm_params", "slstm_full", "slstm_decode", "init_slstm_state",
]

NEG_INF = -2.0 ** 30


def _dense(gen, lead, dtype, device):
    def w(shape, dt=dtype):
        return dense_init(gen, lead + shape, len(lead), dt, device)
    return w


# ===========================================================================
# mLSTM
# ===========================================================================

def init_mlstm_params(gen, cfg: ModelConfig, dtype=torch.bfloat16,
                      device=None, lead=()) -> dict:
    """The block's weights, each with the leading (stacking) axes
    ``lead``; ``device=None`` means ``cuda:0``."""
    d = cfg.d_model
    H, hd = cfg.n_heads, d // cfg.n_heads
    w = _dense(gen, lead, dtype, resolve_device(device))
    return {
        "w_up": w((d, 2 * d)),                      # mixer + gate
        "w_q": w((d, H * hd)),
        "w_k": w((d, H * hd)),
        "w_v": w((d, H * hd)),
        "w_if": w((d, 2 * H), torch.float32),
        "w_down": w((d, d)),
    }


def _mlstm_qkv(z: torch.Tensor, prm: dict, H: int):
    B, S, d = z.shape
    hd = d // H
    q = (z @ prm["w_q"]).reshape(B, S, H, hd).transpose(1, 2)
    k = (z @ prm["w_k"]).reshape(B, S, H, hd).transpose(1, 2)
    v = (z @ prm["w_v"]).reshape(B, S, H, hd).transpose(1, 2)
    gates = z.to(torch.float32) @ prm["w_if"]       # (B, S, 2H)
    i_raw = gates[..., :H].transpose(1, 2)          # (B, H, S)
    f_raw = gates[..., H:].transpose(1, 2)
    return q, k, v, i_raw, f_raw


def _up(x: torch.Tensor, prm: dict):
    d = x.shape[-1]
    up = x @ prm["w_up"]
    return up[..., :d], F.silu(up[..., d:])


def mlstm_full(x: torch.Tensor, prm: dict, cfg: ModelConfig,
               want_state: bool = False):
    """Parallel form. x: (B, S, d) -> (out, final_state | None).

    The final recurrent state is rebuilt exactly from the parallel
    quantities (telescoping the recurrence):
        m_S  = max_j (F_S - F_j + i~_j)
        w_j  = exp(F_S - F_j + i~_j - m_S)
        C_S  = sum_j w_j v_j (k_j/sqrt(hd))^T,   n_S = sum_j w_j k_j/sqrt(hd)
    so prefill hands decode an O(1) state.
    """
    B, S, d = x.shape
    H = cfg.n_heads
    hd = d // H
    z, gate = _up(x, prm)
    q, k, v, i_raw, f_raw = _mlstm_qkv(z, prm, H)

    logf = F.logsigmoid(f_raw)                      # (B, H, S)
    Fc = torch.cumsum(logf, dim=-1)                 # sum_{<=t} log f
    # D~_ij = F_i - F_j + i~_j   (j <= i)
    Dt = Fc[..., :, None] - Fc[..., None, :] + i_raw[..., None, :]
    causal = torch.ones((S, S), dtype=torch.bool, device=x.device).tril()
    Dt = torch.where(causal, Dt, NEG_INF)
    m = Dt.amax(dim=-1, keepdim=True)               # (B, H, S, 1)
    Dmat = torch.exp(Dt - m)

    scores = torch.einsum("bhsd,bhtd->bhst", q.float(), k.float()) \
        * (hd ** -0.5)
    Smat = scores * Dmat
    nrm = torch.maximum(Smat.sum(dim=-1, keepdim=True).abs(), torch.exp(-m))
    # the normalised matrix rounded to v's dtype, f32 sums, v's dtype out
    h = torch.einsum("bhst,bhtd->bhsd", (Smat / nrm).to(v.dtype).float(),
                     v.float()).to(v.dtype)
    h = h.transpose(1, 2).reshape(B, S, d)
    out = (h * gate) @ prm["w_down"]

    state = None
    if want_state:
        w_log = Fc[..., -1:] - Fc + i_raw           # (B, H, S)
        m_S = w_log.amax(dim=-1)                    # (B, H)
        w = torch.exp(w_log - m_S[..., None])
        kf = k.float() * (hd ** -0.5)
        vf = v.float()
        C_S = torch.einsum("bhs,bhsd,bhse->bhde", w, vf, kf)
        n_S = torch.einsum("bhs,bhsd->bhd", w, kf)
        state = {"C": C_S, "n": n_S, "m": m_S}
    return out, state


def init_mlstm_state(cfg: ModelConfig, batch: int, n_layers: int,
                     device=None) -> dict:
    d = cfg.d_model
    H, hd = cfg.n_heads, d // cfg.n_heads
    device = resolve_device(device)

    def zeros(*shape):
        return torch.zeros((n_layers, batch) + shape, dtype=torch.float32,
                           device=device)
    return {"C": zeros(H, hd, hd), "n": zeros(H, hd), "m": zeros(H)}


def mlstm_decode(x: torch.Tensor, prm: dict, cfg: ModelConfig,
                 C: torch.Tensor, n: torch.Tensor, m: torch.Tensor):
    """Recurrent step. x: (B, 1, d); C: (B,H,hd,hd); n: (B,H,hd); m: (B,H).
    Returns (out, C, n, m), the states new tensors."""
    B, _, d = x.shape
    H = cfg.n_heads
    hd = d // H
    z, gate = _up(x, prm)
    q, k, v, i_raw, f_raw = _mlstm_qkv(z, prm, H)
    q, k, v = q[:, :, 0], k[:, :, 0], v[:, :, 0]    # (B, H, hd)
    i_raw, f_raw = i_raw[..., 0], f_raw[..., 0]     # (B, H)

    logf = F.logsigmoid(f_raw)
    m_new = torch.maximum(logf + m, i_raw)
    f_eff = torch.exp(logf + m - m_new)[..., None]
    i_eff = torch.exp(i_raw - m_new)[..., None]

    kf = k.float() * (hd ** -0.5)
    C_new = f_eff[..., None] * C + (i_eff[..., None] * v.float()[..., :, None]
                                    * kf[..., None, :])
    n_new = f_eff * n + i_eff * kf
    qf = q.float()
    num = torch.einsum("bhde,bhe->bhd", C_new, qf)
    den = torch.maximum((n_new * qf).sum(dim=-1, keepdim=True).abs(),
                        torch.exp(-m_new)[..., None])
    h = (num / den).reshape(B, 1, d).to(x.dtype)
    out = (h * gate) @ prm["w_down"]
    return out, C_new, n_new, m_new


# ===========================================================================
# sLSTM
# ===========================================================================

def init_slstm_params(gen, cfg: ModelConfig, dtype=torch.bfloat16,
                      device=None, lead=()) -> dict:
    """The block's weights, each with the leading (stacking) axes
    ``lead``; ``device=None`` means ``cuda:0``."""
    d = cfg.d_model
    device = resolve_device(device)
    w = _dense(gen, lead, dtype, device)
    return {
        "w_gates": w((d, 4 * d)),                   # i f z o
        "r_gates": w((d, 4 * d)),                   # recurrent
        "b_gates": torch.zeros(lead + (4 * d,), dtype=torch.float32,
                               device=device),
        "w_up": w((d, 2 * d)),                      # post-FFN
        "w_down": w((d, d)),
    }


def _slstm_step(prm, carry, wx_t):
    """carry: (h, c, n, m) each (B, d) f32; wx_t: (B, 4d) f32."""
    h, c, n, m = carry
    raw = wx_t + h @ prm["r_gates"].to(torch.float32) + prm["b_gates"]
    i_raw, f_raw, z_raw, o_raw = torch.chunk(raw, 4, dim=-1)
    logf = F.logsigmoid(f_raw)
    m_new = torch.maximum(logf + m, i_raw)
    i = torch.exp(i_raw - m_new)
    f = torch.exp(logf + m - m_new)
    c_new = f * c + i * torch.tanh(z_raw)
    n_new = f * n + i
    h_new = torch.sigmoid(o_raw) * c_new / torch.clamp(n_new, min=1e-6)
    return (h_new, c_new, n_new, m_new)


def _slstm_out(h: torch.Tensor, prm: dict) -> torch.Tensor:
    d = h.shape[-1]
    up = h @ prm["w_up"]
    return (up[..., :d] * F.silu(up[..., d:])) @ prm["w_down"]


def slstm_full(x: torch.Tensor, prm: dict, cfg: ModelConfig):
    """Sequential loop over time. x: (B, S, d) -> (out, final carry)."""
    B, S, d = x.shape
    wx = (x @ prm["w_gates"]).to(torch.float32)     # (B, S, 4d)
    zero = torch.zeros((B, d), dtype=torch.float32, device=x.device)
    carry = (zero, zero, zero, zero)
    hs = []
    for t in range(S):
        carry = _slstm_step(prm, carry, wx[:, t])
        hs.append(carry[0])
    h = torch.stack(hs, dim=1).to(x.dtype)          # (B, S, d)
    return _slstm_out(h, prm), carry


def init_slstm_state(cfg: ModelConfig, batch: int, n_layers: int,
                     device=None) -> dict:
    device = resolve_device(device)
    return {key: torch.zeros((n_layers, batch, cfg.d_model),
                             dtype=torch.float32, device=device)
            for key in ("h", "c", "n", "m")}


def slstm_decode(x: torch.Tensor, prm: dict, cfg: ModelConfig, carry):
    """One-token step; carry: (h, c, n, m) each (B, d).  Returns (out,
    new carry), the new carry new tensors."""
    wx = (x[:, 0] @ prm["w_gates"]).to(torch.float32)
    carry = _slstm_step(prm, carry, wx)
    return _slstm_out(carry[0][:, None, :].to(x.dtype), prm), carry
