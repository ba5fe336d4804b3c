"""Mixture-of-Experts layer: top-k routing with sort-based capacity dispatch.

The port of ``repro/models/moe.py``.  Tokens are sorted by expert id (a
stable sort, as ``jnp.argsort``), ranked within their expert's run and
scattered into an (E, C, d) buffer; the experts run as batched SwiGLU
GEMMs (E, C, d) x (E, d, ff).  A token ranked past the capacity C goes to
the drop bin, row E·C, which is thrown away.  Arctic's ``dense_residual``
adds a dense SwiGLU branch beside the experts.

The capacity is a host int from the static shapes, and nothing reads a
device value back, so a decode step with an MoE can be captured as one
CUDA graph.  The combine sums each token's k weighted rows in f32 in the
order of its k choices (``repro`` scatter-adds them onto zeros; for k <= 2
the two orders give the same bits), never with atomics, so a replayed step
equals the eager one bit for bit.

``repro``'s ``_pick_ec_axes`` and ``_constrain`` are sharding hints for a
JAX mesh and no-ops on one device; they have no counterpart.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.devices import resolve_device
from .config import ModelConfig, MoEConfig
from .layers import dense_init
from .mlp import init_mlp_params, mlp

__all__ = ["init_moe_params", "moe_layer", "capacity", "route", "dispatch"]


def _expert_init(gen, shape, lead, dtype, device) -> torch.Tensor:
    """An expert stack ``lead + (E,) + shape``, fan-in ``shape[0]``, drawn
    one (d, ff) matrix at a time: the f32 draw of a whole stack would
    need four bytes an element on top of the weights."""
    out = torch.empty(lead + shape, dtype=dtype, device=device)
    if out.device.type == "meta":
        return out
    flat = out.view(-1, *shape[-2:])
    for i in range(flat.shape[0]):
        flat[i] = dense_init(gen, shape[-2:], 0, dtype, device)
    return out


def init_moe_params(gen, cfg: ModelConfig, dtype=torch.bfloat16,
                    device=None, lead=()) -> dict:
    """Router (f32), expert stacks (E, d, ff) / (E, ff, d) and, for
    ``dense_residual``, the dense branch; each with the leading axes
    ``lead``; ``device=None`` means ``cuda:0``."""
    mc = cfg.moe
    device = resolve_device(device)
    d, ff, E = cfg.d_model, cfg.d_ff, mc.n_experts
    prm = {
        "router": dense_init(gen, lead + (d, E), len(lead), torch.float32,
                             device),
        "w_in": _expert_init(gen, (E, d, ff), lead, dtype, device),
        "w_gate": _expert_init(gen, (E, d, ff), lead, dtype, device),
        "w_out": _expert_init(gen, (E, ff, d), lead, dtype, device),
    }
    if mc.dense_residual:
        prm["dense"] = init_mlp_params(gen, d, mc.dense_d_ff or ff, "silu",
                                       dtype, device, lead)
    return prm


def capacity(n_tokens: int, mc: MoEConfig) -> int:
    """Slots an expert: cf times the fair share of the T·k choices, at
    least 4 (decode: T = batch), at most T·k (provably drop-free)."""
    Tk = n_tokens * mc.top_k
    return min(Tk, max(4, int((Tk / mc.n_experts) * mc.capacity_factor)))


def route(xt: torch.Tensor, router: torch.Tensor, k: int):
    """xt (T, d) -> (gates (T, k) f32, renormalised over the k choices;
    expert ids (T, k)), from f32 router logits."""
    probs = torch.softmax(xt.to(torch.float32) @ router, dim=-1)
    gates, ids = torch.topk(probs, k, dim=-1)
    return gates / gates.sum(dim=-1, keepdim=True), ids


def dispatch(ids: torch.Tensor, E: int, C: int):
    """Expert ids (T, k) -> (order, slot, keep) over the T·k choices
    sorted by expert (stable): ``order`` the sort, ``slot`` each sorted
    choice's row of the (E·C + 1)-row buffer (E·C, the drop bin, past the
    capacity), ``keep`` whether it has a slot."""
    flat = ids.reshape(-1)
    order = torch.argsort(flat, stable=True)
    sorted_e = flat[order]
    idx = torch.arange(flat.numel(), device=ids.device)
    starts = torch.ones_like(sorted_e, dtype=torch.bool)
    starts[1:] = sorted_e[1:] != sorted_e[:-1]
    run_start = torch.where(starts, idx, torch.zeros_like(idx))
    rank = idx - torch.cummax(run_start, dim=0).values   # pos within expert
    keep = rank < C
    slot = torch.where(keep, sorted_e * C + rank,
                       torch.full_like(rank, E * C))
    return order, slot, keep


def moe_layer(x: torch.Tensor, prm: dict, cfg: ModelConfig) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d)."""
    mc = cfg.moe
    B, S, d = x.shape
    T, k, E = B * S, mc.top_k, mc.n_experts
    C = capacity(T, mc)
    xt = x.reshape(T, d)
    gates, ids = route(xt, prm["router"], k)
    order, slot, keep = dispatch(ids, E, C)
    token = torch.arange(T, device=x.device)[:, None].expand(T, k) \
        .reshape(-1)[order]

    # scatter the sorted choices into (E·C + 1, d); the last row is the
    # drop bin, which several dropped choices may write and nobody reads
    buf = torch.zeros((E * C + 1, d), dtype=x.dtype, device=x.device)
    buf.index_copy_(0, slot, xt[token])
    h = buf[:E * C].reshape(E, C, d)

    # batched expert SwiGLU
    hin = torch.bmm(h, prm["w_in"])
    hgate = F.silu(torch.bmm(h, prm["w_gate"]))
    hout = torch.bmm(hin * hgate, prm["w_out"]).reshape(E * C, d)

    # combine: each choice's row back in (token, choice) order, weighted in
    # f32, the k rows of a token summed in choice order
    rows = torch.where(keep[:, None], hout[slot.clamp(max=E * C - 1)],
                       torch.zeros((), dtype=x.dtype, device=x.device))
    weighted = rows.to(torch.float32) * gates.reshape(-1)[order][:, None]
    unsorted = torch.empty_like(weighted).index_copy_(0, order, weighted)
    unsorted = unsorted.reshape(T, k, d)
    out = unsorted[:, 0]
    for j in range(1, k):
        out = out + unsorted[:, j]
    out = out.to(x.dtype).reshape(B, S, d)

    if mc.dense_residual:
        out = out + mlp(x, prm["dense"], "silu")
    return out
