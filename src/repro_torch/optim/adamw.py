"""Optimizers: AdamW (dtype-configurable moments) and factored Adafactor.

The port of ``repro/optim/adamw.py``, with the same dataclass fields,
moment dtypes, state trees (``{"m", "v", "step"}`` and ``{"f", "step"}``)
and arithmetic, in f32.  Where ``repro`` builds new trees, ``update``
writes the new parameters and moments into the given tensors, leaf by leaf
and a slice of the leading axis at a time (:data:`SLICE_ELEMENTS`), so an
update's f32 temporaries are one slice's and not a stacked leaf's:
qwen3-4b's stacked MLP weight alone is 0.9 G elements, and a whole-leaf
update would need some seven f32 copies of it beside the parameters,
gradients and moments.  ``step`` stays a 0-d int32 tensor on the
parameters' device; the bias corrections are computed from it there, so an
update reads nothing back to the host.

``moment_dtype="bfloat16"`` halves optimizer memory; Adafactor drops the
second moment to row + column factors.  Parameters are updated under
``torch.no_grad()``; gradients are read, never written.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

__all__ = ["AdamW", "Adafactor", "make_optimizer", "tree_leaves",
           "tree_map", "SLICE_ELEMENTS"]

#: elements of one slice of an update (64 MiB of f32 a temporary)
SLICE_ELEMENTS = 1 << 24

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def tree_leaves(tree) -> list:
    """The tensors of a tree of dicts, lists and tuples, in ``jax.tree``'s
    order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the same places of the
    trees ``rest``), keeping its dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def slices(*ts: torch.Tensor, whole: int = 0):
    """Views of ``ts`` (tensors whose leading axes agree) a range of the
    leading axis at a time, each range at most :data:`SLICE_ELEMENTS`
    elements of ``ts[0]`` (one row when a row holds more).  A tensor of
    ``whole`` dims or fewer comes whole: its last ``whole`` axes are not
    cut (Adafactor's factors span a matrix's last two)."""
    t0 = ts[0]
    if t0.dim() <= whole:
        yield ts
        return
    row = t0.numel() // max(t0.shape[0], 1)
    step = max(1, SLICE_ELEMENTS // max(row, 1))
    for i in range(0, t0.shape[0], step):
        yield tuple(t[i:i + step] for t in ts)


def _moment_dtype(name: str) -> torch.dtype:
    if name not in _DTYPES:
        raise ValueError(f"moment_dtype must be one of {sorted(_DTYPES)}, "
                         f"got {name!r}")
    return _DTYPES[name]


@dataclass(frozen=True)
class AdamW:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    moment_dtype: str = "float32"

    def init(self, params):
        dt = _moment_dtype(self.moment_dtype)
        leaves = tree_leaves(params)

        def zeros(p):
            return torch.zeros_like(p, dtype=dt,
                                    memory_format=torch.contiguous_format)
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
                "step": torch.zeros((), dtype=torch.int32,
                                    device=leaves[0].device)}

    def update(self, grads, state, params):
        """Write the new parameters and moments in place; returns
        ``(params, {"m", "v", "step"})`` with ``step`` a new 0-d
        tensor."""
        step = state["step"] + 1
        b1, b2 = self.b1, self.b2
        s32 = step.to(torch.float32)
        c1 = 1.0 - torch.full_like(s32, b1) ** s32
        c2 = 1.0 - torch.full_like(s32, b2) ** s32
        with torch.no_grad():
            for p, g, m, v in zip(*(tree_leaves(t) for t in
                                    (params, grads, state["m"],
                                     state["v"]))):
                for ps, gs, ms, vs in slices(p, g, m, v):
                    g32 = gs.to(torch.float32)
                    m32 = b1 * ms.to(torch.float32) + (1 - b1) * g32
                    v32 = b2 * vs.to(torch.float32) + (1 - b2) * g32 * g32
                    delta = (m32 / c1) / (torch.sqrt(v32 / c2) + self.eps)
                    if self.weight_decay:
                        delta = delta + self.weight_decay * ps.to(
                            torch.float32)
                    ps.copy_(ps.to(torch.float32) - self.lr * delta)
                    ms.copy_(m32)
                    vs.copy_(v32)
        return params, {"m": state["m"], "v": state["v"], "step": step}


@dataclass(frozen=True)
class Adafactor:
    """Factored second moment (row/col means) — O(rows+cols) state for
    matrices, full vector state otherwise.  First moment omitted."""
    lr: float = 3e-4
    decay: float = 0.8
    eps: float = 1e-30
    clip_threshold: float = 1.0

    def init(self, params):
        def factors(p):
            if p.dim() >= 2:
                return {"r": torch.zeros(p.shape[:-1], dtype=torch.float32,
                                         device=p.device),
                        "c": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                         dtype=torch.float32,
                                         device=p.device)}
            return {"v": torch.zeros_like(p, dtype=torch.float32)}
        leaves = tree_leaves(params)
        return {"f": tree_map(factors, params),
                "step": torch.zeros((), dtype=torch.int32,
                                    device=leaves[0].device)}

    def _u(self, g, f: dict):
        """The unclipped update of one slice from its new factors."""
        g = g.to(torch.float32)
        if "v" in f:
            return g * torch.rsqrt(torch.clamp_min(f["v"], self.eps))
        r, c = f["r"], f["c"]
        denom = (r[..., None] * c[..., None, :]
                 / torch.clamp_min(r.mean(dim=-1, keepdim=True)[..., None],
                                   self.eps))
        return g * torch.rsqrt(torch.clamp_min(denom, self.eps))

    def update(self, grads, state, params):
        """Write the new parameters and factors in place; returns
        ``(params, {"f", "step"})``.  A matrix's clip norm is the mean of
        u² over its whole leaf, so a sliced leaf takes two passes: the
        factors and the sum of u², then the update from the same u."""
        step = state["step"] + 1
        beta = 1.0 - (step.to(torch.float32) + 1.0) ** (-self.decay)
        with torch.no_grad():
            for p, g, f in zip(tree_leaves(params), tree_leaves(grads),
                               _factor_leaves(params, state["f"])):
                keys = sorted(f)
                whole = 2 if "r" in f else 0
                sq = torch.zeros((), dtype=torch.float32, device=p.device)
                parts = [(gs, dict(zip(keys, fs))) for gs, *fs in
                         slices(g, *(f[k] for k in keys), whole=whole)]
                for gs, fs in parts:
                    g32 = gs.to(torch.float32)
                    g2 = g32 * g32 + self.eps
                    if "v" in fs:
                        fs["v"].copy_(beta * fs["v"] + (1 - beta) * g2)
                    else:
                        fs["r"].copy_(beta * fs["r"]
                                      + (1 - beta) * g2.mean(dim=-1))
                        fs["c"].copy_(beta * fs["c"]
                                      + (1 - beta) * g2.mean(dim=-2))
                    u = self._u(gs, fs)
                    sq = sq + (u * u).sum()
                norm = torch.sqrt(sq / max(p.numel(), 1))
                clip = torch.clamp_min(norm / self.clip_threshold, 1.0)
                for ps, (gs, fs) in zip((s[0] for s in
                                         slices(p, whole=whole)), parts):
                    u = self._u(gs, fs) / clip
                    ps.copy_(ps.to(torch.float32) - self.lr * u)
        return params, {"f": state["f"], "step": step}


def _factor_leaves(params, factors) -> list[dict]:
    """The factor dict of each parameter leaf, in :func:`tree_leaves`'
    order."""
    if isinstance(params, dict):
        return [f for k in sorted(params)
                for f in _factor_leaves(params[k], factors[k])]
    if isinstance(params, (list, tuple)):
        return [f for p, fs in zip(params, factors)
                for f in _factor_leaves(p, fs)]
    return [factors]


def make_optimizer(kind: str, lr: float, moment_dtype: str = "float32",
                   weight_decay: float = 0.0):
    if kind == "adamw":
        return AdamW(lr=lr, moment_dtype=moment_dtype,
                     weight_decay=weight_decay)
    if kind == "adafactor":
        return Adafactor(lr=lr)
    raise ValueError(kind)
