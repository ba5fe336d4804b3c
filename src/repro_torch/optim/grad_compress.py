"""Error-bounded gradient compression with error feedback (beyond-paper).

The port of ``repro/optim/grad_compress.py``: gradients are
pwrel-quantized to 16-bit codes and dequantized (the transformation that
would bracket a data-parallel all-reduce), with the per-element residual
carried into the next step.  Plain torch, as ``repro``'s is XLA and no
Pallas kernel.  ``roundtrip`` writes the dequantized gradient into the
gradient tensor and the new residual into the residual tensor in place, a
slice of the leading axis at a time (``optim.adamw.slices``) after one
pass for each leaf's max, so its f32 temporaries are one slice's.  The
codes are the pwrel tolerance's (ROADMAP): ``torch.log2`` is not XLA's,
so a code may differ from ``repro``'s by one at a rounding tie.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..compression.pwrel import CODE_MAX, log_step
from .adamw import slices, tree_leaves, tree_map

__all__ = ["GradCompressor"]

_TINY = 1e-45                  # repro's floor before log2 (f32: 2^-149)


@dataclass(frozen=True)
class GradCompressor:
    b_r: float = 1e-2          # grads tolerate a looser bound than SV amps

    @property
    def bytes_ratio(self) -> float:
        """f32 bytes / compressed bytes (codes u16 + sign bit)."""
        return 32.0 / (16.0 + 1.0)

    def init(self, params):
        return tree_map(lambda p: torch.zeros_like(
            p, dtype=torch.float32, memory_format=torch.contiguous_format),
            params)

    def roundtrip(self, grads, err_state, reduce_max=None):
        """(grads, residuals) -> (decompressed grads, new residuals), both
        written into the given tensors.  ``reduce_max`` takes the (n,)
        tensor of the leaves' max|g + e| and returns it maxed over the
        leaves' shards (a sharded step's all-reduce), so every code is the
        one a device holding the whole leaf would write."""
        step = log_step(self.b_r)
        with torch.no_grad():
            pairs = list(zip(tree_leaves(grads), tree_leaves(err_state)))
            maxima = []
            for g, e in pairs:
                max_abs = torch.zeros((), dtype=torch.float32,
                                      device=g.device)
                for gs, es in slices(g, e):
                    max_abs = torch.maximum(
                        max_abs, (gs.to(torch.float32) + es).abs().max())
                maxima.append(max_abs)
            if reduce_max is not None and maxima:
                maxima = list(reduce_max(torch.stack(maxima)).unbind(0))
            for (g, e), max_abs in zip(pairs, maxima):
                l_max = torch.where(
                    max_abs > 0, torch.log2(torch.clamp_min(max_abs, _TINY)),
                    torch.zeros_like(max_abs))
                for gs, es in slices(g, e):
                    g32 = gs.to(torch.float32) + es
                    L = torch.log2(torch.clamp_min(g32.abs(), _TINY))
                    d = torch.round((l_max - L) / step)
                    codes = torch.clamp(CODE_MAX - d, 0.0, float(CODE_MAX))
                    mag = torch.exp2(l_max - (CODE_MAX - codes) * step)
                    q = torch.where(codes < 0.5, torch.zeros_like(mag),
                                    torch.sign(g32) * mag)
                    gs.copy_(q)
                    es.copy_(g32 - q)
        return grads, err_state
