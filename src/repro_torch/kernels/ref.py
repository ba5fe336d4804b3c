"""Plain PyTorch versions of the hand-written kernels.

Each function computes exactly what its kernel computes, with torch ops
on whatever device its inputs live on.  The kernel wrappers run these for
CPU tensors (the test suite's path), and ``chip_smoke.py`` holds every
kernel against its plain version on the card.
"""
from __future__ import annotations

import torch

__all__ = ["gemm_planes_batch_ref"]


def gemm_planes_batch_ref(ar: torch.Tensor, ai: torch.Tensor,
                          br: torch.Tensor, bi: torch.Tensor):
    """(L, R, K) x (L, K, K) lane-batched complex GEMM on re/im planes:
    ``Cr = Ar·Br − Ai·Bi``, ``Ci = Ar·Bi + Ai·Br`` (four real products)."""
    cr = ar @ br - ai @ bi
    ci = ar @ bi + ai @ br
    return cr.to(torch.float32), ci.to(torch.float32)
