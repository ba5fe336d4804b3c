"""Fidelity and error metrics (paper §5.3)."""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["fidelity", "norm", "max_pointwise_rel_error"]


def _flat(x, device=None) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        a = np.ascontiguousarray(x)
        x = torch.from_numpy(a if a.flags.writeable else a.copy())
    return x.reshape(-1).to(device=device)


def fidelity(ideal, sim) -> float:
    """|<ideal|sim>| — the paper's metric (Fig. 8), summed in float64 on
    ``ideal``'s device."""
    ideal = _flat(ideal)
    sim = _flat(sim, ideal.device)
    return float(torch.abs(torch.vdot(ideal.to(torch.complex128),
                                      sim.to(torch.complex128))))


def norm(state) -> float:
    s = _flat(state)
    return float(torch.sqrt(torch.sum(torch.abs(s.to(torch.complex128)) ** 2)))


def max_pointwise_rel_error(x, xhat, zero_floor: float = 0.0) -> float:
    """max |xhat - x| / |x| over elements with |x| > zero_floor."""
    x = np.asarray(x, dtype=np.float64).reshape(-1)
    xhat = np.asarray(xhat, dtype=np.float64).reshape(-1)
    mask = np.abs(x) > zero_floor
    if not mask.any():
        return 0.0
    return float(np.max(np.abs(xhat[mask] - x[mask]) / np.abs(x[mask])))
