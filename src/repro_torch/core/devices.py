"""Device selection for the port's entry points.

Entry points run on ``cuda:0`` unless the caller names a device (the
tests ask for ``torch.device("cpu")``).  Without CUDA and without an
explicit device they raise: nothing falls back to the CPU silently.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``device`` as a :class:`torch.device`; ``None`` means ``cuda:0``,
    which must exist."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on CUDA by default and no CUDA device is "
            "available; ask for the CPU explicitly (e.g. "
            "EngineConfig(devices=[torch.device('cpu')]))")
    return torch.device("cuda", 0)
