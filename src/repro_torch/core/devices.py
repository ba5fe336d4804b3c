"""Device selection for the port's entry points.

Entry points run on ``cuda:0`` unless the caller names a device (the
tests ask for ``torch.device("cpu")``).  Without CUDA and without an
explicit device they raise: nothing falls back to the CPU silently.
"""
from __future__ import annotations

import contextlib

import torch

__all__ = ["resolve_device", "full_f32_products"]


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


@contextlib.contextmanager
def full_f32_products(device):
    """Run the f32 matrix products inside in full f32 on ``device``.

    On CUDA, cuBLAS follows process-global flags: a caller who ran
    ``torch.set_float32_matmul_precision("high")`` or set
    ``torch.backends.cuda.matmul.allow_tf32`` would get plain TF32
    (about three decimal digits), which misses the port's f32 bounds.
    Inside this context ``allow_tf32`` is False (and ``fp32_precision``
    "ieee" where this torch has that attribute); on exit the caller's
    values come back, exceptions included.  Elsewhere it does nothing.

    The products it guards — the stage compute with ``use_kernel=False``
    and the dense oracle's (``dense_engine.apply_matrix``, which the
    per-gate ``_apply_fused`` path also runs) — run on the thread that
    called ``Simulator.run`` / ``run_batch`` / ``simulate_dense``.  The
    flags are not per thread, so a product of the caller's own that runs
    on another thread while this context is open runs in full f32 too,
    and one of ours may see the caller's flags if that thread sets them
    meanwhile (ROADMAP queue C).
    """
    if torch.device(device).type != "cuda":
        yield
        return
    m = torch.backends.cuda.matmul
    new_api = hasattr(m, "fp32_precision")
    precision = m.fp32_precision if new_api else None
    try:
        allow = m.allow_tf32
    except RuntimeError:    # the caller mixed the legacy and new APIs
        allow = None
    m.allow_tf32 = False
    if new_api:
        m.fp32_precision = "ieee"
    try:
        yield
    finally:
        if allow is not None:
            m.allow_tf32 = allow
        if new_api and m.fp32_precision != precision:
            m.fp32_precision = precision
