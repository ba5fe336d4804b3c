"""Device selection for the port's entry points.

Entry points run on ``cuda:0`` unless the caller names a device (the
tests ask for ``torch.device("cpu")``).  Without CUDA and without an
explicit device they raise: nothing falls back to the CPU silently.
"""
from __future__ import annotations

import contextlib

import torch

__all__ = ["resolve_device", "full_f32_products", "tf32_products"]


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
    with _f32_matmul(device, tf32=False):
        yield


@contextlib.contextmanager
def tf32_products(device):
    """Run the f32 matrix products inside on the TF32 tensor cores on
    ``device``, for operands that TF32 holds: bf16 values carried in f32
    (8 bits of mantissa within TF32's 11), whose products are then exact
    with f32 sums, as a bf16 product with f32 sums; or an f32 operand
    split into a TF32 head and its remainder (split TF32, which counts as
    f32: the remainder's own rounding is 2^-11 of 2^-11).  The caller's flags come back on exit, as with
    :func:`full_f32_products`; elsewhere it does nothing."""
    with _f32_matmul(device, tf32=True):
        yield


@contextlib.contextmanager
def _f32_matmul(device, tf32: bool):
    """``allow_tf32`` (and ``fp32_precision``, "tf32" or "ieee", where
    this torch has it) set to ``tf32`` on CUDA inside, the caller's values
    restored on exit."""
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
    m.allow_tf32 = tf32
    if new_api:
        m.fp32_precision = "tf32" if tf32 else "ieee"
    try:
        yield
    finally:
        if allow is not None:
            m.allow_tf32 = allow
        if new_api and m.fp32_precision != precision:
            m.fp32_precision = precision
