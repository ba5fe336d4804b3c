"""Fused-gate application as a lane-batched complex GEMM on re/im planes.

``gemm_planes_batch`` is the port of the TPU kernel
``repro/kernels/gate_apply.py::gemm_planes_batch``: for every lane ``l``,

    Cr[l] = Ar[l] Br[l] - Ai[l] Bi[l],   Ci[l] = Ar[l] Bi[l] + Ai[l] Br[l]

over (L, R, K) row planes A and per-lane U^T planes B (L, K, K).  On a
CUDA tensor it launches the hand-written Hopper kernel in
``csrc/gate_apply.cu`` (see the note there for what bounds it); on a CPU
tensor it runs the plain version :func:`~repro_torch.kernels.ref.gemm_planes_batch_ref`.
Any other device raises — there is no fallback from the kernel.

:data:`launch_counts` counts the kernel's launches (CPU calls do not
count), so a run can show that its main path went through the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from . import build
from .ref import gemm_planes_batch_ref

__all__ = ["gemm_planes_batch", "launch_counts", "reset_launch_counts"]

#: kernel name -> launches since the last reset
launch_counts: dict[str, int] = {"gemm_planes_batch": 0}

_MAX_K = 128
_fn = None     # the C entry point, bound at first CUDA call
_err = None    # its cudaGetErrorString


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _kernel():
    global _fn, _err
    if _fn is None:
        lib = build.load("gate_apply")
        fn = lib.gemm_planes_batch_f32
        p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fn.argtypes = [p, p, i64, p, p, i64, i64, i64, p, p, i64, i64,
                       i32, i32, p]
        fn.restype = i32
        err = lib.repro_cuda_error_string
        err.argtypes = [i32]
        err.restype = ctypes.c_char_p
        _err = err
        _fn = fn
    return _fn


def gemm_planes_batch(ar: torch.Tensor, ai: torch.Tensor,
                      br: torch.Tensor, bi: torch.Tensor):
    """(L, R, K) x (L, K, K) lane-batched complex GEMM on re/im planes.

    ``br``/``bi`` are the per-lane U^T planes and may come with any
    strides, lane stride 0 included (one U broadcast over a wave).  On
    CUDA, A's planes must have contiguous (R, K) rows and share one lane
    stride; C comes back contiguous.
    """
    L, R, K = ar.shape
    if (tuple(ai.shape) != (L, R, K) or tuple(br.shape) != (L, K, K)
            or tuple(bi.shape) != (L, K, K)):
        raise ValueError(f"gemm_planes_batch: shapes {tuple(ar.shape)}, "
                         f"{tuple(ai.shape)}, {tuple(br.shape)}, "
                         f"{tuple(bi.shape)} do not form (L,R,K) x (L,K,K)")
    devs = {t.device for t in (ar, ai, br, bi)}
    if len(devs) != 1:
        raise ValueError(f"gemm_planes_batch: operands on {devs}")
    dev = ar.device
    if dev.type == "cpu":
        return gemm_planes_batch_ref(ar, ai, br, bi)
    if dev.type != "cuda":
        raise ValueError(f"gemm_planes_batch: no kernel for device {dev}")
    if any(t.dtype != torch.float32 for t in (ar, ai, br, bi)):
        raise TypeError("gemm_planes_batch: the kernel takes float32 planes")
    if K < 2 or K > _MAX_K or K & (K - 1):
        raise ValueError(f"gemm_planes_batch: K={K} is not a power of two "
                         f"in [2, {_MAX_K}]")
    for t in (ar, ai):
        if t.stride(2) != 1 or (R > 1 and t.stride(1) != K):
            raise ValueError("gemm_planes_batch: A rows must be contiguous "
                             f"(strides {t.stride()})")
    if ar.stride(0) != ai.stride(0) or br.stride() != bi.stride():
        raise ValueError("gemm_planes_batch: the two planes of A (and of "
                         "B) must share their strides")
    fn = _kernel()
    cr = torch.empty((L, R, K), dtype=torch.float32, device=dev)
    ci = torch.empty_like(cr)
    vec4 = int(all(t.data_ptr() % 16 == 0 for t in (ar, ai))
               and ar.stride(0) % 4 == 0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(ar.data_ptr(), ai.data_ptr(), ar.stride(0),
                br.data_ptr(), bi.data_ptr(), br.stride(0), br.stride(1),
                br.stride(2), cr.data_ptr(), ci.data_ptr(), L, R, K, vec4,
                stream)
    if rc != 0:
        raise RuntimeError(f"gemm_planes_batch kernel launch failed: "
                           f"{_err(rc).decode()} (cudaError {rc})")
    launch_counts["gemm_planes_batch"] += 1
    return cr, ci
