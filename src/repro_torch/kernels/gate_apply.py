"""Fused-gate application as complex products on re/im planes.

The ports of the TPU kernels of ``repro/kernels/gate_apply.py``:

* ``gemm_planes_batch`` — for every lane ``l``,
  ``Cr[l] = Ar[l] Br[l] - Ai[l] Bi[l]``, ``Ci[l] = Ar[l] Bi[l] + Ai[l] Br[l]``
  over (L, R, K) row planes A and per-lane U^T planes B (L, K, K): the
  wave path's GEMM;
* ``gemm_planes`` — the same with one (K, K) B for all rows of an (R, K)
  A: the single-group schedule's and ``ops.apply_fused_gate``'s GEMM;
* ``gemm_planes_mid`` — ``C[o] = U A[o]`` over an (O, K, I) stack, with U
  untransposed: a gate whose axes sit together but not minor-most;
* ``gemm_planes_mid_batch`` — its lane-batched form, ``C[l, o] = U[l]
  A[l, o]`` over (L, O, K, I) with per-lane U planes (L, K, K): the wave
  path's ``MidGemmOp`` (no Pallas kernel: ``repro`` runs it as an XLA
  einsum).  Lane l of an L-lane call is bit for bit the one-lane call on
  lane l's operands, for every L;
* ``diag_apply`` — (R, K) planes times a complex (1, K) diagonal.

On a CUDA tensor each launches its hand-written Hopper kernel in
``csrc/gate_apply.cu`` (see the note there for what bounds them); on a
CPU tensor it runs its plain version in :mod:`.ref`.  Any other device
raises — there is no fallback from a kernel.

:data:`launch_counts` counts each kernel's launches (CPU calls do not
count), so a run can show that its main path went through the kernels.
"""
from __future__ import annotations

import ctypes

import torch

from . import build
from .ref import (diag_apply_ref, gemm_planes_batch_ref,
                  gemm_planes_mid_batch_ref, gemm_planes_mid_ref,
                  gemm_planes_ref)

__all__ = ["gemm_planes", "gemm_planes_batch", "gemm_planes_mid",
           "gemm_planes_mid_batch", "diag_apply", "launch_counts",
           "reset_launch_counts"]

#: kernel name -> launches since the last reset
launch_counts: dict[str, int] = {"gemm_planes_batch": 0, "gemm_planes": 0,
                                 "gemm_planes_mid": 0,
                                 "gemm_planes_mid_batch": 0, "diag_apply": 0}

_MAX_K = 128
_fns = None    # C entry points by kernel name, bound at first CUDA call


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _kernels() -> dict:
    global _fns
    if _fns is None:
        p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        # B7 is the lane-batched entry's call with one lane
        mid = ("gemm_planes_mid_batch_f32",
               [p, p, i64, p, p, i64, i64, i64, p, p, i64, i64, i32, i64,
                i32, p])
        _fns = build.bind("gate_apply", {
            "gemm_planes_batch": ("gemm_planes_batch_f32",
                                  [p, p, i64, p, p, i64, i64, i64, p, p,
                                   i64, i64, i32, i32, p]),
            "gemm_planes": ("gemm_planes_f32",
                            [p, p, p, p, i64, i64, p, p, i64, i32, i32, p]),
            "gemm_planes_mid": mid,
            "gemm_planes_mid_batch": mid,
            "diag_apply": ("diag_apply_f32",
                           [p, p, p, p, p, p, i64, i64, i32, p]),
        }, "repro_cuda_error_string")
    return _fns


def _device(name: str, tensors) -> torch.device | None:
    """The operands' one device: None for the CPU, a CUDA device, or raise;
    on CUDA every operand must be float32."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"{name}: operands on {devs}")
    dev = devs.pop()
    if dev.type == "cpu":
        return None
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"{name}: the kernel takes float32 planes")
    return dev


def _check_k(name: str, K: int) -> None:
    if K < 2 or K > _MAX_K or K & (K - 1):
        raise ValueError(f"{name}: K={K} is not a power of two in "
                         f"[2, {_MAX_K}]")


def _launch(name: str, dev: torch.device, *args) -> None:
    fns = _kernels()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fns[name](*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           f"{fns['error'](rc).decode()} (cudaError {rc})")
    launch_counts[name] += 1


def _aligned(*tensors) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


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
    dev = _device("gemm_planes_batch", (ar, ai, br, bi))
    if dev is None:
        return gemm_planes_batch_ref(ar, ai, br, bi)
    _check_k("gemm_planes_batch", K)
    for t in (ar, ai):
        if t.stride(2) != 1 or (R > 1 and t.stride(1) != K):
            raise ValueError("gemm_planes_batch: A rows must be contiguous "
                             f"(strides {t.stride()})")
    if ar.stride(0) != ai.stride(0) or br.stride() != bi.stride():
        raise ValueError("gemm_planes_batch: the two planes of A (and of "
                         "B) must share their strides")
    cr = torch.empty((L, R, K), dtype=torch.float32, device=dev)
    ci = torch.empty_like(cr)
    vec4 = int(_aligned(ar, ai) and ar.stride(0) % 4 == 0)
    _launch("gemm_planes_batch", dev, ar.data_ptr(), ai.data_ptr(),
            ar.stride(0), br.data_ptr(), bi.data_ptr(), br.stride(0),
            br.stride(1), br.stride(2), cr.data_ptr(), ci.data_ptr(), L, R,
            K, vec4)
    return cr, ci


def gemm_planes(ar: torch.Tensor, ai: torch.Tensor, br: torch.Tensor,
                bi: torch.Tensor):
    """(R, K) x (K, K) complex GEMM on re/im planes, one B = U^T (any
    strides) for every row.  On CUDA, A's planes must be contiguous
    (R, K); C comes back contiguous."""
    R, K = ar.shape
    if (tuple(ai.shape) != (R, K) or tuple(br.shape) != (K, K)
            or tuple(bi.shape) != (K, K)):
        raise ValueError(f"gemm_planes: shapes {tuple(ar.shape)}, "
                         f"{tuple(ai.shape)}, {tuple(br.shape)}, "
                         f"{tuple(bi.shape)} do not form (R,K) x (K,K)")
    dev = _device("gemm_planes", (ar, ai, br, bi))
    if dev is None:
        return gemm_planes_ref(ar, ai, br, bi)
    _check_k("gemm_planes", K)
    if not (ar.is_contiguous() and ai.is_contiguous()):
        raise ValueError("gemm_planes: A planes must be contiguous (strides "
                         f"{ar.stride()}, {ai.stride()})")
    if br.stride() != bi.stride():
        raise ValueError("gemm_planes: the two planes of B must share "
                         "their strides")
    cr = torch.empty((R, K), dtype=torch.float32, device=dev)
    ci = torch.empty_like(cr)
    _launch("gemm_planes", dev, ar.data_ptr(), ai.data_ptr(), br.data_ptr(),
            bi.data_ptr(), br.stride(0), br.stride(1), cr.data_ptr(),
            ci.data_ptr(), R, K, int(_aligned(ar, ai)))
    return cr, ci


def gemm_planes_mid(ar: torch.Tensor, ai: torch.Tensor, br: torch.Tensor,
                    bi: torch.Tensor):
    """(O, K, I) batched left contraction ``C[o] = U·A[o]`` on re/im
    planes; ``br``/``bi`` are U's planes (NOT transposed; any strides).
    On CUDA, A's planes must be contiguous (O, K, I); C comes back
    contiguous.  The kernel is :func:`gemm_planes_mid_batch`'s with one
    lane."""
    O, K, I = ar.shape
    if (tuple(ai.shape) != (O, K, I) or tuple(br.shape) != (K, K)
            or tuple(bi.shape) != (K, K)):
        raise ValueError(f"gemm_planes_mid: shapes {tuple(ar.shape)}, "
                         f"{tuple(ai.shape)}, {tuple(br.shape)}, "
                         f"{tuple(bi.shape)} do not form (K,K) x (O,K,I)")
    dev = _device("gemm_planes_mid", (ar, ai, br, bi))
    if dev is None:
        return gemm_planes_mid_ref(ar, ai, br, bi)
    if not (ar.is_contiguous() and ai.is_contiguous()):
        raise ValueError("gemm_planes_mid: A planes must be contiguous "
                         f"(strides {ar.stride()}, {ai.stride()})")
    cr, ci = _mid("gemm_planes_mid", dev, ar[None], ai[None], br[None],
                  bi[None])
    return cr[0], ci[0]


def gemm_planes_mid_batch(ar: torch.Tensor, ai: torch.Tensor,
                          br: torch.Tensor, bi: torch.Tensor):
    """(L, O, K, I) lane-batched left contraction ``C[l, o] = U[l]·A[l, o]``
    on re/im planes; ``br``/``bi`` are the per-lane U planes (L, K, K),
    NOT transposed, with any strides, lane stride 0 included (one U for
    every lane).  On CUDA, each lane of A's planes must be a contiguous
    (O, K, I) stack and the two planes must share their lane stride; C
    comes back contiguous.  Lane l of the result is bit for bit the
    one-lane call on lane l's operands, whatever L."""
    L, O, K, I = ar.shape
    if (tuple(ai.shape) != (L, O, K, I) or tuple(br.shape) != (L, K, K)
            or tuple(bi.shape) != (L, K, K)):
        raise ValueError(f"gemm_planes_mid_batch: shapes "
                         f"{tuple(ar.shape)}, {tuple(ai.shape)}, "
                         f"{tuple(br.shape)}, {tuple(bi.shape)} do not "
                         "form (L,K,K) x (L,O,K,I)")
    dev = _device("gemm_planes_mid_batch", (ar, ai, br, bi))
    if dev is None:
        return gemm_planes_mid_batch_ref(ar, ai, br, bi)
    for t in (ar, ai):
        if L and not t[0].is_contiguous():
            raise ValueError("gemm_planes_mid_batch: each lane of A must "
                             f"be a contiguous stack (strides {t.stride()})")
    if L > 1 and ar.stride(0) != ai.stride(0):
        raise ValueError("gemm_planes_mid_batch: the two planes of A must "
                         "share their lane stride")
    return _mid("gemm_planes_mid_batch", dev, ar, ai, br, bi)


def _mid(name: str, dev: torch.device, ar, ai, br, bi):
    """Launch the (L, O, K, I) left contraction on checked operands."""
    L, O, K, I = ar.shape
    _check_k(name, K)
    if not 1 <= L <= 65535:
        raise ValueError(f"{name}: {L} lanes (the kernel takes 1 to 65535)")
    if br.stride() != bi.stride():
        raise ValueError(f"{name}: the two planes of U must share their "
                         "strides")
    cr = torch.empty((L, O, K, I), dtype=torch.float32, device=dev)
    ci = torch.empty_like(cr)
    a_lane = ar.stride(0) if L > 1 else 0
    vec4 = int(_aligned(ar, ai) and I % 4 == 0 and a_lane % 4 == 0)
    _launch(name, dev, ar.data_ptr(), ai.data_ptr(), a_lane, br.data_ptr(),
            bi.data_ptr(), br.stride(0) if L > 1 else 0, br.stride(1),
            br.stride(2), cr.data_ptr(), ci.data_ptr(), L, O, K, I, vec4)
    return cr, ci


def diag_apply(ar: torch.Tensor, ai: torch.Tensor, dr: torch.Tensor,
               di: torch.Tensor):
    """(R, K) re/im planes times the complex diagonal ``dr + i·di`` ((K,)
    or (1, K)), elementwise.  On CUDA, the planes and the diagonal must
    be contiguous and K a power of two; C comes back contiguous."""
    R, K = ar.shape
    if (tuple(ai.shape) != (R, K) or dr.numel() != K or di.numel() != K):
        raise ValueError(f"diag_apply: shapes {tuple(ar.shape)}, "
                         f"{tuple(ai.shape)}, {tuple(dr.shape)}, "
                         f"{tuple(di.shape)} do not form (R,K) x (1,K)")
    dev = _device("diag_apply", (ar, ai, dr, di))
    if dev is None:
        return diag_apply_ref(ar, ai, dr, di)
    if K < 1 or K & (K - 1):
        raise ValueError(f"diag_apply: K={K} is not a power of two")
    if not all(t.is_contiguous() for t in (ar, ai, dr, di)):
        raise ValueError("diag_apply: planes and diagonal must be "
                         "contiguous")
    cr = torch.empty((R, K), dtype=torch.float32, device=dev)
    ci = torch.empty_like(cr)
    vec4 = int(_aligned(ar, ai, cr, ci) and (R * K) % 4 == 0
               and (K < 4 or _aligned(dr, di)))
    _launch("diag_apply", dev, ar.data_ptr(), ai.data_ptr(), dr.data_ptr(),
            di.data_ptr(), cr.data_ptr(), ci.data_ptr(), R, K, vec4)
    return cr, ci
