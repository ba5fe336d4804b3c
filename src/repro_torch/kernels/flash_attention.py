"""Blockwise online-softmax (flash) attention, causal or full, with an
optional sliding window.

The port of the TPU kernel ``repro/kernels/flash_attention.py::
flash_attention``:

* ``flash_attention(q, k, v, causal=True)`` — the TPU signature, q/k/v
  (BH, S, hd) -> (BH, S, hd);
* ``flash_attention_gqa(q, k, v, causal=True, window=0)`` — the same
  kernel in the model's layout, q (B, S, Hq, hd) and k/v (B, T, G, hd) ->
  (B, S, Hq, hd), query head h reading kv head h // (Hq / G): the attention
  core of ``models.attention.attention_full`` (T = S) and of
  ``attention_cross``'s prefill (T keys of the image or encoder source, T
  != S, unmasked; ``causal`` or a window with T != S raises).

``window`` W > 0 also masks i - j >= W, the sliding window of gemma3's
local layers that ``repro`` applies in XLA around its own attention
(``repro/models/attention.py:110-112``; the Pallas kernel has none); the
kernel skips the K tiles wholly outside every row's window.

Both take float32 or bfloat16 (q, k and v alike) and return q's dtype;
the sums are f32, and for bf16 inputs the probabilities are rounded to
bf16 before P·V, as ``repro.models.attention._gqa_out`` rounds them.  On
a CUDA tensor they launch the hand-written Hopper kernel in
``csrc/attention.cu`` (see the note there for what bounds it) through
strides, with no copy of q, k or v; on a CPU tensor they run the plain
versions in :mod:`.ref`.  Any other device raises — there is no
fallback from the kernel.  :data:`launch_counts` counts CUDA launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import build
from .codec import _cuda_device
from .ref import flash_attention_gqa_ref, flash_attention_ref

__all__ = ["flash_attention", "flash_attention_gqa", "HEAD_DIMS",
           "launch_counts", "reset_launch_counts"]

#: head widths the kernel is built for
HEAD_DIMS = (16, 32, 64, 128, 256)
_DTYPES = (torch.float32, torch.bfloat16)

#: kernel name -> launches since the last reset
launch_counts: dict[str, int] = {"flash_attention": 0}

_fns = None    # C entry points, bound at first CUDA call


def reset_launch_counts() -> None:
    launch_counts["flash_attention"] = 0


def _kernels() -> dict:
    global _fns
    if _fns is None:
        p, i32 = ctypes.c_void_p, ctypes.c_int
        st = ctypes.POINTER(ctypes.c_longlong)
        _fns = build.bind("attention", {
            "flash_attention": ("flash_attention_fwd",
                                [p, st, p, st, p, st, p, st, i32, i32, i32,
                                 i32, i32, i32, i32, i32, i32, p]),
        }, "attention_cuda_error_string")
    return _fns


def _strides(t: torch.Tensor):
    """(batch, sequence, head) element strides of a 4-D operand."""
    return (ctypes.c_longlong * 3)(t.stride(0), t.stride(1), t.stride(2))


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            causal: bool, window: int, dev: torch.device) -> torch.Tensor:
    """q (B, S, Hq, hd), k/v (B, T, G, hd) on ``dev`` -> (B, S, Hq, hd)."""
    B, S, Hq, hd = q.shape
    T, G = k.shape[1], k.shape[2]
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: hd={hd} not in {HEAD_DIMS}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: q/k/v must share float32 or "
                        f"bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention: the head axis of q/k/v must be "
                         "contiguous")
    out = torch.empty((B, S, Hq, hd), dtype=q.dtype, device=dev)
    fns = _kernels()
    with torch.cuda.device(dev):
        rc = fns["flash_attention"](
            q.data_ptr(), _strides(q), k.data_ptr(), _strides(k),
            v.data_ptr(), _strides(v), out.data_ptr(), _strides(out), B, S,
            T, Hq, G, hd, int(causal), window,
            int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"{fns['error'](rc).decode()} (cudaError {rc})")
    launch_counts["flash_attention"] += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q/k/v (BH, S, hd) -> (BH, S, hd): ``softmax(q k^T / sqrt(hd)) v``,
    masked to j <= i when ``causal``."""
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"flash_attention: shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)} are not three "
                         "equal (BH, S, hd)")
    dev = _cuda_device((q, k, v), "flash_attention")
    if dev is None:
        return flash_attention_ref(q, k, v, causal).to(q.dtype)
    return _launch(q.unsqueeze(2), k.unsqueeze(2), v.unsqueeze(2), causal,
                   0, dev)[:, :, 0]


def flash_attention_gqa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0
                        ) -> torch.Tensor:
    """q (B, S, Hq, hd), k/v (B, T, G, hd) -> (B, S, Hq, hd) in q's dtype,
    query head h attending with kv head h // (Hq / G); ``window`` > 0
    masks the keys ``window`` or more below the query (i - j >= W).  T !=
    S (cross-attention) attends to every key: ``causal`` and ``window``
    need T == S."""
    if isinstance(window, bool) or int(window) != window or window < 0:
        raise ValueError(f"flash_attention_gqa: window must be an int >= 0, "
                         f"got {window!r}")
    window = int(window)
    if (q.dim() != 4 or k.dim() != 4 or k.shape != v.shape
            or k.shape[0] != q.shape[0] or k.shape[1] < 1
            or k.shape[3] != q.shape[3] or q.shape[2] % k.shape[2]):
        raise ValueError(f"flash_attention_gqa: shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)} do not form "
                         "(B, S, Hq, hd) x (B, T, G, hd) with G | Hq")
    if k.shape[1] != q.shape[1] and (causal or window):
        raise ValueError(f"flash_attention_gqa: {q.shape[1]} queries over "
                         f"{k.shape[1]} keys: causal and window masks need "
                         "as many keys as queries")
    dev = _cuda_device((q, k, v), "flash_attention_gqa")
    if dev is None:
        return flash_attention_gqa_ref(q, k, v, causal, window)
    return _launch(q, k, v, causal, window, dev)
