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

Both go through :class:`FlashAttentionFn`, whose forward is the launch
(on the CPU, the plain version) and whose backward is
:func:`flash_attention_gqa_bwd`; with grad off, or no operand requiring
it, its output has no ``grad_fn`` and nothing is kept for a backward.
The launch writes a fresh tensor with no ``grad_fn``, so without the
Function the graph would end at the attention output and the projections
before it would get no gradient.  The TPU
kernel has no backward (``repro`` differentiates its plain XLA attention,
``repro/models/attention.py:80-113``), so the backward is torch: it
recomputes the probabilities a block of queries at a time and holds no
(S, T) matrix of the whole sequence.
"""
from __future__ import annotations

import ctypes

import torch

from ..core.devices import full_f32_products, tf32_products
from . import build
from .codec import _cuda_device
from .ref import NEG_INF, flash_attention_gqa_ref

__all__ = ["flash_attention", "flash_attention_gqa", "FlashAttentionFn",
           "flash_attention_gqa_bwd", "HEAD_DIMS", "launch_counts",
           "reset_launch_counts"]

#: head widths the kernel is built for
HEAD_DIMS = (16, 32, 64, 128, 256)
_DTYPES = (torch.float32, torch.bfloat16)

#: bytes of one f32 (rows, keys) matrix of the backward: its query block
#: holds as many rows as fit (512 at qwen3-4b's train shape, B 2, S 2,048,
#: Hq 32), so a layer's transient memory stays a few of them
BWD_BLOCK_BYTES = 1 << 28

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
    return FlashAttentionFn.apply(q.unsqueeze(2), k.unsqueeze(2),
                                  v.unsqueeze(2), causal, 0, dev)[:, :, 0]


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
    return FlashAttentionFn.apply(q, k, v, causal, window, dev)


class FlashAttentionFn(torch.autograd.Function):
    """B10 under autograd: the forward is the kernel's launch on ``dev``
    (None: the plain version on the CPU), unchanged, and saves q, k and v;
    the backward is :func:`flash_attention_gqa_bwd`.  No kernel runs in
    the backward, and nothing falls back: a failed launch raises in the
    forward."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int, dev):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window = causal, window
        if dev is None:
            return flash_attention_gqa_ref(q, k, v, causal, window)
        return _launch(q, k, v, causal, window, dev)

    @staticmethod
    def backward(ctx, dout):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = flash_attention_gqa_bwd(q, k, v, dout,
                                             causal=ctx.causal,
                                             window=ctx.window)
        return dq, dk, dv, None, None, None


def _split_tf32(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """f32 ``x`` as head + remainder: the head x rounded to TF32's 10
    mantissa bits (half away from zero on the int32 view), the remainder x
    - head exactly (split TF32: a product with a TF32-exact operand is
    then two TF32 products within 2^-22 of f32's)."""
    head = (x.view(torch.int32) + 0x1000).bitwise_and_(~0x1FFF) \
        .view(torch.float32)
    return head, x - head


def _f32(x: torch.Tensor) -> torch.Tensor:
    """A contiguous f32 copy of ``x`` (one copy whatever its dtype)."""
    return x.to(torch.float32, memory_format=torch.contiguous_format) \
        .contiguous()


def flash_attention_gqa_bwd(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, dout: torch.Tensor, *,
                            causal: bool = True, window: int = 0
                            ) -> tuple[torch.Tensor, ...]:
    """Gradients (dq, dk, dv) of :func:`flash_attention_gqa` at q (B, S,
    Hq, hd), k/v (B, T, G, hd) for the output gradient ``dout`` (B, S, Hq,
    hd), each in its operand's dtype.

    A block of queries at a time (:data:`BWD_BLOCK_BYTES` of f32 scores,
    the keys the masks leave it: at most its last row's under ``causal``,
    from its first row's window on), with the rep query heads of a kv head
    as rows of one product, so dK and dV sum them in it:

      S  = q k^T / sqrt(hd), masked as the forward (j <= i under
           ``causal``, i - j < ``window``; keys at or past T are never
           read), P = softmax(S) in f32;
      dV = P^T dO;   dP = dO V^T;
      dS = P * (dP - rowsum(P * dP)) / sqrt(hd);
      dQ = dS K;     dK = dS^T Q.

    rowsum(P * dP) is rowsum(dO * O) for the unrounded output; it is
    taken in that form because it is ``jax.grad``'s transpose of the
    softmax in ``repro``'s attention core.  For bf16 operands the
    arithmetic rounds where ``jax.grad`` of that core rounds: P to bf16
    for dV (the forward's P·V takes bf16 probabilities), dP to bf16 (the
    transpose of that bf16 product gives a bf16 dP), and dQ, dK, dV to
    bf16 once, after their f32 sums; S, P and dS stay f32.  Its products
    are bf16 products with f32 sums (bf16 values in f32 on the TF32 tensor
    cores, exact), and those with the f32 dS split TF32
    (:func:`_split_tf32`), which counts as f32.  For f32 operands every
    product is full f32 (never plain TF32).  On the CPU both are f32
    products."""
    B, S, Hq, hd = q.shape
    T, G = k.shape[1], k.shape[2]
    if dout.shape != q.shape:
        raise ValueError(f"flash_attention_gqa_bwd: dout of shape "
                         f"{tuple(dout.shape)}, want {tuple(q.shape)}")
    rep = Hq // G
    scale = hd ** -0.5
    bf16 = q.dtype == torch.bfloat16
    products = (tf32_products if bf16 else full_f32_products)(q.device)
    # (B, G, rep, S, hd) views: the rep heads of kv head g are h = g·rep + r
    qh = q.reshape(B, S, G, rep, hd).permute(0, 2, 3, 1, 4)
    dh = dout.reshape(B, S, G, rep, hd).permute(0, 2, 3, 1, 4)
    kh = k.permute(0, 2, 1, 3)                               # (B, G, T, hd)
    vh = v.permute(0, 2, 1, 3)
    dq = torch.empty((B, S, G, rep, hd), dtype=q.dtype, device=q.device)
    dk = torch.zeros((B, G, T, hd), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    rows = max(1, BWD_BLOCK_BYTES // (4 * B * Hq * T))
    with products:
        for s0 in range(0, S, rows):
            s1 = min(S, s0 + rows)
            lo = max(0, s0 - window + 1) if window else 0
            hi = min(T, s1) if causal else T
            n = s1 - s0
            qb = _f32(qh[:, :, :, s0:s1]).view(B, G, rep * n, hd)
            db = _f32(dh[:, :, :, s0:s1]).view(B, G, rep * n, hd)
            kb = _f32(kh[:, :, lo:hi])
            vb = _f32(vh[:, :, lo:hi])
            s = (qb @ kb.transpose(-1, -2)).mul_(scale)
            if causal or window:
                d = (torch.arange(s0, s1, device=q.device)[:, None]
                     - torch.arange(lo, hi, device=q.device)[None, :])
                drop = d < 0 if causal else torch.zeros_like(d, dtype=bool)
                if window:
                    drop = drop | (d >= window)
                s.view(B, G, rep, n, hi - lo).masked_fill_(drop, NEG_INF)
            p = torch.softmax(s, dim=-1)
            del s
            pv = p.to(torch.bfloat16).float() if bf16 else p
            dv[:, :, lo:hi] += pv.transpose(-1, -2) @ db
            del pv
            dp = db @ vb.transpose(-1, -2)
            if bf16:
                dp = dp.to(torch.bfloat16).float()
            # dS = P * (dP - rowsum(P * dP)) * scale, in dp's storage
            dp.sub_((p * dp).sum(dim=-1, keepdim=True)).mul_(p).mul_(scale)
            ds = dp
            del p, dp
            if bf16:
                head, rest = _split_tf32(ds)
                dqb = head @ kb + rest @ kb
                dk[:, :, lo:hi] += (head.transpose(-1, -2) @ qb
                                    + rest.transpose(-1, -2) @ qb)
                del head, rest
            else:
                dqb = ds @ kb
                dk[:, :, lo:hi] += ds.transpose(-1, -2) @ qb
            del ds
            dq[:, s0:s1] = dqb.view(B, G, rep, n, hd).permute(
                0, 3, 1, 2, 4).to(q.dtype)
    return (dq.view(B, S, Hq, hd),
            dk.permute(0, 2, 1, 3).to(k.dtype),
            dv.permute(0, 2, 1, 3).to(v.dtype))
