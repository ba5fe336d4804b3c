"""One decode step's attention reading a pwrel-compressed KV cache.

The port of the TPU kernel ``repro/kernels/kv_dequant_attention.py::
kv_dequant_decode_attention``: the cache holds uint8 log-codes (0 = exact
zero), LSB-first packed sign bytes and a per-(token, head) f32 log2
scale; the kernel dequantizes in registers as ``|x| = exp2(scale -
(255 - c)·KV_STEP)`` and attends with the causal length mask j <= pos.

* ``kv_dequant_decode_attention(q, codes_k, signs_k, scale_k, codes_v,
  signs_v, scale_v, pos)`` — the TPU signature: q (BG, rep, hd); codes
  (BG, T, hd) u8; signs (BG, T, hd/8) u8; scale (BG, T, 1) f32 ->
  (BG, rep, hd) f32;
* ``kv_dequant_decode_attention_gqa(...)`` — the same kernel in the serving
  layout: q (B, 1, Hq, hd); one layer's cache leaves (B, T, G, hd),
  (B, T, G, hd/8), (B, T, G, 1), typically views of the stacked
  (U, B, T, G, ·) cache, read in place -> (B, 1, Hq, hd) f32: the attention
  core of ``serving.kvcache.compressed_attention_decode``.

``pos`` is a 0-d int32 tensor on q's device (a host int >= 0 is taken
too, and filled into one): the kernel reads it from device memory, and its
grid follows the cache length T alone, so one launch serves every step of
a captured decode (``serving.step.CapturedDecodeStep``).  Nothing here
reads pos's value on the host.  q may be float32 or bfloat16; for
a bfloat16 q the dequantized K/V and the probabilities are rounded to
bfloat16 before their products (sums in f32), as ``repro``'s serving
decode rounds them (the kernel rounds the unnormalised probabilities,
relative to a block's running max, its plain version the normalised ones;
see ``csrc/attention.cu``).  ``kv_dtype=torch.bfloat16`` rounds them so for
a float32 q too (the kernel's ``KV_BF16`` build): ``repro``'s serving decode
dequantizes the cache to bfloat16 whatever the model's dtype.  That build
rounds the normalised probabilities, as ``repro`` and the plain version do,
in two passes over K (the row's max and sum first).  The default,
``None``, keeps a float32 q's products in float32 throughout, the Pallas
kernel's semantics.  On
a CUDA tensor both launch the hand-written Hopper kernel in
``csrc/attention.cu`` (see the note there for what bounds it); on a CPU
tensor they run the plain versions in :mod:`.ref`.  Any other device
raises — there is no fallback from the kernel.  :data:`launch_counts`
counts CUDA launches (one per call).

A local (sliding-window) layer needs no window here: its cache holds
min(max_len, W) slots (``models.transformer.init_decode_cache``), so either
it is a ring (T == W, every slot in the window once pos >= T, which live =
min(T, pos + 1) already says) or it is shorter than W, where pos - j < W
never binds.  The ``window`` argument only checks that (a windowed cache
longer than W raises).
"""
from __future__ import annotations

import ctypes

import torch

from . import build
from .codec import _cuda_device
from .flash_attention import HEAD_DIMS
from .ref import (KV_RANGE, KV_STEP, kv_dequant_decode_attention_gqa_ref,
                  kv_dequant_decode_attention_ref)

__all__ = ["kv_dequant_decode_attention", "kv_dequant_decode_attention_gqa",
           "KV_RANGE", "KV_STEP", "splits", "kernel_span", "grid_splits",
           "grid", "launch_counts", "reset_launch_counts"]

#: kernel name -> launches since the last reset
launch_counts: dict[str, int] = {"kv_dequant_decode_attention": 0}

_fns = None    # C entry points, bound at first CUDA call
#: (id of the entry point, device, hd, bf16 q, bf16 K/V) -> (blocks the
#: card runs at once, tokens a tile, query rows a block), from the library
_grids: dict = {}


def reset_launch_counts() -> None:
    launch_counts["kv_dequant_decode_attention"] = 0


def _kernels() -> dict:
    global _fns
    if _fns is None:
        p, i32 = ctypes.c_void_p, ctypes.c_int
        st = ctypes.POINTER(ctypes.c_longlong)
        _fns = build.bind("attention", {
            "kv_dequant_decode_attention": (
                "kv_dequant_decode_attention_fwd",
                [p, st] + [p, st] * 6 + [p, p, p] + [i32] * 4 + [p]
                + [i32] * 5 + [p]),
            "slots": ("kv_dequant_decode_attention_slots",
                      [i32, i32, i32, ctypes.POINTER(i32),
                       ctypes.POINTER(i32)]),
        }, "attention_cuda_error_string")
    return _fns


def splits(blocks: int, live: int, slots: int, tile: int
           ) -> tuple[int, int]:
    """``(n_split, span)`` of the kernel's grid: the ``live`` cached tokens
    in ``n_split`` spans of ``span`` tokens (whole tiles of ``tile``; the
    last span shorter), one block each for every one of the ``blocks`` (b,
    g, row block) triples, as many spans as let the grid fit in the
    ``slots`` blocks the card runs at once (at least one, at most one a
    tile)."""
    n = max(1, min(slots // blocks, -(-live // tile)))
    span = -(-(-(-live // n)) // tile) * tile
    return -(-live // span), span


def kernel_span(split: int, live: int, max_split: int, tile: int
                ) -> tuple[int, int]:
    """``[s0, s1)`` of grid split ``split`` as the kernel finds it from
    ``pos`` (``live = min(T, pos + 1)``): :func:`splits`' spans with at most
    ``max_split`` of them (``slots // blocks``); empty (s1 = s0) for a split
    past the last span, which writes a neutral partial."""
    n = max(1, min(max_split, -(-live // tile)))
    span = -(-(-(-live // n)) // tile) * tile
    s0 = split * span
    return s0, max(s0, min(live, s0 + span))


def grid_splits(blocks: int, T: int, slots: int, tile: int) -> int:
    """Splits of the launch grid for a cache of ``T`` tokens, whatever pos:
    :func:`splits`' n at live = T.  (n_split itself is not monotone in live:
    (64, 640, 264, 128) gives 3 spans of 256, live 512 four of 128; n is.)"""
    return max(1, min(slots // blocks, -(-T // tile)))


def _grid_of(fns: dict, dev: torch.device, hd: int, bf16: int, kv_bf16: int
             ) -> tuple[int, int, int]:
    key = (id(fns["slots"]), dev.index, hd, bf16, kv_bf16)
    if key not in _grids:
        tile, rows = ctypes.c_int(), ctypes.c_int()
        with torch.cuda.device(dev):
            n = fns["slots"](hd, bf16, kv_bf16, ctypes.byref(tile),
                             ctypes.byref(rows))
        if n <= 0:
            raise RuntimeError(f"kv_dequant_decode_attention: occupancy query "
                               f"failed: {fns['error'](-n).decode()}")
        _grids[key] = (n, tile.value, rows.value)
    return _grids[key]


def _kv_bf16(q_dtype: torch.dtype, kv_dtype) -> int:
    """1 where the kernel rounds K/V and p to bf16 (a bf16 q, or
    ``kv_dtype=torch.bfloat16``), else 0."""
    if kv_dtype not in (None, torch.bfloat16):
        raise ValueError(f"kv_dequant_decode_attention: kv_dtype must be None "
                         f"or torch.bfloat16, got {kv_dtype}")
    return int(q_dtype == torch.bfloat16 or kv_dtype == torch.bfloat16)


def _blocks_slots_tile(heads: int, rep: int, hd: int, q_dtype: torch.dtype,
                       dev: torch.device, kv_dtype=None
                       ) -> tuple[int, int, int]:
    slots, tile, rows = _grid_of(_kernels(), dev, hd,
                                 int(q_dtype == torch.bfloat16),
                                 _kv_bf16(q_dtype, kv_dtype))
    return heads * -(-rep // rows), slots, tile


def grid(heads: int, rep: int, hd: int, live: int, q_dtype: torch.dtype,
         dev: torch.device, kv_dtype=None) -> tuple[int, int, int]:
    """``(n_split, span, tile)`` the kernel takes on CUDA device ``dev``
    for ``heads`` (batch, kv head) pairs of ``rep`` query rows of ``hd``
    dims in ``q_dtype`` (K/V rounded to ``kv_dtype``) over ``live`` cached
    tokens: the spans of :func:`splits` it finds from pos and the tokens a
    tile, both as the built kernel takes them."""
    blocks, slots, tile = _blocks_slots_tile(heads, rep, hd, q_dtype, dev,
                                             kv_dtype)
    return splits(blocks, live, slots, tile) + (tile,)


def _strides(t: torch.Tensor):
    """(batch, head, sequence) element strides of a 4-D operand."""
    return (ctypes.c_longlong * 3)(t.stride(0), t.stride(1), t.stride(2))


def _launch(q: torch.Tensor, cache: tuple, pos: torch.Tensor,
            dev: torch.device, grid_live: int | None = None, kv_dtype=None
            ) -> torch.Tensor:
    """q (B, G, rep, hd); cache leaves (B, G, T, ·) -> (B, G, rep, hd) f32;
    ``kv_dtype`` as :func:`kv_dequant_decode_attention` takes it.

    The grid is :func:`grid_splits` of T, or (``grid_live``, a host int
    that must equal min(T, pos + 1)) :func:`splits`' n_split at that live,
    the grid a host-int pos gave before pos moved to device memory: for a
    comparison of the two on the card."""
    B, G, rep, hd = q.shape
    T = cache[0].shape[2]
    if hd not in HEAD_DIMS:
        raise ValueError(f"kv_dequant_decode_attention: hd={hd} not in "
                         f"{HEAD_DIMS}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"kv_dequant_decode_attention: q is {q.dtype}")
    for t, dt in zip(cache, (torch.uint8, torch.uint8, torch.float32) * 2):
        if t.dtype != dt or t.stride(3) != 1:
            raise ValueError(f"kv_dequant_decode_attention: want {dt} cache "
                             f"leaves with a contiguous last axis, got "
                             f"{t.dtype} with strides {t.stride()}")
    for leaf, align in zip(cache, (16, 2, 1, 16, 2, 1)):
        if leaf.data_ptr() % align or any(s % align
                                          for s in leaf.stride()[:3]):
            raise ValueError(f"kv_dequant_decode_attention: the kernel reads "
                             f"{leaf.dtype} rows {align}-byte aligned, got "
                             f"strides {leaf.stride()}")
    if q.stride(3) != 1:
        raise ValueError("kv_dequant_decode_attention: q's head axis must "
                         "be contiguous")
    kv_bf16 = _kv_bf16(q.dtype, kv_dtype)
    blocks, slots, tile = _blocks_slots_tile(B * G, rep, hd, q.dtype, dev,
                                             kv_dtype)
    n_split = (grid_splits(blocks, T, slots, tile) if grid_live is None
               else splits(blocks, grid_live, slots, tile)[0])
    fns = _kernels()
    out = torch.empty((B, G, rep, hd), dtype=torch.float32, device=dev)
    part_acc = part_ml = None
    if n_split > 1:
        part_acc = torch.empty((B * G, n_split, rep, hd), dtype=torch.float32,
                               device=dev)
    # the KV_BF16 build of an f32 q keeps every split's (max, sum) for its
    # second pass, whatever n_split
    if n_split > 1 or (kv_bf16 and q.dtype == torch.float32):
        part_ml = torch.empty((B * G, n_split, rep, 2), dtype=torch.float32,
                              device=dev)
    args = []
    for t in cache:
        args += [t.data_ptr(), _strides(t)]
    with torch.cuda.device(dev):
        rc = fns["kv_dequant_decode_attention"](
            q.data_ptr(), _strides(q), *args, out.data_ptr(),
            None if part_acc is None else part_acc.data_ptr(),
            None if part_ml is None else part_ml.data_ptr(), B, G, rep, hd,
            pos.data_ptr(), T, n_split, max(1, slots // blocks),
            int(q.dtype == torch.bfloat16), kv_bf16,
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"kv_dequant_decode_attention kernel launch "
                           f"failed: {fns['error'](rc).decode()} "
                           f"(cudaError {rc})")
    launch_counts["kv_dequant_decode_attention"] += 1
    return out


def _check_pos(pos, q: torch.Tensor) -> torch.Tensor:
    """``pos`` as a 0-d int32 tensor on q's device (its value unread)."""
    if isinstance(pos, torch.Tensor):
        if pos.dim() != 0 or pos.dtype != torch.int32 or \
                pos.device != q.device:
            raise ValueError(f"kv_dequant_decode_attention: pos must be a "
                             f"host int >= 0 or a 0-d int32 tensor on "
                             f"{q.device}, got {pos.dim()}-d {pos.dtype} on "
                             f"{pos.device}")
        return pos
    if isinstance(pos, bool) or int(pos) != pos or pos < 0:
        raise ValueError(f"kv_dequant_decode_attention: pos must be a host "
                         f"int >= 0 or a 0-d int32 tensor, got {pos!r}")
    return torch.full((), int(pos), dtype=torch.int32, device=q.device)


def _check_window(window: int, T: int) -> None:
    if window and T > window:
        raise ValueError(f"kv_dequant_decode_attention: a cache of {T} slots "
                         f"for a window of {window}: a windowed layer's "
                         "cache must hold at most W slots (a ring of W, or "
                         "fewer), as B11 applies no window mask")


def kv_dequant_decode_attention(q, codes_k, signs_k, scale_k, codes_v,
                                signs_v, scale_v, pos, *, window: int = 0,
                                kv_dtype=None) -> torch.Tensor:
    """q (BG, rep, hd); cache leaves (BG, T, ·) -> (BG, rep, hd) f32.

    ``pos``: the last valid cache index (causal mask j <= pos), a 0-d
    int32 tensor on q's device or a host int.  ``kv_dtype``: None, or
    torch.bfloat16 to round K/V and the probabilities to bf16 for an f32 q
    too (see the module note).
    """
    _kv_bf16(q.dtype, kv_dtype)
    pos = _check_pos(pos, q)
    cache = (codes_k, signs_k, scale_k, codes_v, signs_v, scale_v)
    BG, rep, hd = q.shape
    T = codes_k.shape[1]
    want = ((BG, T, hd), (BG, T, hd // 8), (BG, T, 1)) * 2
    if hd % 8 or tuple(tuple(t.shape) for t in cache) != want:
        raise ValueError(f"kv_dequant_decode_attention: q {tuple(q.shape)} "
                         f"and cache {[tuple(t.shape) for t in cache]} do "
                         f"not form (BG, rep, hd) x (BG, T, hd | hd/8 | 1)")
    _check_window(window, T)
    dev = _cuda_device((q,) + cache, "kv_dequant_decode_attention")
    if dev is None:
        return kv_dequant_decode_attention_ref(q, *cache, pos,
                                               kv_dtype=kv_dtype)
    return _launch(q.unsqueeze(1), tuple(t.unsqueeze(1) for t in cache),
                   pos, dev, kv_dtype=kv_dtype)[:, 0]


def kv_dequant_decode_attention_gqa(q, codes_k, signs_k, scale_k, codes_v,
                                    signs_v, scale_v, pos, *, window: int = 0,
                                    kv_dtype=None) -> torch.Tensor:
    """q (B, 1, Hq, hd); one layer's cache leaves (B, T, G, ·) ->
    (B, 1, Hq, hd) f32, query head h attending with kv head h // (Hq / G).
    ``window``: the layer's sliding window (0 none), only checked against
    T (see the module note); ``kv_dtype`` as
    :func:`kv_dequant_decode_attention` takes it.
    """
    _kv_bf16(q.dtype, kv_dtype)
    pos = _check_pos(pos, q)
    cache = (codes_k, signs_k, scale_k, codes_v, signs_v, scale_v)
    B, one, Hq, hd = q.shape
    T, G = codes_k.shape[1], codes_k.shape[2]
    want = ((B, T, G, hd), (B, T, G, hd // 8), (B, T, G, 1)) * 2
    if (one != 1 or hd % 8 or Hq % G
            or tuple(tuple(t.shape) for t in cache) != want):
        raise ValueError(f"kv_dequant_decode_attention_gqa: q "
                         f"{tuple(q.shape)} and cache "
                         f"{[tuple(t.shape) for t in cache]} do not form "
                         "(B, 1, Hq, hd) x (B, T, G, hd | hd/8 | 1), G | Hq")
    _check_window(window, T)
    dev = _cuda_device((q,) + cache, "kv_dequant_decode_attention_gqa")
    if dev is None:
        return kv_dequant_decode_attention_gqa_ref(q, *cache, pos,
                                                   kv_dtype=kv_dtype)
    out = _launch(q[:, 0].unflatten(1, (G, Hq // G)),
                  tuple(t.transpose(1, 2) for t in cache), pos, dev,
                  kv_dtype=kv_dtype)
    return out.reshape(B, 1, Hq, hd)
