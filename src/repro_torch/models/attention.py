"""GQA attention: full-sequence (train/prefill), decode-with-cache, cross.

The port of ``repro/models/attention.py``: GQA group sizes from MQA
(granite kv=1) to MHA, qk-norm (qwen3), QKV bias (qwen1.5), sliding
windows (gemma3's local layers) with ring caches, and cross-attention
(llama-vision's image layers, whisper's decoder).
``attention_full``'s attention core is the flash-attention kernel
(``kernels/flash_attention.py``, B10), which sums in f32, rounds the
probabilities to bf16 for P·V as ``_gqa_out`` does, never materialises the
scores, and applies the window itself; ``cfg.banded_local_attn`` takes the
same call (``repro``'s ``_banded_window_attention`` computes the same
function block-banded, to bound XLA's score buffers, which the kernel never
has).  The raw-cache decode stays plain torch, as it is plain XLA in the
JAX package.  ``attention_cross`` takes the same kernel over the T keys of
its source (T != S, unmasked) when it projects them, and a plain softmax
over every cached slot when it is handed a (k, v) pair, as ``repro``'s
XLA does.  Softmax accumulates in f32; activations are bf16.

``cfg.seq_parallel_attn`` takes the same call as well: ``repro``'s only
adds sharding constraints, which are no-ops on one device.

Caches are written in place: ``update_cache`` stores the new entries into
the given (view of the stacked) cache tensors and returns them, where the
JAX package returns updated copies.  Decode takes ``pos`` as a 0-d int32
tensor on the activations' device (``transformer.forward_decode`` makes it
from a host int): RoPE, the cache slot and the masks come from it on the
device, so a decode step makes no host sync and can be captured as one CUDA
graph (``serving.step.CapturedDecodeStep``).
"""
from __future__ import annotations

import torch

from ..core.devices import resolve_device
from ..kernels.flash_attention import flash_attention_gqa
from ..kernels.ref import NEG_INF
from .config import ModelConfig
from .layers import dense_init, rms_norm, rope, rope_cos_sin

__all__ = ["init_attn_params", "attention_full", "attention_decode",
           "attention_cross", "init_cache", "update_cache", "write_seq",
           "decode_slot", "decode_mask", "rope_at"]


def init_attn_params(gen, cfg: ModelConfig, dtype=torch.bfloat16,
                     device=None, lead=()) -> dict:
    """The layer's weights, each with the leading (stacking) axes
    ``lead``; ``device=None`` means ``cuda:0``."""
    d, hd = cfg.d_model, cfg.hd
    device = resolve_device(device)

    def w(shape):
        return dense_init(gen, lead + shape, len(lead), dtype, device)

    def zeros(n, dt):
        return torch.zeros(lead + (n,), dtype=dt, device=device)

    prm = {"wq": w((d, cfg.n_heads * hd)), "wk": w((d, cfg.n_kv_heads * hd)),
           "wv": w((d, cfg.n_kv_heads * hd)), "wo": w((cfg.n_heads * hd, d))}
    if cfg.qkv_bias:
        prm["bq"] = zeros(cfg.n_heads * hd, dtype)
        prm["bk"] = zeros(cfg.n_kv_heads * hd, dtype)
        prm["bv"] = zeros(cfg.n_kv_heads * hd, dtype)
    if cfg.qk_norm:
        prm["q_norm"] = zeros(hd, torch.float32)
        prm["k_norm"] = zeros(hd, torch.float32)
    return prm


def _project_qkv(x, prm, cfg: ModelConfig):
    B, S, _ = x.shape
    hd = cfg.hd
    q = x @ prm["wq"]
    k = x @ prm["wk"]
    v = x @ prm["wv"]
    if cfg.qkv_bias:
        q = q + prm["bq"]
        k = k + prm["bk"]
        v = v + prm["bv"]
    q = q.reshape(B, S, cfg.n_heads, hd)
    k = k.reshape(B, S, cfg.n_kv_heads, hd)
    v = v.reshape(B, S, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = rms_norm(q, prm["q_norm"], cfg.norm_eps)
        k = rms_norm(k, prm["k_norm"], cfg.norm_eps)
    return q, k, v


def _gqa_scores(q, k, cfg: ModelConfig):
    """q (B,S,Hq,hd), k (B,T,G,hd) -> scores (B,G,rep,S,T) f32."""
    B, S, Hq, hd = q.shape
    q = q.reshape(B, S, cfg.n_kv_heads, cfg.n_rep, hd)
    scores = torch.einsum("bsgrd,btgd->bgrst", q.float(), k.float())
    return scores * (hd ** -0.5)


def _gqa_out(probs, v, cfg: ModelConfig):
    """probs (B,G,rep,S,T) f32, v (B,T,G,hd) -> (B,S,Hq*hd) in v's dtype
    (probabilities rounded to v's dtype first, sums in f32)."""
    B, G, rep, S, T = probs.shape
    out = torch.einsum("bgrst,btgd->bsgrd", probs.to(v.dtype).float(),
                       v.float()).to(v.dtype)
    return out.reshape(B, S, G * rep * v.shape[-1])


def attention_full(x, prm, cfg: ModelConfig, positions, *,
                   window: int = 0, causal: bool = True):
    """Train/prefill self-attention. Returns (out, (k, v)) for caching.

    ``positions`` is the (S,) vector 0..S-1 every caller passes; the causal
    and window masks are by sequence index, which equals the JAX package's
    masks by position for it.  ``window`` W > 0 keeps i - j < W.

    ``cfg.seq_parallel_attn`` runs the same call: ``repro``'s only adds
    sharding constraints (keys and values over ``model``), no-ops on one
    device, and the port has no mesh at run time; the dry run counts its
    collectives (``launch/dryrun.py``).
    """
    S = x.shape[1]
    if positions.shape != (S,):
        raise ValueError(f"attention_full: positions of shape "
                         f"{tuple(positions.shape)}, want ({S},)")
    q, k, v = _project_qkv(x, prm, cfg)
    cos, sin = rope_cos_sin(positions, cfg.hd, cfg.rope_theta)
    q = rope(q, cos, sin)
    k = rope(k, cos, sin)
    out = flash_attention_gqa(q, k, v, causal=causal, window=window)
    return out.reshape(x.shape[0], S, -1) @ prm["wo"], (k, v)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, n_layers: int,
               dtype=torch.bfloat16, device=None) -> dict:
    """Stacked KV cache for n_layers of one kind: (L, B, T, G, hd);
    ``device=None`` means ``cuda:0``."""
    device = resolve_device(device)
    shape = (n_layers, batch, max_len, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def write_seq(targets, values, pos) -> None:
    """Write each (B, S, ...) value into its (B, T, ...) target at
    sequence offset ``pos``, in place: a host int (range-checked) as a
    slice, a 0-d tensor on the targets' device with ``index_copy_`` along
    the sequence axis (no host sync)."""
    S, T = values[0].shape[1], targets[0].shape[1]
    if isinstance(pos, torch.Tensor):
        idx = pos.long() + torch.arange(S, device=pos.device)
        for tgt, val in zip(targets, values):
            tgt.index_copy_(1, idx, val.to(tgt.dtype))
        return
    if not 0 <= pos <= T - S:
        raise ValueError(f"update_cache: {S} entries at {pos} do not fit a "
                         f"cache of {T}")
    for tgt, val in zip(targets, values):
        tgt[:, pos:pos + S] = val


def update_cache(cache_k, cache_v, k, v, pos):
    """Write (B,S,G,hd) at sequence offset ``pos`` (a host int, or a 0-d
    tensor on the cache's device) in place; returns the two cache
    tensors."""
    write_seq((cache_k, cache_v), (k, v), pos)
    return cache_k, cache_v


def decode_slot(pos: torch.Tensor, T: int, window: int) -> torch.Tensor:
    """The cache slot of the token at ``pos`` (0-d device tensor): pos %
    T in ring mode (a windowed layer whose cache is exactly W slots), else
    pos."""
    return pos % T if window and T == window else pos


def decode_mask(pos: torch.Tensor, T: int, window: int) -> torch.Tensor:
    """(T,) bool: the slots a decode step at ``pos`` attends to, as
    ``repro``'s ``attention_decode``: in ring mode every written slot (j <=
    pos, or all once pos >= T; keys are RoPE'd, so slot order never
    matters), else j <= pos within the window."""
    j = torch.arange(T, device=pos.device)
    if window and T == window:
        return (j <= pos) | (pos >= T)
    mask = j <= pos
    if window:
        mask = mask & (pos - j < window)
    return mask


def rope_at(q, k, pos: torch.Tensor, cfg: ModelConfig):
    """q and k of one decoded token rotated to position ``pos`` (0-d device
    tensor), the (B, 1) positions as ``torch.full`` of a host int gives."""
    posv = pos.reshape(1, 1).expand(q.shape[0], 1)
    cos, sin = rope_cos_sin(posv, cfg.hd, cfg.rope_theta)
    return rope(q, cos, sin), rope(k, cos, sin)


def attention_decode(x, prm, cfg: ModelConfig, cache_k, cache_v, pos, *,
                     window: int = 0):
    """One-token decode: x (B,1,d) against cache (B,T,G,hd) at ``pos`` (a
    0-d int32 tensor on x's device); the new entry is written into the
    cache in place, at slot pos % T in ring mode (``window`` and T == W, as
    ``repro``'s RING MODE: a local layer's cache stays O(W)).

    Returns (out, cache_k, cache_v).
    """
    T = cache_k.shape[1]
    q, k, v = _project_qkv(x, prm, cfg)
    q, k = rope_at(q, k, pos, cfg)
    cache_k, cache_v = update_cache(cache_k, cache_v, k, v,
                                    decode_slot(pos, T, window))

    scores = _gqa_scores(q, cache_k, cfg)                 # (B,G,r,1,T)
    scores = torch.where(decode_mask(pos, T, window), scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = _gqa_out(probs, cache_v, cfg) @ prm["wo"]
    return out, cache_k, cache_v


def attention_cross(x, prm, cfg: ModelConfig, kv_src=None, kv_cache=None):
    """Cross-attention: queries from x (B, S, d), keys/values projected
    from the encoder or image output ``kv_src`` (B, T, d) — or a
    precomputed (k, v) pair (B, T, G, hd) in decode — with no RoPE, no
    bias and no mask.  From ``kv_src`` the core is the flash-attention
    kernel over T != S keys; from ``kv_cache`` a plain softmax over every
    slot.  Returns (out, (k, v)) for caching."""
    B, S, _ = x.shape
    hd = cfg.hd
    q = (x @ prm["wq"]).reshape(B, S, cfg.n_heads, hd)
    if cfg.qk_norm:
        q = rms_norm(q, prm["q_norm"], cfg.norm_eps)
    if kv_cache is not None:
        k, v = kv_cache
        probs = torch.softmax(_gqa_scores(q, k, cfg), dim=-1)
        return _gqa_out(probs, v, cfg) @ prm["wo"], (k, v)
    T = kv_src.shape[1]
    k = (kv_src @ prm["wk"]).reshape(B, T, cfg.n_kv_heads, hd)
    v = (kv_src @ prm["wv"]).reshape(B, T, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        k = rms_norm(k, prm["k_norm"], cfg.norm_eps)
    out = flash_attention_gqa(q, k, v, causal=False)
    return out.reshape(B, S, -1) @ prm["wo"], (k, v)
