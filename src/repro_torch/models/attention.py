"""GQA attention: full-sequence (train/prefill) and decode-with-cache.

The port of ``repro/models/attention.py`` for full attention layers: GQA
group sizes from MQA (granite kv=1) to MHA, qk-norm (qwen3), QKV bias
(qwen1.5).  ``attention_full``'s attention core is the flash-attention
kernel (``kernels/flash_attention.py``, B10), which sums in f32, rounds
the probabilities to bf16 for P·V as ``_gqa_out`` does, and never
materialises the scores; the raw-cache decode stays plain torch, as it is
plain XLA in the JAX package.  Softmax accumulates in f32;
activations are bf16.

Not ported yet (they raise ``NotImplementedError``): sliding windows, the
banded local attention and ring caches (ROADMAP A12b), sequence-parallel
attention (A12g) and cross-attention (A12e).

Caches are written in place: ``update_cache`` stores the new entries into
the given (view of the stacked) cache tensors and returns them, where the
JAX package returns updated copies.
"""
from __future__ import annotations

import torch

from ..core.devices import resolve_device
from ..kernels.flash_attention import flash_attention_gqa
from ..kernels.ref import NEG_INF
from .config import ModelConfig
from .layers import dense_init, rms_norm, rope, rope_cos_sin

__all__ = ["init_attn_params", "attention_full", "attention_decode",
           "attention_cross", "init_cache", "update_cache"]


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


def _unported_window(window: int) -> None:
    if window:
        raise NotImplementedError(
            "sliding-window attention is not ported yet (ROADMAP A12b)")


def attention_full(x, prm, cfg: ModelConfig, positions, *,
                   window: int = 0, causal: bool = True):
    """Train/prefill self-attention. Returns (out, (k, v)) for caching.

    ``positions`` is the (S,) vector 0..S-1 every caller passes; the causal
    mask is by sequence index, which equals the JAX package's mask by
    position for it.
    """
    _unported_window(window)
    if cfg.seq_parallel_attn:
        raise NotImplementedError(
            "sequence-parallel attention is not ported yet (ROADMAP A12g)")
    S = x.shape[1]
    if positions.shape != (S,):
        raise ValueError(f"attention_full: positions of shape "
                         f"{tuple(positions.shape)}, want ({S},)")
    q, k, v = _project_qkv(x, prm, cfg)
    cos, sin = rope_cos_sin(positions, cfg.hd, cfg.rope_theta)
    q = rope(q, cos, sin)
    k = rope(k, cos, sin)
    out = flash_attention_gqa(q, k, v, causal=causal)      # (B,S,Hq,hd)
    return out.reshape(x.shape[0], S, -1) @ prm["wo"], (k, v)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, n_layers: int,
               dtype=torch.bfloat16, device=None) -> dict:
    """Stacked KV cache for n_layers of one kind: (L, B, T, G, hd);
    ``device=None`` means ``cuda:0``."""
    device = resolve_device(device)
    shape = (n_layers, batch, max_len, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def update_cache(cache_k, cache_v, k, v, pos: int):
    """Write (B,S,G,hd) at sequence offset ``pos`` (a host int), in place;
    returns the two cache tensors."""
    S, T = k.shape[1], cache_k.shape[1]
    if not 0 <= pos <= T - S:
        raise ValueError(f"update_cache: {S} entries at {pos} do not fit a "
                         f"cache of {T}")
    cache_k[:, pos:pos + S] = k
    cache_v[:, pos:pos + S] = v
    return cache_k, cache_v


def attention_decode(x, prm, cfg: ModelConfig, cache_k, cache_v, pos: int,
                     *, window: int = 0):
    """One-token decode: x (B,1,d) against cache (B,T,G,hd) at offset pos
    (a host int); the new entry is written into the cache in place.

    Returns (out, cache_k, cache_v).
    """
    _unported_window(window)
    B = x.shape[0]
    T = cache_k.shape[1]
    q, k, v = _project_qkv(x, prm, cfg)
    posv = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    cos, sin = rope_cos_sin(posv, cfg.hd, cfg.rope_theta)
    q = rope(q, cos, sin)
    k = rope(k, cos, sin)
    cache_k, cache_v = update_cache(cache_k, cache_v, k, v, pos)

    scores = _gqa_scores(q, cache_k, cfg)                 # (B,G,r,1,T)
    mask = torch.arange(T, device=x.device) <= pos
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = _gqa_out(probs, cache_v, cfg) @ prm["wo"]
    return out, cache_k, cache_v


def attention_cross(x, prm, cfg: ModelConfig, kv_src=None, kv_cache=None):
    """Cross-attention (llama-vision, whisper): not ported yet."""
    raise NotImplementedError(
        "cross-attention is not ported yet (ROADMAP A12e)")
