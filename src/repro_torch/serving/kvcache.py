"""Compressed KV cache — the paper's technique as a first-class LM feature.

The port of ``repro/serving/kvcache.py``.  BMQSIM's §4.3 scheme (sign
bitmap + log2 transform + bounded quantization) applied to decode KV
caches: K/V live on the card as uint8 log-codes + packed sign bits + a
per-(token, kv-head) scale, ~1.73x smaller than bf16 at hd = 128.

Layout per KV tensor (..., T, G, hd):
    codes  uint8 (..., T, G, hd)      0 = exact-zero escape
    signs  uint8 (..., T, G, hd/8)    sign bitmap, bit i of byte j = 8j + i
    scale  f32   (..., T, G, 1)       per-(token, head) log2 max

Quantization step: 16 log2 units over 254 codes.  ``torch.round`` rounds
half to even, like ``jnp.round``; the codes are not bit-equal to the JAX
package's, whose ``log2`` (XLA's) is not correctly rounded — see ROADMAP
§C for the measured share of codes that differ by one.

``compressed_attention_decode``'s attention core is the fused
dequantize-attention kernel (``kernels/kv_dequant_attention.py``, B11),
which reads the stacked cache in place; each new entry is quantized once
and written into the cache in place (``_update_q``), at the device
position ``pos`` (a 0-d int32 tensor: no host sync, so the step can be
captured), in ring mode at slot pos % T as ``repro``'s.  A cross-attention
layer's compressed image k/v (``compressed_cross_decode``) goes through the
same kernel over all its T slots: ``repro`` dequantizes that cache to bf16
and attends unmasked, which is B11 at pos = T - 1.
"""
from __future__ import annotations

import torch

from ..kernels.kv_dequant_attention import kv_dequant_decode_attention_gqa
from ..kernels.ref import KV_CODE_MAX, KV_STEP, kv_dequant_ref
from ..models import attention as A
from ..models import transformer as T
from ..models.config import ModelConfig
from ..models.layers import rms_norm

__all__ = ["quantize_kv", "dequantize_kv", "compress_prefill_cache",
           "compressed_attention_decode", "compressed_cross_decode",
           "make_compressed_decode_step", "kv_bytes_ratio",
           "init_compressed_cache_spec"]

def kv_bytes_ratio(hd: int) -> float:
    """bf16 bytes / compressed bytes per element."""
    return 2.0 / (1.0 + 1.0 / 8.0 + 4.0 / hd)


def quantize_kv(x: torch.Tensor) -> dict:
    """x: (..., T, G, hd) -> codes/signs/scale dict (see module doc)."""
    xf = x.to(torch.float32)
    absx = xf.abs()
    L = torch.log2(torch.clamp(absx, min=1e-30))
    scale = torch.amax(L, dim=-1, keepdim=True)            # (..., T, G, 1)
    # a device tensor (filled on the device: no host sync), so that CUDA
    # divides exactly instead of multiplying by a host scalar's reciprocal
    step = torch.full((), KV_STEP, dtype=torch.float32, device=x.device)
    d = torch.round((scale - L) / step)
    codes = torch.clamp(KV_CODE_MAX - d, 0.0, float(KV_CODE_MAX))
    codes = torch.where(absx == 0.0, torch.zeros_like(codes), codes) \
        .to(torch.uint8)
    neg = (xf < 0).to(torch.uint8)
    neg = neg.reshape(*neg.shape[:-1], neg.shape[-1] // 8, 8)
    weights = 2 ** torch.arange(8, dtype=torch.uint8, device=x.device)
    signs = (neg * weights).sum(-1, dtype=torch.uint8)
    return {"codes": codes, "signs": signs, "scale": scale}


def dequantize_kv(q: dict, dtype=torch.bfloat16) -> torch.Tensor:
    return kv_dequant_ref(q["codes"], q["signs"], q["scale"]).to(dtype)


def compress_prefill_cache(cache) -> dict:
    """Quantize every attention k/v leaf of a prefill-produced cache (a new
    tree; stacked leaves are quantized one unit at a time, which bounds the
    f32 temporaries to one layer).  Recurrent states are O(1) and stay
    raw, as ``repro``'s, as copies: decode writes states in place, and
    decoding either cache leaves the other as it was."""
    def quantize(x):
        if x.dim() < 5:
            return quantize_kv(x)
        parts = [quantize_kv(x[u]) for u in range(x.shape[0])]
        return {f: torch.stack([p[f] for p in parts]) for f in parts[0]}

    def conv(entry):
        out = dict(entry)
        for key in ("k", "v"):
            q = quantize(entry[key])
            out[f"codes_{key}"] = q["codes"]
            out[f"signs_{key}"] = q["signs"]
            out[f"scale_{key}"] = q["scale"]
            del out[key]
        return out

    def walk(node):
        if isinstance(node, dict) and ("k" in node):
            return conv(node)
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return node.clone()          # a recurrent state, kept raw

    return walk(cache)


def _unpack(qc: dict, key: str) -> dict:
    return {"codes": qc[f"codes_{key}"], "signs": qc[f"signs_{key}"],
            "scale": qc[f"scale_{key}"]}


def _update_q(qc: dict, key: str, new: dict, pos) -> dict:
    """Write the quantized (B, S, ...) entry at sequence offset ``pos`` (a
    host int, or a 0-d tensor on the cache's device) into ``qc``'s leaves,
    in place; returns ``qc``."""
    fields = ("codes", "signs", "scale")
    A.write_seq([qc[f"{f}_{key}"] for f in fields], [new[f] for f in fields],
                pos)
    return qc


def compressed_attention_decode(x, prm, cfg: ModelConfig, qcache: dict,
                                pos, *, window: int = 0):
    """attention_decode against a quantized cache at ``pos`` (a 0-d int32
    tensor on x's device); quantizes the new entry once, writes it at its
    slot in place (pos % T in ring mode) and attends through the fused
    dequantize-attention kernel, which reads min(T, pos + 1) slots: all of
    a ring once it has wrapped.  As ``repro``'s decode dequantizes the cache
    to bf16 whatever the model's dtype and its P·V einsum returns bf16, the
    kernel rounds K/V and the probabilities to bf16 (``kv_dtype``) and the
    attention output is rounded to bf16 before ``wo``; for a bf16 model both
    are what the bf16 q already gave."""
    B = x.shape[0]
    T = qcache["codes_k"].shape[1]
    q, k, v = A._project_qkv(x, prm, cfg)
    q, k = A.rope_at(q, k, pos, cfg)

    slot = A.decode_slot(pos, T, window)
    _update_q(qcache, "k", quantize_kv(k), slot)
    _update_q(qcache, "v", quantize_kv(v), slot)
    leaves = [_unpack(qcache, key)[f] for key in ("k", "v")
              for f in ("codes", "signs", "scale")]
    out = kv_dequant_decode_attention_gqa(q, *leaves, pos, window=window,
                                          kv_dtype=torch.bfloat16)
    out = out.to(torch.bfloat16).to(x.dtype).reshape(B, 1, -1) @ prm["wo"]
    return out, qcache


_LAST_SLOTS: dict = {}


def _last_slot(T: int, device: torch.device) -> torch.Tensor:
    """T - 1 as a 0-d int32 tensor on ``device``, made once per (T,
    device) and never written: the pos of a read over every slot."""
    key = (T, device)
    if key not in _LAST_SLOTS:
        _LAST_SLOTS[key] = torch.full((), T - 1, dtype=torch.int32,
                                      device=device)
    return _LAST_SLOTS[key]


def compressed_cross_decode(x, prm, cfg: ModelConfig, qcache: dict):
    """attention_cross of x (B, 1, d) against a quantized cross cache (the
    image's k/v, (B, T, G, ·) leaves, written by prefill and never here):
    the fused dequantize-attention kernel over every slot, at pos = T - 1
    held on the device (no host sync: the step stays capturable), with
    K/V and the probabilities rounded to bf16 and the output rounded to
    bf16 before ``wo``, as ``repro``'s dequantize-to-bf16 then
    ``attention_cross`` rounds them."""
    B = x.shape[0]
    q = (x @ prm["wq"]).reshape(B, 1, cfg.n_heads, cfg.hd)
    if cfg.qk_norm:
        q = rms_norm(q, prm["q_norm"], cfg.norm_eps)
    pos = _last_slot(qcache["codes_k"].shape[1], x.device)
    leaves = [_unpack(qcache, key)[f] for key in ("k", "v")
              for f in ("codes", "signs", "scale")]
    out = kv_dequant_decode_attention_gqa(q, *leaves, pos,
                                          kv_dtype=torch.bfloat16)
    return out.to(torch.bfloat16).to(x.dtype).reshape(B, 1, -1) @ prm["wo"]


def make_compressed_decode_step(cfg: ModelConfig):
    """Decode step whose attention cache leaves are quantized (recurrent
    states stay raw).  ``repro`` decodes an encoder-decoder model on raw
    caches only (its compressed step is the decoder-only one), so an
    ``"audio"`` config raises ``ValueError``."""
    if cfg.family == "audio":
        raise ValueError(f"{cfg.name}: an encoder-decoder model decodes on "
                         "raw caches only (make_decode_step), as in repro; "
                         "there is no compressed encoder-decoder step")

    def decode(params, batch):
        return T.forward_decode(cfg, params, batch["token"], batch["cache"],
                                batch["pos"], batch.get("aux"),
                                kv_codec=True)
    return decode


def init_compressed_cache_spec(cfg: ModelConfig, batch: int, max_len: int):
    """Abstract quantized-cache tree for the dry run: ``repro``'s
    ``jax.eval_shape`` of the compressed zero cache, here the same tree of
    tensors on the ``meta`` device (shapes and dtypes, no storage).  As
    ``repro``'s, it is the decoder-only layout for any config: an
    encoder-decoder one gets its decoder's self-attention stack."""
    meta = torch.device("meta")
    if cfg.encoder is not None:
        cfg = cfg.with_(encoder=None)
    return compress_prefill_cache(
        T.init_decode_cache(cfg, batch, max_len, device=meta))
