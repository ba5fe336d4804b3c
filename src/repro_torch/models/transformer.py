"""Decoder-only LM assembly over a layer-kind pattern.

The port of ``repro/models/transformer.py`` for ``"attn"`` and
``"attn_local"`` layers (dense and GQA decoders such as qwen3, granite and
qwen1.5; gemma3's 5 sliding-window : 1 global pattern).  Three modes:

  forward_train   tokens -> logits                     (forward only)
  forward_prefill tokens -> logits_last + caches       (serve prefill)
  forward_decode  1 token + caches -> logits + caches  (serve step)

Parameters and caches keep the JAX package's pytree layout — ``{"units":
(...), "rem": (...)}``, each unit leaf stacked over the pattern units, an
attention cache (U, B, T, G, hd) — so weights and caches cross packages
leaf by leaf (``interop.lm_params_from_numpy``).  A local layer's cache
holds min(max_len, W) slots, a ring once the prompt is longer than W
(``repro``'s layout: position p in slot p % W).  ``lax.scan`` over the
units becomes a Python loop over views of the stacked tensors; decode
writes the new cache entries into those views in place and returns the
same cache.  Decode's ``pos`` becomes one 0-d int32 tensor on the device
at the top of ``forward_decode``, so no layer reads it on the host: the
step is one CUDA graph when captured (``serving.step``), as ``repro``'s is
one XLA program under ``jax.jit`` with pos traced.

Not ported yet (``NotImplementedError``): the layer kinds ``cross_attn``
(A12e), ``rglru``, ``mlstm`` and ``slstm`` (A12d), MoE feed-forward
(A12c), encoder-decoder models (A12e) and ``loss_fn`` (training, A12f).
"""
from __future__ import annotations

import torch

from ..core.devices import resolve_device
from . import attention as A
from .config import ModelConfig
from .layers import dense_init, rms_norm
from .mlp import init_mlp_params, mlp

__all__ = ["init_params", "forward_train", "forward_prefill",
           "forward_decode", "init_decode_cache", "decode_pos",
           "check_decode_pos"]

ATTN_KINDS = ("attn", "attn_local")
_UNPORTED_KINDS = {"cross_attn": "A12e", "rglru": "A12d", "mlstm": "A12d",
                   "slstm": "A12d"}


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for what the port cannot run yet."""
    if cfg.encoder is not None:
        raise NotImplementedError(
            f"{cfg.name}: encoder-decoder models are not ported yet "
            "(ROADMAP A12e)")
    for kind in cfg.pattern:
        if kind in _UNPORTED_KINDS:
            raise NotImplementedError(
                f"{cfg.name}: layer kind {kind!r} is not ported yet "
                f"(ROADMAP {_UNPORTED_KINDS[kind]})")
        if kind not in ATTN_KINDS:
            raise ValueError(kind)
    if cfg.moe is not None:
        raise NotImplementedError(
            f"{cfg.name}: MoE layers are not ported yet (ROADMAP A12c)")


def _has_mlp(cfg: ModelConfig) -> bool:
    return cfg.d_ff > 0


def _window(cfg: ModelConfig, kind: str) -> int:
    """Window for local kinds (0 = full)."""
    return cfg.sliding_window if kind == "attn_local" else 0


def _cache_len(cfg: ModelConfig, kind: str, max_len: int) -> int:
    """Slots of a layer's cache: a local layer's ring holds at most W."""
    W = _window(cfg, kind)
    return min(max_len, W) if W else max_len


def _index(tree, u: int):
    """The ``u``-th unit of a stacked tree, as views."""
    if isinstance(tree, dict):
        return {k: _index(v, u) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_index(v, u) for v in tree)
    return tree[u]


# ===========================================================================
# parameter init
# ===========================================================================

def _init_layer(gen, cfg: ModelConfig, dtype, device, lead) -> dict:
    d = cfg.d_model
    prm = {"ln1": torch.zeros(lead + (d,), dtype=torch.float32, device=device),
           "attn": A.init_attn_params(gen, cfg, dtype, device, lead)}
    if _has_mlp(cfg):
        prm["ln2"] = torch.zeros(lead + (d,), dtype=torch.float32,
                                 device=device)
        prm["mlp"] = init_mlp_params(gen, d, cfg.d_ff, cfg.act, dtype, device,
                                     lead)
    return prm


def init_params(cfg: ModelConfig, gen=0, dtype=torch.bfloat16,
                device=None) -> dict:
    """Random weights on ``device`` (default ``cuda:0``), drawn from
    ``gen``: a ``torch.Generator`` on that device, or an int seed for
    one.  On ``torch.device("meta")`` only the shapes are built."""
    check_supported(cfg)
    dev = resolve_device(device)
    if dev.type == "meta":
        gen = None
    elif not isinstance(gen, torch.Generator):
        gen = torch.Generator(device=dev).manual_seed(int(gen))
    params = {
        "embed": dense_init(gen, (cfg.vocab, cfg.d_model), 1, dtype, dev),
        "final_norm": torch.zeros((cfg.d_model,), dtype=torch.float32,
                                  device=dev),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = dense_init(gen, (cfg.d_model, cfg.vocab), 0,
                                       dtype, dev)
    params["units"] = [_init_layer(gen, cfg, dtype, dev, (cfg.n_units,))
                       for _ in cfg.pattern]
    params["rem"] = [_init_layer(gen, cfg, dtype, dev, ())
                     for _ in range(cfg.n_remainder)]
    return params


# ===========================================================================
# single layer application
# ===========================================================================

def _ffn(cfg: ModelConfig, x, prm):
    if _has_mlp(cfg):
        x = x + mlp(rms_norm(x, prm["ln2"], cfg.norm_eps), prm["mlp"],
                    cfg.act)
    return x


def _apply_layer_full(cfg: ModelConfig, kind: str, x, prm, positions,
                      cache):
    """Full-sequence pass; writes k/v into ``cache`` (a per-layer
    ``{"k", "v"}`` of views, or None): from slot 0, or for a prompt longer
    than a local layer's ring its last Tc positions p at slots p % Tc."""
    W = _window(cfg, kind)
    h = rms_norm(x, prm["ln1"], cfg.norm_eps)
    mix, (k, v) = A.attention_full(h, prm["attn"], cfg, positions, window=W)
    if cache is not None:
        S, Tc = k.shape[1], cache["k"].shape[1]
        if W and S > Tc:
            slots = torch.arange(S - Tc, S, device=k.device) % Tc
            cache["k"].index_copy_(1, slots, k[:, S - Tc:])
            cache["v"].index_copy_(1, slots, v[:, S - Tc:])
        else:
            A.update_cache(cache["k"], cache["v"], k, v, 0)
    return _ffn(cfg, x + mix, prm)


def _apply_layer_decode(cfg: ModelConfig, kind: str, x, prm, pos, cache):
    W = _window(cfg, kind)
    h = rms_norm(x, prm["ln1"], cfg.norm_eps)
    if "codes_k" in cache:           # pwrel-compressed KV (serving/kvcache)
        from ..serving import kvcache as KV
        mix, _ = KV.compressed_attention_decode(h, prm["attn"], cfg, cache,
                                                pos, window=W)
    else:
        mix, _, _ = A.attention_decode(h, prm["attn"], cfg, cache["k"],
                                       cache["v"], pos, window=W)
    return _ffn(cfg, x + mix, prm)


# ===========================================================================
# trunk traversal (loop over units + remainder)
# ===========================================================================

def _layers(cfg: ModelConfig, params, cache):
    """(layer kind, layer params, layer cache or None) in depth order, as
    views."""
    for u in range(cfg.n_units):
        for i, kind in enumerate(cfg.pattern):
            yield (kind, _index(params["units"][i], u),
                   None if cache is None else _index(cache["units"][i], u))
    for i, prm in enumerate(params["rem"]):
        yield (cfg.pattern[i], prm,
               None if cache is None else cache["rem"][i])


# ===========================================================================
# public entry points
# ===========================================================================

def _embed(cfg: ModelConfig, params, tokens):
    x = params["embed"][tokens]
    # the constant is rounded to the embedding's dtype first, as in JAX
    # (on the host: a device tensor made from a host value would sync)
    return x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype).item()


def _logits(cfg: ModelConfig, params, x):
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    w = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    logits = (x @ w).to(torch.float32)
    if cfg.logits_softcap:
        c = cfg.logits_softcap
        logits = c * torch.tanh(logits / c)
    return logits


def forward_train(cfg: ModelConfig, params, tokens, aux=None):
    """tokens (B, S) -> logits (B, S, V) f32 (forward only)."""
    check_supported(cfg)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    x = _embed(cfg, params, tokens)
    for kind, prm, _ in _layers(cfg, params, None):
        x = _apply_layer_full(cfg, kind, x, prm, positions, None)
    return _logits(cfg, params, x)


def forward_prefill(cfg: ModelConfig, params, tokens, aux=None,
                    max_len: int | None = None):
    """tokens (B, S) -> (last-position logits (B, V), decode cache with
    room for ``max_len`` positions)."""
    check_supported(cfg)
    B, S = tokens.shape
    max_len = max_len or S
    positions = torch.arange(S, device=tokens.device)
    cache = init_decode_cache(cfg, B, max_len, params["embed"].dtype,
                              tokens.device)
    x = _embed(cfg, params, tokens)
    for kind, prm, c in _layers(cfg, params, cache):
        x = _apply_layer_full(cfg, kind, x, prm, positions, c)
    return _logits(cfg, params, x[:, -1:, :])[:, 0, :], cache


def decode_pos(cfg: ModelConfig, cache, pos, device) -> torch.Tensor:
    """``pos`` as every decode layer takes it: a 0-d int32 tensor on
    ``device``.  A host int is checked (:func:`check_decode_pos`) and
    filled into a new tensor; a tensor must already be 0-d int32 on
    ``device`` (its value is not read: no host sync)."""
    if isinstance(pos, torch.Tensor):
        if pos.dim() != 0 or pos.dtype != torch.int32 or \
                pos.device != torch.device(device):
            raise ValueError(f"forward_decode: pos must be a host int or a "
                             f"0-d int32 tensor on {device}, got "
                             f"{pos.dim()}-d {pos.dtype} on {pos.device}")
        return pos
    return torch.full((), check_decode_pos(cfg, cache, pos),
                      dtype=torch.int32, device=device)


def check_decode_pos(cfg: ModelConfig, cache, pos: int) -> int:
    """A host int ``pos`` range-checked against every cache that is not a
    ring (a local layer's cache of exactly W slots takes any pos)."""
    if isinstance(pos, bool) or int(pos) != pos or pos < 0:
        raise ValueError(f"forward_decode: pos must be an int >= 0, got "
                         f"{pos!r}")
    entries = [(kind, c, 2) for kind, c in zip(cfg.pattern, cache["units"])
               if cfg.n_units]
    entries += [(cfg.pattern[i], c, 1) for i, c in enumerate(cache["rem"])]
    for kind, c, seq_axis in entries:
        T = next(iter(c.values())).shape[seq_axis]
        W = _window(cfg, kind)
        if not (W and T == W) and pos >= T:
            raise ValueError(f"forward_decode: 1 entry at {pos} do not fit "
                             f"a cache of {T}")
    return int(pos)


def forward_decode(cfg: ModelConfig, params, token, cache, pos,
                   aux=None, kv_codec: bool = False):
    """token (B, 1) + cache -> (logits (B, V), cache), the new entries
    written into ``cache`` at ``pos`` in place.  ``pos`` is a host int or
    a 0-d int32 tensor on the token's device (:func:`decode_pos`); below
    this line every layer sees the tensor, so the step reads nothing back
    from the device.

    ``kv_codec`` is informational — the compressed path triggers off the
    cache's own leaves (``codes_k`` present => pwrel-compressed KV).
    """
    del kv_codec
    check_supported(cfg)
    pos = decode_pos(cfg, cache, pos, token.device)
    x = _embed(cfg, params, token)
    for kind, prm, c in _layers(cfg, params, cache):
        x = _apply_layer_decode(cfg, kind, x, prm, pos, c)
    return _logits(cfg, params, x)[:, 0, :], cache


def init_decode_cache(cfg: ModelConfig, batch: int, max_len: int,
                      dtype=torch.bfloat16, device=None):
    """Zero cache in the layout ``forward_decode`` reads: per pattern
    position a stacked (U, B, T, G, hd) k/v pair, per remainder layer an
    unstacked one; T is ``max_len``, for a local layer min(max_len, W)
    (its ring)."""
    check_supported(cfg)
    dev = resolve_device(device)
    units = tuple(A.init_cache(cfg, batch, _cache_len(cfg, kind, max_len),
                               cfg.n_units, dtype, dev)
                  if cfg.n_units else () for kind in cfg.pattern)
    rem = tuple(_index(A.init_cache(cfg, batch,
                                    _cache_len(cfg, cfg.pattern[i], max_len),
                                    1, dtype, dev), 0)
                for i in range(cfg.n_remainder))
    return {"units": units, "rem": rem}
