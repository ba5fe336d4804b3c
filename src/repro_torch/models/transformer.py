"""Decoder-only LM assembly over a layer-kind pattern.

The port of ``repro/models/transformer.py``, every layer kind:

  attn / attn_local   GQA attention (full / sliding-window), with a dense
                      or an MoE feed-forward (``models/moe.py``)
  cross_attn          cross-attention to the stub image embeddings ``aux``
                      (B, n_image_tokens, d_model) of a VLM (llama-vision)
  rglru               RecurrentGemma temporal mixing (``models/recurrent.py``)
  mlstm / slstm       xLSTM blocks (``models/xlstm.py``)

Three modes, and the training loss:

  forward_train   tokens -> logits                     (no caches)
  forward_prefill tokens -> logits_last + caches       (serve prefill)
  forward_decode  1 token + caches -> logits + caches  (serve step)
  loss_fn         tokens -> next-token cross-entropy   (training)

With ``cfg.remat`` and grad enabled, ``forward_train`` checkpoints each
pattern unit (``torch.utils.checkpoint``, non-reentrant), as ``repro``
wraps its unit body in ``jax.checkpoint``: the backward recomputes a
unit's activations, and the flash-attention kernel (B10) runs again in
that recompute.

Parameters and caches keep the JAX package's pytree layout — ``{"units":
(...), "rem": (...)}``, each unit leaf stacked over the pattern units, an
attention cache (U, B, T, G, hd), a recurrent state (U, B, ...) — so
weights and caches cross packages leaf by leaf
(``interop.lm_params_from_numpy``).  A local layer's cache holds
min(max_len, W) slots, a ring once the prompt is longer than W
(``repro``'s layout: position p in slot p % W).  A cross-attention
layer's cache holds the image's k/v, written once by prefill and read
whole at every step: ``pos`` never indexes it.  ``lax.scan`` over the
units becomes a Python loop over views of the stacked tensors; prefill
and decode write each layer's cache entry or new recurrent state into
those views in place and return the same cache.  Decode's ``pos`` becomes
one 0-d int32 tensor on the device at the top of ``forward_decode``, so
no layer reads it on the host: the step is one CUDA graph when captured
(``serving.step``), as ``repro``'s is one XLA program under ``jax.jit``
with pos traced.

Encoder-decoder models (whisper) run through ``models/encdec.py``; this
module refuses them.

Sharded training (``train.step.make_train_step(..., mesh=...)``) runs
the same layer code with a rank's ``par``
(``distributed.collectives.Parallel``; None is one device): each unit's
parameter blocks pass through the FSDP gather inside the checkpointed unit
body, so the recompute gathers again; Megatron's *f* takes the normed
input of the attention and of the MLP, *g* their outputs before the
residual adds; the attention runs on the rank's heads through a local
config, the MLP on its ff columns; the embedding and the tied logits are
vocab-parallel, and so is the cross-entropy (:func:`next_token_nll`).
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

from ..core.devices import resolve_device
from . import attention as A
from . import recurrent as R
from . import xlstm as X
from .config import ModelConfig
from .layers import dense_init, rms_norm
from .mlp import init_mlp_params, mlp
from .moe import init_moe_params, moe_layer

__all__ = ["init_params", "forward_train", "forward_prefill",
           "forward_decode", "init_decode_cache", "loss_fn", "decode_pos",
           "check_decode_pos", "state_leaves", "next_token_nll", "remat",
           "unstack"]

#: self-attention kinds: a cache of sequence positions, indexed by pos
ATTN_KINDS = ("attn", "attn_local")
#: cross-attention: a cache of the image's k/v, read whole at any pos
CROSS_KINDS = ("cross_attn",)
STATE_KINDS = ("rglru", "mlstm", "slstm")


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``ValueError`` for a config this module does not run."""
    if cfg.encoder is not None:
        raise ValueError(f"{cfg.name}: an encoder-decoder model runs "
                         "through models.encdec, not the decoder-only LM")
    for kind in cfg.pattern:
        if kind not in ATTN_KINDS + CROSS_KINDS + STATE_KINDS:
            raise ValueError(kind)


def _has_mlp(cfg: ModelConfig, kind: str) -> bool:
    return (kind in ATTN_KINDS + CROSS_KINDS
            and (cfg.d_ff > 0 or cfg.moe is not None))


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


def unstack(tree, n: int) -> list:
    """The ``n`` units of a stacked tree, as views, from one ``unbind`` of
    each leaf.  Under autograd the units' gradients then come back to a
    leaf in one stack, where indexing it once a unit would add a zero-padded
    full-size gradient for every unit."""
    if isinstance(tree, dict):
        parts = {k: unstack(v, n) for k, v in tree.items()}
        return [{k: parts[k][u] for k in tree} for u in range(n)]
    if isinstance(tree, (list, tuple)):
        parts = [unstack(v, n) for v in tree]
        return [type(tree)(p[u] for p in parts) for u in range(n)]
    return list(tree.unbind(0))


# ===========================================================================
# parameter init
# ===========================================================================

_MIXERS = {"rglru": R.init_rglru_params, "mlstm": X.init_mlstm_params,
           "slstm": X.init_slstm_params}


def _init_layer(gen, cfg: ModelConfig, kind: str, dtype, device,
                lead) -> dict:
    d = cfg.d_model
    prm = {"ln1": torch.zeros(lead + (d,), dtype=torch.float32,
                              device=device)}
    if kind in ATTN_KINDS + CROSS_KINDS:
        prm["attn"] = A.init_attn_params(gen, cfg, dtype, device, lead)
    else:
        prm["mix"] = _MIXERS[kind](gen, cfg, dtype, device, lead)
    if _has_mlp(cfg, kind):
        prm["ln2"] = torch.zeros(lead + (d,), dtype=torch.float32,
                                 device=device)
        prm["mlp"] = (init_moe_params(gen, cfg, dtype, device, lead)
                      if cfg.moe is not None else
                      init_mlp_params(gen, d, cfg.d_ff, cfg.act, dtype,
                                      device, lead))
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
    params["units"] = [_init_layer(gen, cfg, kind, dtype, dev,
                                   (cfg.n_units,))
                       for kind in cfg.pattern]
    params["rem"] = [_init_layer(gen, cfg, cfg.pattern[i], dtype, dev, ())
                     for i in range(cfg.n_remainder)]
    return params


# ===========================================================================
# single layer application
# ===========================================================================

def _ffn(cfg: ModelConfig, kind: str, x, prm, par=None):
    if _has_mlp(cfg, kind):
        h = rms_norm(x, prm["ln2"], cfg.norm_eps)
        if par is not None:
            h = par.f(h)
        out = (moe_layer(h, prm["mlp"], cfg) if cfg.moe is not None
               else mlp(h, prm["mlp"], cfg.act))
        x = x + (out if par is None else par.g(out))
    return x


def _write_state(cache, state: dict) -> None:
    """Copy a layer's new tensors (its recurrent state, or a cross
    layer's image k/v) into its cache views."""
    for key, t in state.items():
        cache[key].copy_(t)


def _apply_layer_full(cfg: ModelConfig, kind: str, x, prm, positions, aux,
                      cache, par=None):
    """Full-sequence pass; writes the layer's cache entry into ``cache``
    (its views, or None): k/v from slot 0, or for a prompt longer than a
    local layer's ring its last Tc positions p at slots p % Tc; a
    cross-attention layer's k/v of the image embeddings ``aux``; a
    recurrent layer's final state.  With a rank's ``par`` (self-attention
    layers of a training pass) the attention runs on the rank's heads
    between *f* and *g*."""
    h = rms_norm(x, prm["ln1"], cfg.norm_eps)
    want = cache is not None
    if kind in ATTN_KINDS:
        W = _window(cfg, kind)
        acfg = cfg
        if par is not None:
            h, acfg = par.f(h), par.local_cfg(cfg)
        mix, (k, v) = A.attention_full(h, prm["attn"], acfg, positions,
                                       window=W)
        if par is not None:
            mix = par.g(mix)
        if want:
            S, Tc = k.shape[1], cache["k"].shape[1]
            if W and S > Tc:
                slots = torch.arange(S - Tc, S, device=k.device) % Tc
                cache["k"].index_copy_(1, slots, k[:, S - Tc:])
                cache["v"].index_copy_(1, slots, v[:, S - Tc:])
            else:
                A.update_cache(cache["k"], cache["v"], k, v, 0)
    elif kind == "cross_attn":
        mix, (k, v) = A.attention_cross(h, prm["attn"], cfg, kv_src=aux)
        if want:
            _write_state(cache, {"k": k, "v": v})
    elif kind == "rglru":
        mix, (hlast, conv) = R.rglru_full(h, prm["mix"], cfg)
        if want:
            _write_state(cache, {"h": hlast, "conv": conv})
    elif kind == "mlstm":
        mix, state = X.mlstm_full(h, prm["mix"], cfg, want_state=want)
        if want:
            _write_state(cache, state)
    else:
        mix, carry = X.slstm_full(h, prm["mix"], cfg)
        if want:
            _write_state(cache, dict(zip("hcnm", carry)))
    return _ffn(cfg, kind, x + mix, prm, par)


def _apply_layer_decode(cfg: ModelConfig, kind: str, x, prm, pos, cache):
    """One token through one layer; its cache entry or new recurrent state
    is written into ``cache`` in place."""
    h = rms_norm(x, prm["ln1"], cfg.norm_eps)
    if kind in ATTN_KINDS:
        W = _window(cfg, kind)
        if "codes_k" in cache:       # pwrel-compressed KV (serving/kvcache)
            from ..serving import kvcache as KV
            mix, _ = KV.compressed_attention_decode(h, prm["attn"], cfg,
                                                    cache, pos, window=W)
        else:
            mix, _, _ = A.attention_decode(h, prm["attn"], cfg, cache["k"],
                                           cache["v"], pos, window=W)
    elif kind == "cross_attn":
        if "codes_k" in cache:       # pwrel-compressed image k/v
            from ..serving import kvcache as KV
            mix = KV.compressed_cross_decode(h, prm["attn"], cfg, cache)
        else:
            mix, _ = A.attention_cross(h, prm["attn"], cfg,
                                       kv_cache=(cache["k"], cache["v"]))
    elif kind == "rglru":
        mix, hn, conv = R.rglru_decode(h, prm["mix"], cfg, cache["h"],
                                       cache["conv"])
        _write_state(cache, {"h": hn, "conv": conv})
    elif kind == "mlstm":
        mix, C, n, m = X.mlstm_decode(h, prm["mix"], cfg, cache["C"],
                                      cache["n"], cache["m"])
        _write_state(cache, {"C": C, "n": n, "m": m})
    else:
        mix, carry = X.slstm_decode(h, prm["mix"], cfg,
                                    tuple(cache[key] for key in "hcnm"))
        _write_state(cache, dict(zip("hcnm", carry)))
    return _ffn(cfg, kind, x + mix, prm)


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

def _embed(cfg: ModelConfig, params, tokens, par=None):
    w = params["embed"]
    if par is None or par.tp == 1:
        x = w[tokens]
    else:   # vocab-parallel: the rank's rows, zero elsewhere, summed
        local = tokens - par.tp_index * w.shape[0]
        inside = (local >= 0) & (local < w.shape[0])
        rows = w[local.clamp(0, w.shape[0] - 1)]
        x = par.g(torch.where(inside[..., None], rows,
                              torch.zeros_like(rows)))
    # the constant is rounded to the embedding's dtype first, as in JAX
    # (on the host: a device tensor made from a host value would sync)
    return x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype).item()


def _logits(cfg: ModelConfig, params, x, par=None):
    """f32 logits; with a rank's ``par``, over its vocab block."""
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if par is not None:
        x = par.f(x)
    w = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    logits = (x @ w).to(torch.float32)
    if cfg.logits_softcap:
        c = cfg.logits_softcap
        logits = c * torch.tanh(logits / c)
    return logits


def remat(cfg: ModelConfig, body, early_stop: bool = True):
    """``body`` checkpointed when ``cfg.remat`` asks for it and grad is
    enabled (non-reentrant: its activations are recomputed in the
    backward; the layers draw no random numbers, so no RNG state is
    kept), else ``body`` itself.  ``early_stop=False`` recomputes the
    whole body, not only up to its last saved tensor: a sharded unit then
    repeats every collective of its forward, as ``launch/dryrun.py``
    counts them."""
    if not (cfg.remat and torch.is_grad_enabled()):
        return body

    def wrapped(*args):
        return checkpoint(body, *args, use_reentrant=False,
                          preserve_rng_state=False)
    if early_stop:
        return wrapped

    def whole(*args):
        with set_checkpoint_early_stop(False):
            return wrapped(*args)
    return whole


def forward_train(cfg: ModelConfig, params, tokens, aux=None, par=None):
    """tokens (B, S) -> logits (B, S, V) f32; ``aux`` the image embeddings
    (B, n_image_tokens, d_model) a cross-attention layer reads.  Each
    pattern unit is checkpointed under ``cfg.remat`` (:func:`remat`), the
    remainder layers not, as in ``repro``.  With a rank's ``par``,
    ``params`` are the rank's blocks and the logits its vocab block's."""
    check_supported(cfg)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    top = params if par is None else par.gather_top(params)
    x = _embed(cfg, top, tokens, par)

    def unit(x, unit_params):
        if par is not None:
            unit_params = [par.gather_unit(i, p)
                           for i, p in enumerate(unit_params)]
        for kind, prm in zip(cfg.pattern, unit_params):
            x = _apply_layer_full(cfg, kind, x, prm, positions, aux, None,
                                  par)
        return x

    body = remat(cfg, unit, early_stop=par is None)
    for unit_params in unstack(params["units"], cfg.n_units):
        x = body(x, unit_params)
    for i, prm in enumerate(params["rem"]):
        if par is not None:
            prm = par.gather_rem(i, prm)
        x = _apply_layer_full(cfg, cfg.pattern[i], x, prm, positions, aux,
                              None, par)
    return _logits(cfg, top, x, par)


def next_token_nll(logits, tokens, par=None):
    """Mean next-token cross-entropy over the B·(S-1) targets of
    ``tokens`` (B, S), from f32 ``logits`` (B, S, V).  With a rank's
    ``par`` the logits are its vocab block's (B, S, V/tp), and the
    cross-entropy is vocab-parallel: the max all-reduced over ``model``
    (MAX, no gradient), the sum of exponentials and the target's logit
    (zero on the ranks that do not hold it) through *g*; the mean is the
    rank's over its B·(S-1) targets."""
    if par is None or par.tp == 1:
        lp = torch.log_softmax(logits[:, :-1], dim=-1)
        nll = -torch.gather(lp, -1, tokens[:, 1:, None].long())[..., 0]
        return nll.mean()
    z = logits[:, :-1]
    V = z.shape[-1]
    m = par.max_model(z.detach().amax(dim=-1))
    s = par.g(torch.exp(z - m[..., None]).sum(dim=-1))
    local = tokens[:, 1:].long() - par.tp_index * V
    inside = (local >= 0) & (local < V)
    zt = torch.gather(z, -1, local.clamp(0, V - 1)[..., None])[..., 0]
    zt = par.g(torch.where(inside, zt, torch.zeros_like(zt)))
    return (torch.log(s) + m - zt).mean()


def loss_fn(cfg: ModelConfig, params, tokens, aux=None, par=None):
    """Next-token cross-entropy (mean over B*(S-1) targets; with a rank's
    ``par``, over its rows' targets)."""
    return next_token_nll(forward_train(cfg, params, tokens, aux, par),
                          tokens, par)


def forward_prefill(cfg: ModelConfig, params, tokens, aux=None,
                    max_len: int | None = None):
    """tokens (B, S) -> (last-position logits (B, V), decode cache with
    room for ``max_len`` positions; a cross-attention entry holds the k/v
    of ``aux``'s image tokens)."""
    check_supported(cfg)
    B, S = tokens.shape
    max_len = max_len or S
    positions = torch.arange(S, device=tokens.device)
    cache = init_decode_cache(
        cfg, B, max_len, params["embed"].dtype, tokens.device,
        n_image_tokens=None if aux is None else aux.shape[1])
    x = _embed(cfg, params, tokens)
    for kind, prm, c in _layers(cfg, params, cache):
        x = _apply_layer_full(cfg, kind, x, prm, positions, aux, c)
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


def _entries(cfg: ModelConfig, cache) -> list:
    """(layer kind, cache entry, leading axes) of every pattern position's
    stacked entry (one leading unit axis) and every remainder layer's."""
    out = [(kind, c, 1) for kind, c in zip(cfg.pattern, cache["units"])
           if cfg.n_units]
    return out + [(cfg.pattern[i], c, 0) for i, c in enumerate(cache["rem"])]


def check_decode_pos(cfg: ModelConfig, cache, pos: int) -> int:
    """A host int ``pos`` range-checked against every self-attention cache
    that is not a ring (a local layer's cache of exactly W slots takes any
    pos; a cross-attention cache, read whole, and a recurrent state
    any)."""
    if isinstance(pos, bool) or int(pos) != pos or pos < 0:
        raise ValueError(f"forward_decode: pos must be an int >= 0, got "
                         f"{pos!r}")
    for kind, c, lead in _entries(cfg, cache):
        if kind not in ATTN_KINDS:
            continue
        T = next(iter(c.values())).shape[lead + 1]
        W = _window(cfg, kind)
        if not (W and T == W) and pos >= T:
            raise ValueError(f"forward_decode: 1 entry at {pos} do not fit "
                             f"a cache of {T}")
    return int(pos)


def state_leaves(cfg: ModelConfig, cache) -> list[torch.Tensor]:
    """The recurrent-state tensors of ``cache``: what a decode step
    overwrites with a function of their old values (an attention cache
    entry is written at pos, the same values however often the step
    runs)."""
    return [t for kind, c, _ in _entries(cfg, cache) if kind in STATE_KINDS
            for t in c.values()]


def forward_decode(cfg: ModelConfig, params, token, cache, pos,
                   aux=None, kv_codec: bool = False):
    """token (B, 1) + cache -> (logits (B, V), cache), the new entries
    written into ``cache`` at ``pos`` in place.  ``pos`` is a host int or
    a 0-d int32 tensor on the token's device (:func:`decode_pos`); below
    this line every layer sees the tensor, so the step reads nothing back
    from the device.  ``aux`` is not read: a cross-attention layer reads
    the image's k/v from its cache, as ``repro``'s does.

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


def _cache_entry(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                 n_layers: int, dtype, device, n_img: int) -> dict:
    """Zero cache entry of ``n_layers`` layers of ``kind``, stacked."""
    if kind in ATTN_KINDS:
        return A.init_cache(cfg, batch, _cache_len(cfg, kind, max_len),
                            n_layers, dtype, device)
    if kind == "cross_attn":
        return A.init_cache(cfg, batch, n_img, n_layers, dtype, device)
    if kind == "rglru":
        return R.init_rglru_state(cfg, batch, n_layers, dtype, device)
    if kind == "mlstm":
        return X.init_mlstm_state(cfg, batch, n_layers, device)
    return X.init_slstm_state(cfg, batch, n_layers, device)


def init_decode_cache(cfg: ModelConfig, batch: int, max_len: int,
                      dtype=torch.bfloat16, device=None,
                      n_image_tokens: int | None = None):
    """Zero cache in the layout ``forward_decode`` reads: per pattern
    position a stacked entry over the units, per remainder layer an
    unstacked one.  An attention entry is a (U, B, T, G, hd) k/v pair, T
    ``max_len``, for a local layer min(max_len, W) (its ring), for a
    cross-attention layer ``n_image_tokens`` (default
    ``cfg.n_image_tokens``); a recurrent one its state (f32, the RG-LRU's
    conv taps in ``dtype``)."""
    check_supported(cfg)
    dev = resolve_device(device)
    n_img = n_image_tokens or cfg.n_image_tokens
    units = tuple(_cache_entry(cfg, kind, batch, max_len, cfg.n_units,
                               dtype, dev, n_img)
                  if cfg.n_units else () for kind in cfg.pattern)
    rem = tuple(_index(_cache_entry(cfg, cfg.pattern[i], batch, max_len, 1,
                                    dtype, dev, n_img), 0)
                for i in range(cfg.n_remainder))
    return {"units": units, "rem": rem}
