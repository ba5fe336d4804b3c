"""Encoder-decoder assembly (whisper-large-v3 backbone).

The port of ``repro/models/encdec.py``.  The conv frontend is a stub, as
there: the caller feeds precomputed frame embeddings (B, T_enc, d_model).
Encoder layers are non-causal self-attention + GeLU MLP; decoder layers
are causal self-attention + cross-attention to the encoder output + GeLU
MLP (RoPE in place of whisper's learned positions, as in ``repro``).

``loss_fn_encdec`` is the decoder's next-token cross-entropy, as
``repro``'s; with ``cfg.remat`` and grad enabled each encoder and decoder
layer is checkpointed (``transformer.remat``), as ``repro`` wraps both
bodies in ``jax.checkpoint``.

Every attention core of prefill is the flash-attention kernel (B10): the
encoder's over S = T frames unmasked, the decoder's causal, and the
cross-attention's over the T encoder frames (T != S).  Decode stays plain
torch on raw caches, as ``repro``'s is XLA on raw caches: its compressed
step is the decoder-only one, so there is no compressed encoder-decoder
decode (``serving.kvcache.make_compressed_decode_step`` refuses one).

Parameters and caches keep ``repro``'s tree: ``{"embed", "enc", "dec",
"enc_norm", "final_norm"}`` with each encoder and decoder leaf stacked over
its layers, and the cache ``{"k", "v", "xk", "xv"}`` stacked over the
decoder layers (self-attention (L, B, max_len, G, hd), cross (L, B, T_enc,
G, hd)), so both cross packages leaf by leaf
(``interop.lm_params_from_numpy``, ``lm_cache_from_numpy``).  The layer
loop runs over views of the stacked tensors; prefill writes the cache and
decode its self-attention entry at ``pos`` in place.  Decode takes ``pos``
as a host int or a 0-d int32 tensor on the card, so the step is one CUDA
graph when captured (``serving.CapturedDecodeStep``).
"""
from __future__ import annotations

import torch

from ..core.devices import resolve_device
from . import attention as A
from . import transformer as T
from .config import ModelConfig
from .layers import dense_init, rms_norm
from .mlp import init_mlp_params, mlp

__all__ = ["init_encdec_params", "encdec_train", "encdec_prefill",
           "encdec_decode", "init_encdec_cache", "loss_fn_encdec",
           "decode_pos", "check_decode_pos", "state_leaves"]


def _init_enc_layer(gen, cfg: ModelConfig, dtype, device, lead) -> dict:
    def zeros():
        return torch.zeros(lead + (cfg.d_model,), dtype=torch.float32,
                           device=device)
    return {"ln1": zeros(),
            "attn": A.init_attn_params(gen, cfg, dtype, device, lead),
            "ln2": zeros(),
            "mlp": init_mlp_params(gen, cfg.d_model, cfg.d_ff, cfg.act,
                                   dtype, device, lead)}


def _init_dec_layer(gen, cfg: ModelConfig, dtype, device, lead) -> dict:
    prm = _init_enc_layer(gen, cfg, dtype, device, lead)
    prm["lnx"] = torch.zeros(lead + (cfg.d_model,), dtype=torch.float32,
                             device=device)
    prm["xattn"] = A.init_attn_params(gen, cfg, dtype, device, lead)
    return prm


def init_encdec_params(cfg: ModelConfig, gen=0, dtype=torch.bfloat16,
                       device=None) -> dict:
    """Random weights on ``device`` (default ``cuda:0``), drawn from
    ``gen``: a ``torch.Generator`` on that device, or an int seed for
    one.  On ``torch.device("meta")`` only the shapes are built."""
    dev = resolve_device(device)
    if dev.type == "meta":
        gen = None
    elif not isinstance(gen, torch.Generator):
        gen = torch.Generator(device=dev).manual_seed(int(gen))
    return {
        "embed": dense_init(gen, (cfg.vocab, cfg.d_model), 1, dtype, dev),
        "enc": _init_enc_layer(gen, cfg, dtype, dev,
                               (cfg.encoder.n_layers,)),
        "dec": _init_dec_layer(gen, cfg, dtype, dev, (cfg.n_layers,)),
        "enc_norm": torch.zeros((cfg.d_model,), dtype=torch.float32,
                                device=dev),
        "final_norm": torch.zeros((cfg.d_model,), dtype=torch.float32,
                                  device=dev),
    }


def _encode(cfg: ModelConfig, params, frames):
    positions = torch.arange(frames.shape[1], device=frames.device)

    def layer(x, prm):
        h = rms_norm(x, prm["ln1"], cfg.norm_eps)
        mix, _ = A.attention_full(h, prm["attn"], cfg, positions,
                                  causal=False)
        x = x + mix
        h = rms_norm(x, prm["ln2"], cfg.norm_eps)
        return x + mlp(h, prm["mlp"], cfg.act)

    body = T.remat(cfg, layer)
    x = frames
    for prm in T.unstack(params["enc"], cfg.encoder.n_layers):
        x = body(x, prm)
    return rms_norm(x, params["enc_norm"], cfg.norm_eps)


def _dec_layer_full(cfg: ModelConfig, x, prm, positions, enc_out, cache):
    """One decoder layer over the whole prompt; with ``cache`` (this
    layer's views, or None) its self-attention k/v are written from slot
    0 and its cross k/v whole."""
    h = rms_norm(x, prm["ln1"], cfg.norm_eps)
    mix, (k, v) = A.attention_full(h, prm["attn"], cfg, positions)
    x = x + mix
    h = rms_norm(x, prm["lnx"], cfg.norm_eps)
    xmix, (xk, xv) = A.attention_cross(h, prm["xattn"], cfg, kv_src=enc_out)
    x = x + xmix
    h = rms_norm(x, prm["ln2"], cfg.norm_eps)
    x = x + mlp(h, prm["mlp"], cfg.act)
    if cache is not None:
        A.update_cache(cache["k"], cache["v"], k, v, 0)
        cache["xk"].copy_(xk)
        cache["xv"].copy_(xv)
    return x


def _embed(cfg: ModelConfig, params, tokens):
    # the constant is rounded to bf16 whatever the weights' dtype, as
    # repro's jnp.asarray(d ** 0.5, bfloat16) is (on the host: a device
    # tensor made from a host value would sync)
    scale = torch.tensor(cfg.d_model ** 0.5, dtype=torch.bfloat16).item()
    return params["embed"][tokens] * scale


def _logits(cfg: ModelConfig, params, x):
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return (x @ params["embed"].T).to(torch.float32)


def _decoder(cfg: ModelConfig, params, frames, tokens, cache):
    """The decoder's output over ``tokens``; with no ``cache`` (training)
    each layer is checkpointed under ``cfg.remat``, as ``repro``'s
    decoder body and encoder body are."""
    enc_out = _encode(cfg, params, frames)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    x = _embed(cfg, params, tokens)
    if cache is None:
        body = T.remat(cfg, lambda x, prm: _dec_layer_full(
            cfg, x, prm, positions, enc_out, None))
        for prm in T.unstack(params["dec"], cfg.n_layers):
            x = body(x, prm)
        return x
    for li in range(cfg.n_layers):
        x = _dec_layer_full(cfg, x, T._index(params["dec"], li), positions,
                            enc_out, T._index(cache, li))
    return x


def encdec_train(cfg: ModelConfig, params, frames, tokens):
    """frames (B, T_enc, d), tokens (B, S_dec) -> logits (B, S_dec, V)
    f32; encoder and decoder layers checkpointed under ``cfg.remat``."""
    return _logits(cfg, params, _decoder(cfg, params, frames, tokens, None))


def loss_fn_encdec(cfg: ModelConfig, params, frames, tokens):
    """Next-token cross-entropy of the decoder (mean over B*(S_dec-1)
    targets)."""
    return T.next_token_nll(encdec_train(cfg, params, frames, tokens),
                            tokens)


def encdec_prefill(cfg: ModelConfig, params, frames, tokens,
                   max_len: int | None = None):
    """frames (B, T_enc, d), tokens (B, S) -> (last-position logits (B,
    V), cache with room for ``max_len`` decoder positions and the
    encoder's T_enc cross slots)."""
    B, S = tokens.shape
    cache = init_encdec_cache(cfg, B, max_len or S, frames.shape[1],
                              params["embed"].dtype, tokens.device)
    x = _decoder(cfg, params, frames, tokens, cache)
    return _logits(cfg, params, x[:, -1, :]), cache


def init_encdec_cache(cfg: ModelConfig, batch: int, max_len: int,
                      n_frames: int, dtype=torch.bfloat16,
                      device=None) -> dict:
    """Zero cache: self-attention k/v (L, B, max_len, G, hd) and cross
    xk/xv (L, B, n_frames, G, hd); ``device=None`` means ``cuda:0``."""
    self_kv = A.init_cache(cfg, batch, max_len, cfg.n_layers, dtype, device)
    cross = A.init_cache(cfg, batch, n_frames, cfg.n_layers, dtype, device)
    return {"k": self_kv["k"], "v": self_kv["v"], "xk": cross["k"],
            "xv": cross["v"]}


def check_decode_pos(cfg: ModelConfig, cache, pos: int) -> int:
    """A host int ``pos`` range-checked against the self-attention cache
    (the cross slots are read whole at any pos)."""
    if isinstance(pos, bool) or int(pos) != pos or pos < 0:
        raise ValueError(f"encdec_decode: pos must be an int >= 0, got "
                         f"{pos!r}")
    T = cache["k"].shape[2]
    if pos >= T:
        raise ValueError(f"encdec_decode: 1 entry at {pos} do not fit a "
                         f"cache of {T}")
    return int(pos)


def decode_pos(cfg: ModelConfig, cache, pos, device) -> torch.Tensor:
    """``pos`` as every decoder layer takes it: a 0-d int32 tensor on
    ``device`` (a host int checked, a tensor taken as
    ``transformer.decode_pos`` takes it, unread)."""
    if not isinstance(pos, torch.Tensor):
        pos = torch.full((), check_decode_pos(cfg, cache, pos),
                         dtype=torch.int32, device=device)
    return T.decode_pos(cfg, cache, pos, device)


def state_leaves(cfg: ModelConfig, cache) -> list[torch.Tensor]:
    """None: the cache holds no recurrent state (decode writes a
    self-attention entry at pos, the same values however often it runs;
    the cross slots never)."""
    return []


def encdec_decode(cfg: ModelConfig, params, token, cache, pos):
    """token (B, 1) + cache -> (logits (B, V), cache), the self-attention
    entries written at ``pos`` (a host int or a 0-d int32 tensor on the
    token's device) in place."""
    pos = decode_pos(cfg, cache, pos, token.device)
    x = _embed(cfg, params, token)
    for li in range(cfg.n_layers):
        prm, c = T._index(params["dec"], li), T._index(cache, li)
        h = rms_norm(x, prm["ln1"], cfg.norm_eps)
        mix, _, _ = A.attention_decode(h, prm["attn"], cfg, c["k"], c["v"],
                                       pos)
        x = x + mix
        h = rms_norm(x, prm["lnx"], cfg.norm_eps)
        xmix, _ = A.attention_cross(h, prm["xattn"], cfg,
                                    kv_cache=(c["xk"], c["xv"]))
        x = x + xmix
        h = rms_norm(x, prm["ln2"], cfg.norm_eps)
        x = x + mlp(h, prm["mlp"], cfg.act)
    return _logits(cfg, params, x[:, 0, :]), cache
