"""Serve-step factories: prefill (full prompt -> cache) and decode (1 tok),
and the decode step captured as one CUDA graph.

The port of ``repro/serving/step.py``: decoder-only models (attention,
cross-attention, MoE and recurrent layers) through ``models/transformer``,
the encoder-decoder (``"audio"``) family through ``models/encdec``.

``repro`` runs a decode step as one compiled program: ``jax.jit`` over
``forward_decode`` with ``pos`` traced (``examples/serve_lm.py``).  Its
analogue here is :class:`CapturedDecodeStep`: the step's kernels recorded
once into a ``torch.cuda.CUDAGraph`` and replayed, so a step costs one
launch on the host instead of thousands of eager ones.  It captures what
``make_decode_step`` / ``make_compressed_decode_step`` return: the cache
(attention entries and recurrent states) is written in place, and ``pos``
is one 0-d int32 tensor on the card that every layer reads on the device
(``transformer.forward_decode``), so a replay is the eager step, kernel
for kernel, and replay n reads the states replay n-1 wrote.
"""
from __future__ import annotations

import torch

from ..kernels import flash_attention, kv_dequant_attention
from ..models import encdec as E
from ..models import transformer as T
from ..models.config import ModelConfig

__all__ = ["make_prefill_step", "make_decode_step", "CapturedDecodeStep",
           "warm_up"]

#: the kernel modules whose launch counts a captured step accounts for
_KERNEL_MODULES = (flash_attention, kv_dequant_attention)


def _model(cfg: ModelConfig):
    """The module that runs ``cfg``'s decode: its pos checks and states."""
    return E if cfg.family == "audio" else T


def make_prefill_step(cfg: ModelConfig, max_len: int | None = None):
    if cfg.family == "audio":
        def prefill(params, batch):
            return E.encdec_prefill(cfg, params, batch["frames"],
                                    batch["tokens"], max_len=max_len)
    else:
        def prefill(params, batch):
            return T.forward_prefill(cfg, params, batch["tokens"],
                                     batch.get("aux"), max_len=max_len)
    return prefill


def make_decode_step(cfg: ModelConfig):
    if cfg.family == "audio":
        def decode(params, batch):
            return E.encdec_decode(cfg, params, batch["token"],
                                   batch["cache"], batch["pos"])
    else:
        def decode(params, batch):
            return T.forward_decode(cfg, params, batch["token"],
                                    batch["cache"], batch["pos"],
                                    batch.get("aux"))
    return decode


def _counts() -> dict[str, int]:
    return {k: v for m in _KERNEL_MODULES for k, v in m.launch_counts.items()}


def _set_counts(counts: dict[str, int]) -> None:
    for m in _KERNEL_MODULES:
        for k in m.launch_counts:
            m.launch_counts[k] = counts[k]


def warm_up(cfg: ModelConfig, decode, params, batch) -> None:
    """Run the decode step once (which builds its kernels, sizes their
    grids and sets their attributes) and put back the recurrent states it
    advanced (``transformer.state_leaves``; an encoder-decoder cache has
    none): the attention entries it wrote are the ones the next run of the
    step writes again."""
    states = _model(cfg).state_leaves(cfg, batch["cache"])
    saved = [t.clone() for t in states]
    decode(params, batch)
    for t, old in zip(states, saved):
        t.copy_(old)


class CapturedDecodeStep:
    """A decode step (``make_decode_step(cfg)`` or
    ``make_compressed_decode_step(cfg)``'s function; an encoder-decoder's
    ``encdec_decode`` too) over ``params`` and the CUDA ``cache`` it
    writes in place, captured as one CUDA graph.

    ``step(token, pos)`` -> logits (B, V): ``token`` a (B, 1) int64 tensor
    on the card, ``pos`` a host int or a 0-d int32 tensor there.  The first
    call warms up (the step once, eagerly, on a side stream: it builds the
    kernels, sizes their grids and sets their attributes, so the capture
    holds launches only) and captures; every call copies the token into
    the graph's static input, fills its ``pos`` and replays.  The warm-up
    writes that first step's attention entries, which its replay writes
    again with the same values; the recurrent states it advances
    (``transformer.state_leaves``) are put back as they were before the
    capture, so the first replay advances them once.  The first call must
    be the step that is due (:meth:`capture` may be called ahead with the
    same token and pos).
    The returned logits are the graph's static output, overwritten by the
    next call.  A capture that meets a host sync raises (there is no eager
    fallback).

    The kernels' Python ``launch_counts`` move only for the warm-up (the
    capture's calls record, they do not launch, and are taken back out);
    :meth:`launches` gives what the replays launched: the launches the
    capture recorded times the replays.
    """

    def __init__(self, cfg: ModelConfig, decode, params, cache):
        self.cfg, self._decode = cfg, decode
        self._params, self._cache = params, cache
        self.graph: torch.cuda.CUDAGraph | None = None
        self.recorded: dict[str, int] = {}
        self.replays = 0

    def capture(self, token: torch.Tensor, pos) -> None:
        if token.device.type != "cuda":
            raise ValueError(f"CapturedDecodeStep: a CUDA graph needs the "
                             f"step on a CUDA device, not {token.device}")
        dev = token.device
        self._token = token.clone()
        self._pos = _model(self.cfg).decode_pos(self.cfg, self._cache, pos,
                                                dev).clone()
        batch = {"token": self._token, "cache": self._cache,
                 "pos": self._pos}
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            warm_up(self.cfg, self._decode, self._params, batch)
        torch.cuda.current_stream(dev).wait_stream(stream)
        before = _counts()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, stream=stream):
            self.logits, _ = self._decode(self._params, batch)
        after = _counts()
        self.recorded = {k: after[k] - before[k] for k in after}
        _set_counts(before)

    def __call__(self, token: torch.Tensor, pos) -> torch.Tensor:
        if self.graph is None:
            self.capture(token, pos)
        self._token.copy_(token)
        if isinstance(pos, torch.Tensor):
            self._pos.copy_(pos)
        else:
            self._pos.fill_(_model(self.cfg).check_decode_pos(
                self.cfg, self._cache, pos))
        self.graph.replay()
        self.replays += 1
        return self.logits

    def launches(self) -> dict[str, int]:
        """Kernel launches of the replays so far, by kernel name."""
        return {k: n * self.replays for k, n in self.recorded.items()}
