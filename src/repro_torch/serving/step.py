"""Serve-step factories: prefill (full prompt -> cache) and decode (1 tok).

The port of ``repro/serving/step.py`` for decoder-only models; the
encoder-decoder (``"audio"``) family is not ported yet (ROADMAP A12e).
"""
from __future__ import annotations

from ..models import transformer as T
from ..models.config import ModelConfig

__all__ = ["make_prefill_step", "make_decode_step"]


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family == "audio":
        raise NotImplementedError(
            f"{cfg.name}: the encoder-decoder serving steps are not ported "
            "yet (ROADMAP A12e)")


def make_prefill_step(cfg: ModelConfig, max_len: int | None = None):
    _check_family(cfg)

    def prefill(params, batch):
        return T.forward_prefill(cfg, params, batch["tokens"],
                                 batch.get("aux"), max_len=max_len)
    return prefill


def make_decode_step(cfg: ModelConfig):
    _check_family(cfg)

    def decode(params, batch):
        return T.forward_decode(cfg, params, batch["token"], batch["cache"],
                                batch["pos"], batch.get("aux"))
    return decode
