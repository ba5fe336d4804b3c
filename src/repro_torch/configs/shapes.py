"""Assigned input shapes x applicability + abstract input specs.

The port of ``repro/configs/shapes.py``.  40 cells = 10 archs x 4 shapes;
``long_500k`` runs only for sub-quadratic archs (SSM / hybrid / SWA /
mostly-local) and whisper has no 512k decode (decoder context is
architecturally bounded).

``input_specs`` returns tensors on the ``meta`` device only (the dry run
never allocates): the same shapes and dtypes as ``repro``'s
``jax.ShapeDtypeStruct``s, a decode cell's cache built by the port's own
``init_decode_cache`` / ``init_encdec_cache`` on ``meta``; ``step_kind``
says which step the cell runs.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..models import encdec, transformer
from ..models.config import ModelConfig

__all__ = ["SHAPES", "ShapeSpec", "step_kind", "cell_is_applicable",
           "skip_reason", "input_specs", "all_cells", "META"]

META = torch.device("meta")


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}

# archs with a sub-quadratic (or bounded-window) path for 512k decode
_LONG_OK = {"gemma3-12b", "mixtral-8x22b", "recurrentgemma-2b", "xlstm-125m"}


def step_kind(shape: str) -> str:
    return SHAPES[shape].kind


def cell_is_applicable(cfg: ModelConfig, shape: str) -> bool:
    if shape == "long_500k":
        return cfg.name in _LONG_OK
    return True


def skip_reason(cfg: ModelConfig, shape: str) -> str:
    if shape == "long_500k" and cfg.name not in _LONG_OK:
        if cfg.family == "audio":
            return "enc-dec decoder context architecturally bounded (<=448)"
        return "pure full attention: 512k decode needs sub-quadratic path"
    return ""


def all_cells():
    """Yield (arch_id, shape_name) for all 40 assigned cells (incl. skips)."""
    from . import ALIASES
    for arch in ALIASES:
        for shape in SHAPES:
            yield arch, shape


def _tok(shape, dtype=torch.int32):
    return torch.empty(shape, dtype=dtype, device=META)


def input_specs(cfg: ModelConfig, shape: str) -> dict:
    """Abstract model inputs for one cell (see launch/dryrun.py for use)."""
    sp = SHAPES[shape]
    B, S = sp.global_batch, sp.seq_len
    d = cfg.d_model

    if cfg.family == "audio":
        enc = cfg.encoder
        if sp.kind in ("train", "prefill"):
            return {"frames": _tok((B, S // 4, d), torch.bfloat16),
                    "tokens": _tok((B, enc.dec_len))}
        # decode: self cache of length S (mechanical capability check)
        cache = encdec.init_encdec_cache(cfg, B, S, enc.n_frames,
                                         device=META)
        return {"token": _tok((B, 1)), "cache": cache, "pos": _tok(())}

    aux = None
    if cfg.family == "vlm":
        aux = _tok((B, cfg.n_image_tokens, d), torch.bfloat16)

    if sp.kind in ("train", "prefill"):
        spec = {"tokens": _tok((B, S))}
        if aux is not None:
            spec["aux"] = aux
        return spec
    # decode
    cache = transformer.init_decode_cache(cfg, B, S, device=META)
    spec = {"token": _tok((B, 1)), "cache": cache, "pos": _tok(())}
    if aux is not None:
        spec["aux"] = aux
    return spec
