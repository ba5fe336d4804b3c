"""Assigned-architecture registry: ``get_config(arch_id)``.

Each ``<id>.py`` holds the exact published configuration; ``reduced_config``
shrinks any of them (same family/pattern, tiny dims) for CPU smoke tests.
"""
from __future__ import annotations

from dataclasses import replace
from importlib import import_module

from ..models.config import EncoderConfig, ModelConfig, MoEConfig

ARCH_IDS = [
    "gemma3_12b", "qwen15_32b", "granite_20b", "qwen3_4b",
    "llama32_vision_90b", "arctic_480b", "mixtral_8x22b",
    "recurrentgemma_2b", "xlstm_125m", "whisper_large_v3",
]

# canonical dashed ids from the assignment -> module names
ALIASES = {
    "gemma3-12b": "gemma3_12b",
    "qwen1.5-32b": "qwen15_32b",
    "granite-20b": "granite_20b",
    "qwen3-4b": "qwen3_4b",
    "llama-3.2-vision-90b": "llama32_vision_90b",
    "arctic-480b": "arctic_480b",
    "mixtral-8x22b": "mixtral_8x22b",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "xlstm-125m": "xlstm_125m",
    "whisper-large-v3": "whisper_large_v3",
}


def get_config(arch: str) -> ModelConfig:
    mod = ALIASES.get(arch, arch).replace("-", "_").replace(".", "_")
    return import_module(f"{__name__}.{mod}").CONFIG


def reduced_config(cfg: ModelConfig) -> ModelConfig:
    """Family-preserving tiny config for CPU smoke tests."""
    pat = cfg.pattern
    kw = dict(
        n_layers=len(pat) * 2 + (1 if cfg.n_remainder else 0),
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads > 1 else 1,
        d_ff=cfg.d_ff and 128,
        vocab=256,
        head_dim=16,
        sliding_window=min(cfg.sliding_window, 8) if cfg.sliding_window else 0,
        rglru_width=64 if cfg.rglru_width else 0,
        n_image_tokens=8,
        remat=False,
    )
    if cfg.moe is not None:
        # capacity_factor 8 => provably drop-free at smoke scale, so
        # prefill/decode logits match the train path exactly (production
        # keeps 1.25 and accepts capacity-drop jitter — FLOPs honesty)
        kw["moe"] = replace(cfg.moe, n_experts=4, capacity_factor=8.0,
                            dense_d_ff=128 if cfg.moe.dense_residual else 0)
    if cfg.encoder is not None:
        kw["encoder"] = EncoderConfig(n_layers=2, n_frames=16, dec_len=12)
    if cfg.family == "ssm":
        kw["d_ff"] = 0
        kw["n_kv_heads"] = 4
        kw["head_dim"] = 0
    return replace(cfg, **kw)
