"""llama-3.2-vision-90b [vlm]: 100L, cross-attn image layers every 5th.

Vision frontend is a STUB: input_specs provides precomputed patch
embeddings (B, n_image_tokens, d_model).  [hf:meta-llama/Llama-3.2-11B-
Vision scaled per assignment; unverified]
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    n_layers=100,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab=128256,
    head_dim=128,
    rope_theta=500_000.0,
    pattern=("attn",) * 4 + ("cross_attn",),
    n_image_tokens=576,
    tie_embeddings=False,
)
