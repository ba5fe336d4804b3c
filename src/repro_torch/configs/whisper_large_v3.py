"""whisper-large-v3 [audio]: enc-dec, 32+32L, conv frontend stubbed.

[arXiv:2212.04356; unverified]  input_specs feeds precomputed frame
embeddings; decoder positions use RoPE (deviation noted in DESIGN.md).
"""
from ..models.config import ModelConfig, EncoderConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family="audio",
    n_layers=32,                      # decoder layers
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    d_ff=5120,
    vocab=51866,
    head_dim=64,
    act="gelu",
    encoder=EncoderConfig(n_layers=32, n_frames=1500, dec_len=512),
)
