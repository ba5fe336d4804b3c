"""gemma3-12b [dense]: 48L, 5:1 local:global attention, GQA kv=8.

[hf:google/gemma-3-1b-pt scaled per assignment; unverified]
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-12b",
    family="dense",
    n_layers=48,
    d_model=3840,
    n_heads=16,
    n_kv_heads=8,
    d_ff=15360,
    vocab=262144,
    head_dim=256,
    qk_norm=True,
    rope_theta=1_000_000.0,
    sliding_window=1024,
    pattern=("attn_local",) * 5 + ("attn",),   # 5 local : 1 global
    logits_softcap=30.0,
)
