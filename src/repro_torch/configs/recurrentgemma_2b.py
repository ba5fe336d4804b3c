"""recurrentgemma-2b [hybrid]: 26L, RG-LRU + local attention, 1:2 ratio.

[arXiv:2402.19427; hf]  Pattern (rglru, rglru, attn_local); 26 = 8*3 + 2,
the remainder unrolls the first two pattern positions.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    d_ff=7680,
    vocab=256000,
    head_dim=256,
    sliding_window=2048,
    pattern=("rglru", "rglru", "attn_local"),
    rglru_width=2560,
)
