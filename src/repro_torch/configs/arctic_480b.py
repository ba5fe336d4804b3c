"""arctic-480b [moe]: 35L, 128 experts top-2 + dense residual branch.

[hf:Snowflake/snowflake-arctic-base; hf]
"""
from ..models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=4864,
    vocab=32000,
    head_dim=128,
    moe=MoEConfig(n_experts=128, top_k=2, dense_residual=True,
                  dense_d_ff=4864),
    # even bf16 Adam moments overflow a 256-chip pod (21.3 GiB/dev measured
    # in the dry-run); factored second moments fit.  See EXPERIMENTS.md.
    optimizer="adafactor",
    opt_state_dtype="bfloat16",
)
