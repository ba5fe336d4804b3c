"""xlstm-125m [ssm]: 12L alternating mLSTM / sLSTM blocks, d_ff=0.

[arXiv:2405.04517; unverified]  Block-internal projections replace the
FFN (d_ff=0 per assignment).
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m",
    family="ssm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab=50304,
    pattern=("mlstm", "slstm"),
)
