"""LM model framework: configs, layers, the decoder-only assembly."""
from .config import EncoderConfig, ModelConfig, MoEConfig  # noqa: F401
