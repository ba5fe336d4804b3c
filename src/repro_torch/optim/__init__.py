from .adamw import AdamW, Adafactor, make_optimizer  # noqa: F401
from .grad_compress import GradCompressor  # noqa: F401
