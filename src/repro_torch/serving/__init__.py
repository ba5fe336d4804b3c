from .step import make_prefill_step, make_decode_step  # noqa: F401
from .kvcache import (  # noqa: F401
    quantize_kv, dequantize_kv, make_compressed_decode_step,
)
