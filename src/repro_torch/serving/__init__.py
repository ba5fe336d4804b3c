from .step import (  # noqa: F401
    make_prefill_step, make_decode_step, CapturedDecodeStep, warm_up,
)
from .kvcache import (  # noqa: F401
    quantize_kv, dequantize_kv, make_compressed_decode_step,
)
