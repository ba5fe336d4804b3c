"""Compression subsystem (paper §4.3/§4.4).

Layering:

* ``pwrel``        — the lossy quantizer math (torch f32).
* ``lossless``     — the host-only lossless stage (zlib + bitmap pre-scan).
* ``segments``     — the structured compressed-block container + wire layout.
* ``codec``        — host composition of the two stages (block <-> bytes).
* ``store``        — the two-level (RAM/disk) block store.

The device-resident lossy half (``device_codec``) is not ported yet.
"""
from .pwrel import PwRelParams, quantize_plane, dequantize_plane  # noqa: F401
from .codec import (  # noqa: F401
    CompressedBlock, compress_complex_block, decompress_complex_block,
    encode_block_host, decode_block_host,
)
from .segments import BlockSegments, PlaneSegments  # noqa: F401
from .lossless import (  # noqa: F401
    prescan_encode_bitmap, prescan_decode_bitmap,
)
from .store import BlockStore  # noqa: F401
