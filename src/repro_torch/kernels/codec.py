"""The fused pwrel codec kernels over a wave's plane stack.

``encode_planes`` (quantize + pack, replacing the TPU kernels
``repro/kernels/quantize.py::quantize_tiles`` and
``repro/kernels/pack.py::pack_codes_tiles``) and ``decode_planes`` (unpack
+ dequantize, replacing ``pack.py::unpack_codes_tiles`` and
``quantize.py::dequantize_tiles``) run over every block plane of an
(R, 2, N) f32 stack in one launch each.  On a CUDA tensor they launch the
hand-written kernels in ``csrc/codec.cu`` (see the note there for what
bounds them); on a CPU tensor they run the plain versions
:func:`~repro_torch.kernels.ref.encode_planes_ref` and
:func:`~repro_torch.kernels.ref.decode_planes_ref`.  Any other device
raises — there is no fallback from the kernel.

:data:`launch_counts` counts each kernel's launches (CPU calls do not
count), so a run can show that its main path went through the kernels.
The TPU-layout wrappers in :mod:`.quantize` launch the same two kernels
and count here too.
"""
from __future__ import annotations

import ctypes

import torch

from . import build
from .ref import decode_planes_ref, encode_planes_ref, tile_rows_for

__all__ = ["encode_planes", "decode_planes", "plane_l_max",
           "launch_counts", "reset_launch_counts"]

#: kernel name -> launches since the last reset
launch_counts: dict[str, int] = {"encode": 0, "decode": 0}

_LANES = 128
_fns = None    # (encode, decode, error string), bound at first CUDA call


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _kernels():
    global _fns
    if _fns is None:
        lib = build.load("codec")
        p, i64, i32, f32 = (ctypes.c_void_p, ctypes.c_longlong,
                            ctypes.c_int, ctypes.c_float)
        enc = lib.codec_encode_f32
        enc.argtypes = [p, i64, i64, i64, i64, i64, p, f32, p, i32, p, p,
                        i64, i64, p]
        enc.restype = i32
        dec = lib.codec_decode_f32
        dec.argtypes = [p, i32, p, p, f32, p, i64, i64, p, i64, i64, i64,
                        i64, p]
        dec.restype = i32
        err = lib.codec_error_string
        err.argtypes = [i32]
        err.restype = ctypes.c_char_p
        _fns = (enc, dec, err)
    return _fns


def _check(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           f"{_kernels()[2](rc).decode()} (cudaError {rc})")


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _need(t: torch.Tensor, dtype, name: str) -> None:
    if t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"{name}: want a contiguous {dtype} tensor, got "
                         f"{t.dtype} with strides {t.stride()}")


def _cuda_device(tensors, name: str) -> torch.device | None:
    """The tensors' one device: None for the CPU, a CUDA device, or raise."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"{name}: operands on {devs}")
    dev = devs.pop()
    if dev.type == "cpu":
        return None
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")
    return dev


def launch_encode(x: torch.Tensor, geo: tuple[int, int, int, int],
                  planes: int, l_max: torch.Tensor, step: float,
                  codes: torch.Tensor, signs: torch.Tensor,
                  flags: torch.Tensor | None, tile_elems: int = 0) -> None:
    """Launch the encode kernel (CUDA tensors only).  ``geo`` is
    (row stride, component stride, n, blocks per row) of ``x``'s stack in
    elements; ``codes`` is int16 (u16 codes) or int32."""
    enc = _kernels()[0]
    dev = x.device
    code_bytes = codes.element_size()
    n_tiles = 0 if flags is None else flags.shape[-2]
    with torch.cuda.device(dev):
        rc = enc(x.data_ptr(), *geo, planes, l_max.data_ptr(), step,
                 codes.data_ptr(), code_bytes, signs.data_ptr(),
                 None if flags is None else flags.data_ptr(), tile_elems,
                 n_tiles, _stream(dev))
    _check("encode", rc)
    launch_counts["encode"] += 1


def launch_decode(codes: torch.Tensor, signs: torch.Tensor,
                  l_max: torch.Tensor, step: float,
                  plane_map: torch.Tensor | None, planes: int,
                  stack_planes: int, out: torch.Tensor,
                  geo: tuple[int, int, int, int]) -> None:
    """Launch the decode kernel (CUDA tensors only) of ``planes`` wire
    planes into the ``stack_planes`` planes of ``out``; see
    :func:`launch_encode` for ``geo``."""
    dec = _kernels()[1]
    dev = out.device
    with torch.cuda.device(dev):
        rc = dec(codes.data_ptr(), codes.element_size(), signs.data_ptr(),
                 l_max.data_ptr(), step,
                 None if plane_map is None else plane_map.data_ptr(),
                 planes, stack_planes, out.data_ptr(), *geo, _stream(dev))
    _check("decode", rc)
    launch_counts["decode"] += 1


def _geometry(stack: torch.Tensor, n: int, name: str):
    """(geo, planes) of an (R, 2, N) f32 stack holding blocks of ``n``."""
    if stack.dim() != 3 or stack.shape[1] != 2 or n <= 0 \
            or stack.shape[2] % n:
        raise ValueError(f"{name}: {tuple(stack.shape)} is not an (R, 2, N) "
                         f"stack of blocks of {n}")
    if stack.dtype != torch.float32 or stack.stride(2) != 1:
        raise ValueError(f"{name}: want f32 planes with unit element "
                         f"stride, got {stack.dtype} {stack.stride()}")
    R, _, N = stack.shape
    nb = N // n
    return (stack.stride(0), stack.stride(1), n, nb), 2 * R * nb


def plane_l_max(planes: torch.Tensor, n: int) -> torch.Tensor:
    """The encode's prologue: per block plane of an (R, 2, N) stack,
    ``log2(max|x|)`` (0 for an all-zero plane), as (P,) f32 in the
    kernels' plane order.  Plain torch, as the reference computes it in
    XLA outside its kernels; ``max|x|`` comes from one min/max pass."""
    R, _, N = planes.shape
    lo, hi = torch.aminmax(planes.reshape(R, 2, N // n, n), dim=-1)
    m = torch.maximum(hi, -lo).transpose(1, 2).reshape(-1)
    return torch.where(m > 0, torch.log2(torch.clamp(m, min=1e-45)),
                       torch.zeros_like(m))


def encode_planes(planes: torch.Tensor, n: int, l_max: torch.Tensor,
                  step: float, *, flags_tile_rows: int | None = None):
    """Fused quantize + pack of every block plane of an (R, 2, N) f32
    stack of blocks of ``n``, in one launch.

    Returns ``(codes (P, n) int16 [u16 bits], sign words (P, ceil(n/32))
    int32, flags (P, T, 3) int32 or None)`` with P = 2·R·N/n planes in the
    order of :func:`~repro_torch.kernels.ref.encode_planes_ref`; flags
    (those of ``quantize_tiles`` with ``tile_rows=flags_tile_rows``) only
    when asked for.  Queued on the current stream; never blocks.
    """
    geo, P = _geometry(planes, n, "encode_planes")
    dev = _cuda_device((planes, l_max), "encode_planes")
    if dev is None:
        return encode_planes_ref(planes, n, l_max, step, flags_tile_rows)
    _need(l_max, torch.float32, "encode_planes l_max")
    if l_max.numel() != P:
        raise ValueError(f"encode_planes: {l_max.numel()} l_max for {P} "
                         "planes")
    codes = torch.empty((P, n), dtype=torch.int16, device=dev)
    signs = torch.empty((P, -(-n // 32)), dtype=torch.int32, device=dev)
    flags, tile_elems = None, 0
    if flags_tile_rows is not None:
        rows = -(-n // _LANES)
        tr = tile_rows_for(rows, flags_tile_rows)
        flags = torch.ones((P, rows // tr, 3), dtype=torch.int32, device=dev)
        tile_elems = tr * _LANES
    launch_encode(planes, geo, P, l_max, step, codes, signs, flags,
                  tile_elems)
    return codes, signs, flags


def decode_planes(codes: torch.Tensor, signs: torch.Tensor,
                  l_max: torch.Tensor, step: float, out: torch.Tensor,
                  n: int, plane_map: torch.Tensor | None = None):
    """Fused unpack + dequantize of P wire planes into the (R, 2, N) f32
    stack ``out``, in one launch: wire plane ``j`` lands on stack plane
    ``plane_map[j]`` (default ``j``; the kernel writes nothing for an
    entry outside the stack, where the plain version raises).  ``codes`` (P, n) int16 [u16 bits],
    ``signs`` (P, ceil(n/32)) int32, ``l_max`` (P,) f32.  Returns ``out``;
    queued on the current stream, never blocks."""
    geo, P_stack = _geometry(out, n, "decode_planes")
    P = codes.shape[0]
    if (codes.shape != (P, n) or signs.shape != (P, -(-n // 32))
            or l_max.numel() != P):
        raise ValueError(f"decode_planes: codes {tuple(codes.shape)}, signs "
                         f"{tuple(signs.shape)}, l_max {tuple(l_max.shape)} "
                         f"are not P wire planes of {n}")
    if (P != P_stack if plane_map is None else plane_map.shape != (P,)):
        raise ValueError(f"decode_planes: {P} wire planes for a stack of "
                         f"{P_stack} planes, plane map "
                         f"{None if plane_map is None else tuple(plane_map.shape)}")
    ops = (codes, signs, l_max, out) + (() if plane_map is None
                                        else (plane_map,))
    dev = _cuda_device(ops, "decode_planes")
    if dev is None:
        return decode_planes_ref(codes, signs, l_max, step, out, n,
                                 plane_map)
    _need(codes, torch.int16, "decode_planes codes")
    _need(signs, torch.int32, "decode_planes signs")
    _need(l_max, torch.float32, "decode_planes l_max")
    if plane_map is not None:
        _need(plane_map, torch.int32, "decode_planes plane_map")
    launch_decode(codes, signs, l_max, step, plane_map, P, P_stack, out, geo)
    return out
