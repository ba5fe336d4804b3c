"""Plain PyTorch versions of the hand-written kernels.

Each function computes exactly what its kernel computes, with torch ops
on whatever device its inputs live on.  The kernel wrappers run these for
CPU tensors (the test suite's path), and ``chip_smoke.py`` holds every
kernel against its plain version on the card.

The gate functions mirror ``repro/kernels/ref.py`` and the Pallas bodies
of ``repro/kernels/gate_apply.py``: complex products on separate re/im
f32 planes, written as four real products.

The attention functions mirror the Pallas bodies of
``repro/kernels/flash_attention.py`` and
``repro/kernels/kv_dequant_attention.py`` (and ``tests/test_kernels_flash.py``'s
oracle): f32 scores scaled by hd^-0.5, masked to -2^30, softmax, P·V, all
in f32.  Their ``*_gqa_ref`` forms take the model's layout and broadcast
one kv head over its ``rep`` query heads without copying it.

The codec functions mirror ``repro/kernels/ref.py`` and the Pallas kernel
bodies of ``repro/kernels/quantize.py`` and ``repro/kernels/pack.py`` in
f32 (int32 codes, ``torch.round`` half to even).  Codes that cross the
boundary as u16 are held in int16 tensors carrying the u16 bits (torch has
no general uint16 arithmetic); sign words are int32 carrying the u32 bits.
"""
from __future__ import annotations

import torch

__all__ = ["gemm_planes_ref", "gemm_planes_batch_ref", "gemm_planes_mid_ref",
           "gemm_planes_mid_batch_ref",
           "diag_apply_ref", "quantize_tiles_ref", "dequantize_tiles_ref",
           "pack_codes_tiles_ref", "unpack_codes_tiles_ref",
           "pack_bitmap_tiles_ref", "unpack_bitmap_tiles_ref",
           "encode_planes_ref", "decode_planes_ref", "tile_rows_for",
           "flash_attention_ref", "flash_attention_gqa_ref",
           "kv_dequant_ref", "kv_dequant_decode_attention_ref",
           "kv_dequant_decode_attention_gqa_ref",
           "kv_dequant_decode_attention_tiled_ref", "kv_combine_ref",
           "NEG_INF", "KV_RANGE",
           "KV_STEP", "KV_CODE_MAX"]

CODE_MAX = 65535
_LANES = 128
_WORDS = _LANES // 32


def gemm_planes_ref(ar: torch.Tensor, ai: torch.Tensor, br: torch.Tensor,
                    bi: torch.Tensor):
    """(R, K) x (K, K) complex GEMM on re/im planes with one B = U^T for
    every row: ``Cr = Ar·Br − Ai·Bi``, ``Ci = Ar·Bi + Ai·Br``."""
    cr = ar @ br - ai @ bi
    ci = ar @ bi + ai @ br
    return cr.to(torch.float32), ci.to(torch.float32)


def gemm_planes_batch_ref(ar: torch.Tensor, ai: torch.Tensor,
                          br: torch.Tensor, bi: torch.Tensor):
    """(L, R, K) x (L, K, K) lane-batched complex GEMM on re/im planes:
    ``Cr = Ar·Br − Ai·Bi``, ``Ci = Ar·Bi + Ai·Br`` (four real products)."""
    cr = ar @ br - ai @ bi
    ci = ar @ bi + ai @ br
    return cr.to(torch.float32), ci.to(torch.float32)


def gemm_planes_mid_ref(ar: torch.Tensor, ai: torch.Tensor,
                        br: torch.Tensor, bi: torch.Tensor):
    """(O, K, I) batched left contraction ``C[o] = U·A[o]`` on re/im planes;
    ``br``/``bi`` are U's planes, not transposed."""
    cr = br @ ar - bi @ ai
    ci = br @ ai + bi @ ar
    return cr.to(torch.float32), ci.to(torch.float32)


def gemm_planes_mid_batch_ref(ar: torch.Tensor, ai: torch.Tensor,
                              br: torch.Tensor, bi: torch.Tensor):
    """(L, O, K, I) lane-batched left contraction ``C[l, o] = U[l]·A[l, o]``
    on re/im planes with per-lane U planes (L, K, K), not transposed: the
    einsum of ``repro``'s batched ``MidGemmOp``."""
    def e(b, a):
        return torch.einsum("ljk,loki->loji", b, a)
    cr = e(br, ar) - e(bi, ai)
    ci = e(br, ai) + e(bi, ar)
    return cr.to(torch.float32), ci.to(torch.float32)


def diag_apply_ref(ar: torch.Tensor, ai: torch.Tensor, dr: torch.Tensor,
                   di: torch.Tensor):
    """(R, K) planes times the complex diagonal ``dr + i·di`` ((K,) or
    (1, K)), broadcast over the rows."""
    dr = dr.reshape(1, -1)
    di = di.reshape(1, -1)
    cr = ar * dr - ai * di
    ci = ar * di + ai * dr
    return cr.to(torch.float32), ci.to(torch.float32)


# -- pwrel codec ------------------------------------------------------------

def tile_rows_for(rows: int, tile_rows: int) -> int:
    """The flag tile height the TPU kernels pick for ``rows`` rows."""
    tr = min(tile_rows, rows)
    while rows % tr:
        tr //= 2
    return tr


def _wrap_i32(v: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 with the same 32 bits."""
    return torch.where(v >= 2 ** 31, v - 2 ** 32, v).to(torch.int32)


def _codes(x: torch.Tensor, l_max: torch.Tensor, step) -> torch.Tensor:
    """f32 values -> int32 codes in [0, CODE_MAX] (``l_max`` broadcasts)."""
    step = torch.tensor(step, dtype=torch.float32, device=x.device)
    absx = x.abs()
    L = torch.log2(torch.clamp(absx, min=1e-45))
    d = torch.round((l_max - L) / step)
    codes_f = torch.where(absx <= 0, torch.zeros_like(d), CODE_MAX - d)
    return torch.clamp(codes_f, 0.0, float(CODE_MAX)).to(torch.int32)


def _dequant(codes: torch.Tensor, neg: torch.Tensor, l_max: torch.Tensor,
             step) -> torch.Tensor:
    """int32 codes + bool signs -> f32 values (``l_max`` broadcasts)."""
    step = torch.tensor(step, dtype=torch.float32, device=codes.device)
    d = CODE_MAX - codes.to(torch.float32)
    mag = torch.exp2(l_max - d * step)
    mag = torch.where(codes == 0, torch.zeros_like(mag), mag)
    return torch.where(neg, -mag, mag)


def _pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(..., W, 32) bool -> (..., W) int32 words, bit i = element i."""
    lane = torch.arange(32, device=bits.device, dtype=torch.int64)
    return _wrap_i32((bits.to(torch.int64) << lane).sum(-1))


def _unpack_bits(words: torch.Tensor) -> torch.Tensor:
    """(..., W) int32 words -> (..., W * 32) bool, element i = bit i."""
    lane = torch.arange(32, device=words.device, dtype=torch.int32)
    bits = (words.to(torch.int32).unsqueeze(-1) >> lane) & 1
    return bits.reshape(*words.shape[:-1], -1) == 1


def quantize_tiles_ref(x: torch.Tensor, l_max, step: float,
                       tile_rows: int = 8):
    """x (rows, 128) f32, l_max (1, 1) f32 -> (codes (rows, 128) int32,
    packed sign words (rows, 4) int32, per-tile flags (rows/tr, 3) int32:
    all codes zero / no negatives / all negatives)."""
    rows, lanes = x.shape
    if lanes != _LANES:
        raise ValueError(f"plane must be (rows, {_LANES}), got {tuple(x.shape)}")
    l_max = torch.as_tensor(l_max, dtype=torch.float32,
                            device=x.device).reshape(())
    codes = _codes(x, l_max, step)
    signs = x < 0
    packed = _pack_bits(signs.reshape(rows, _WORDS, 32))
    tr = tile_rows_for(rows, tile_rows)
    codes_t = codes.reshape(rows // tr, tr * _LANES)
    signs_t = signs.reshape(rows // tr, tr * _LANES)
    flags = torch.stack([(codes_t == 0).all(1), (~signs_t).all(1),
                         signs_t.all(1)], dim=1).to(torch.int32)
    return codes, packed, flags


def dequantize_tiles_ref(codes: torch.Tensor, packed_signs: torch.Tensor,
                         l_max, step: float) -> torch.Tensor:
    """codes (rows, 128) int32 + packed signs (rows, 4) int32 -> f32."""
    l_max = torch.as_tensor(l_max, dtype=torch.float32,
                            device=codes.device).reshape(())
    neg = _unpack_bits(packed_signs)
    return _dequant(codes, neg, l_max, step)


def pack_codes_tiles_ref(codes: torch.Tensor) -> torch.Tensor:
    """(rows, 128) int32 codes in [0, 65535] -> (rows, 64) int32 words,
    element 2j in the low half and 2j+1 in the high half."""
    rows = codes.shape[0]
    pairs = codes.to(torch.int64).reshape(rows, _LANES // 2, 2)
    return _wrap_i32(pairs[..., 0] | (pairs[..., 1] << 16))


def unpack_codes_tiles_ref(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_codes_tiles_ref`: (rows, 64) -> (rows, 128)."""
    w = packed.to(torch.int32)
    lo = w & 0xFFFF
    hi = (w >> 16) & 0xFFFF
    return torch.stack([lo, hi], dim=-1).reshape(w.shape[0], _LANES)


def pack_bitmap_tiles_ref(bits: torch.Tensor) -> torch.Tensor:
    """(rows, 128) bits (bool, or int32 where nonzero counts as set) ->
    (rows, 4) int32 ballot words, bit i of word w = lane 32w + i."""
    rows = bits.shape[0]
    return _pack_bits((bits != 0).reshape(rows, _WORDS, 32))


def unpack_bitmap_tiles_ref(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_bitmap_tiles_ref`: (rows, 4) int32 words ->
    (rows, 128) int32 bits in {0, 1}."""
    return _unpack_bits(packed).to(torch.int32)


# -- the fused wave versions ------------------------------------------------

def _stack_view(planes: torch.Tensor, n: int) -> torch.Tensor:
    """(R, 2, N) plane stack -> (R, 2, N/n, n) view of its blocks."""
    R, two, N = planes.shape
    if two != 2 or N % n:
        raise ValueError(f"plane stack {tuple(planes.shape)} does not hold "
                         f"blocks of {n}")
    return planes.view(R, 2, N // n, n)


def encode_planes_ref(planes: torch.Tensor, n: int, l_max: torch.Tensor,
                      step: float, flags_tile_rows: int | None = None):
    """Fused quantize + pack over every block plane of a wave.

    ``planes`` is an (R, 2, N) f32 stack of blocks of ``n``; plane
    ``q = 2*(r*nb + i) + c`` is component ``c`` of block ``i`` of row ``r``
    and ``l_max`` holds one f32 per plane in that order.  Returns
    ``(codes (P, n) int16 [u16 bits], sign words (P, ceil(n/32)) int32,
    flags (P, T, 3) int32 or None)``; flags are those of ``quantize_tiles``
    on the plane padded with zeros to whole 128-lane rows.
    """
    blocks = _stack_view(planes, n)
    P = blocks.shape[0] * blocks.shape[2] * 2
    x = blocks.transpose(1, 2).reshape(P, n)
    codes = _codes(x, l_max.reshape(P, 1), step)
    # signs over the plane padded with zeros to whole 128-lane rows
    rows, words = -(-n // _LANES), -(-n // 32)
    neg = torch.zeros((P, rows * _LANES), dtype=torch.bool, device=x.device)
    neg[:, :n] = x < 0
    signs = _pack_bits(neg[:, :words * 32].reshape(P, words, 32))
    flags = None
    if flags_tile_rows is not None:
        tr = tile_rows_for(rows, flags_tile_rows)
        padded = torch.zeros((P, rows * _LANES), dtype=torch.int32,
                             device=x.device)
        padded[:, :n] = codes
        codes_t = padded.reshape(P, rows // tr, tr * _LANES)
        neg_t = neg.reshape(P, rows // tr, tr * _LANES)
        flags = torch.stack([(codes_t == 0).all(2), (~neg_t).all(2),
                             neg_t.all(2)], dim=2).to(torch.int32)
    u16 = torch.where(codes >= 2 ** 15, codes - 2 ** 16, codes)
    return u16.to(torch.int16), signs, flags


def decode_planes_ref(codes: torch.Tensor, signs: torch.Tensor,
                      l_max: torch.Tensor, step: float, out: torch.Tensor,
                      n: int, plane_map: torch.Tensor | None = None):
    """Fused unpack + dequantize, written into the (R, 2, N) stack ``out``.

    ``codes`` (P, n) int16 [u16 bits], ``signs`` (P, ceil(n/32)) int32 and
    ``l_max`` (P,) f32 are wire planes; wire plane ``j`` lands on stack
    plane ``plane_map[j]`` (default ``j``), numbered as in
    :func:`encode_planes_ref`.  Returns ``out``.
    """
    blocks = _stack_view(out, n)
    P = codes.shape[0]
    c = codes.to(torch.int32) & 0xFFFF
    neg = _unpack_bits(signs)[:, :n]
    vals = _dequant(c, neg, l_max.reshape(P, 1), step)
    q = (torch.arange(P, device=out.device) if plane_map is None
         else plane_map.to(device=out.device, dtype=torch.int64))
    blk, comp = q // 2, q % 2
    nb = blocks.shape[2]
    blocks[blk // nb, comp, blk % nb] = vals
    return out


# -- attention (B10, B11) ------------------------------------------------------

NEG_INF = -2.0 ** 30           # the TPU kernels' mask (avoids inf - inf)
KV_RANGE = 16.0                # log2 units below the per-(token, head) max
KV_STEP = KV_RANGE / 254.0
KV_CODE_MAX = 255


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            mask: torch.Tensor | None, p_dtype=None) -> torch.Tensor:
    """f32 softmax attention over the last two axes; leading axes
    broadcast, so a (..., 1, T, hd) k serves (..., rep, S, hd) queries.
    ``p_dtype`` rounds the probabilities to it before P·V (sums in f32)."""
    s = torch.einsum("...sd,...td->...st", q, k) * (q.shape[-1] ** -0.5)
    if mask is not None:
        s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    if p_dtype is not None:
        p = p.to(p_dtype).float()
    return torch.einsum("...st,...td->...sd", p, v)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, window: int = 0) -> torch.Tensor:
    """q (..., S, hd), k/v (..., T, hd) -> (..., S, hd) f32, masked to j
    <= i when ``causal`` (``tests/test_kernels_flash.py``'s oracle) and to
    i - j < ``window`` when it is > 0 (``repro.models.attention.
    attention_full``'s sliding window); with neither, every one of the T
    keys (cross-attention's softmax(q k^T) v).  For bf16 inputs the
    probabilities are rounded to bf16 before P·V, as ``repro.models.
    attention._gqa_out`` rounds them (and the kernel's bf16 P·V on the
    tensor cores does)."""
    mask = None
    if causal or window:
        i = torch.arange(q.shape[-2], device=q.device)
        j = torch.arange(k.shape[-2], device=q.device)
        d = i[:, None] - j[None, :]
        mask = d >= 0 if causal else None
        if window:
            mask = d < window if mask is None else mask & (d < window)
    p_dtype = torch.bfloat16 if q.dtype == torch.bfloat16 else None
    return _attend(q.float(), k.float(), v.float(), mask, p_dtype)


def flash_attention_gqa_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, causal: bool = True,
                            window: int = 0) -> torch.Tensor:
    """q (B, S, Hq, hd), k/v (B, T, G, hd) -> (B, S, Hq, hd) in q's dtype;
    query head h = g·rep + r reads kv head g (bf16: probabilities rounded
    to bf16 before P·V, as in :func:`flash_attention_ref`)."""
    B, S, Hq, hd = q.shape
    G = k.shape[2]
    qh = q.permute(0, 2, 1, 3).reshape(B, G, Hq // G, S, hd)
    kh = k.permute(0, 2, 1, 3).unsqueeze(2)               # (B, G, 1, T, hd)
    vh = v.permute(0, 2, 1, 3).unsqueeze(2)
    out = flash_attention_ref(qh, kh, vh, causal, window)  # (B, G, rep, S, hd)
    return out.reshape(B, Hq, S, hd).permute(0, 2, 1, 3).to(q.dtype)


def kv_dequant_ref(codes: torch.Tensor, signs: torch.Tensor,
                   scale: torch.Tensor) -> torch.Tensor:
    """codes (..., hd) u8 + signs (..., hd/8) u8 + scale (..., 1) f32 ->
    f32 (..., hd): ``_dequant`` of the TPU kernel, sign bit i of byte j
    belonging to element 8j + i."""
    step = torch.full((), KV_STEP, dtype=torch.float32, device=codes.device)
    d = KV_CODE_MAX - codes.to(torch.float32)
    mag = torch.exp2(scale - d * step)
    mag = torch.where(codes == 0, torch.zeros_like(mag), mag)
    shifts = torch.arange(8, dtype=torch.uint8, device=codes.device)
    bits = (signs.unsqueeze(-1) >> shifts) & 1
    neg = bits.reshape(codes.shape) == 1
    return torch.where(neg, -mag, mag)


def _rounds_kv(q: torch.Tensor, kv_dtype) -> bool:
    """Whether B11 rounds K/V and p to bf16: for a bf16 q, or for any q
    with ``kv_dtype=torch.bfloat16`` (None keeps an f32 q's f32 products)."""
    if kv_dtype not in (None, torch.bfloat16):
        raise ValueError(f"kv_dequant_decode_attention: kv_dtype must be None "
                         f"or torch.bfloat16, got {kv_dtype}")
    return q.dtype == torch.bfloat16 or kv_dtype == torch.bfloat16


def kv_dequant_decode_attention_ref(q, codes_k, signs_k, scale_k, codes_v,
                                    signs_v, scale_v, pos, *, kv_dtype=None
                                    ) -> torch.Tensor:
    """q (..., rep, hd); cache leaves (..., T, ·) -> (..., rep, hd) f32,
    attending to cache slots j <= pos (a host int or a 0-d tensor on q's
    device, whose value is not read on the host).  For a bf16 q, or with
    ``kv_dtype=torch.bfloat16``, the dequantized K/V and the probabilities
    are rounded to bf16 before their products (sums in f32), as
    ``repro``'s serving decode dequantizes the cache to bf16
    (``dequantize_kv``'s default) and ``_gqa_out`` rounds the probabilities
    to v's."""
    k = kv_dequant_ref(codes_k, signs_k, scale_k)
    v = kv_dequant_ref(codes_v, signs_v, scale_v)
    p_dtype = None
    if _rounds_kv(q, kv_dtype):
        k, v = k.bfloat16().float(), v.bfloat16().float()
        p_dtype = torch.bfloat16
    T = codes_k.shape[-2]
    mask = torch.arange(T, device=q.device) <= pos
    return _attend(q.float(), k, v, mask, p_dtype)


def kv_dequant_decode_attention_gqa_ref(q, codes_k, signs_k, scale_k,
                                        codes_v, signs_v, scale_v, pos, *,
                                        window: int = 0, kv_dtype=None
                                        ) -> torch.Tensor:
    """q (B, 1, Hq, hd); cache leaves (B, T, G, ·) -> (B, 1, Hq, hd) f32
    (bf16 q or ``kv_dtype=torch.bfloat16``: rounded as in
    :func:`kv_dequant_decode_attention_ref`).
    ``window``, as the kernel's wrapper takes it, applies no mask: a
    windowed layer's cache holds at most W slots, a ring or shorter, where
    j <= pos is the window's mask (``kernels/kv_dequant_attention.py``);
    a longer one raises."""
    B, _, Hq, hd = q.shape
    G = codes_k.shape[2]
    if window and codes_k.shape[1] > window:
        raise ValueError(f"kv_dequant_decode_attention: a cache of "
                         f"{codes_k.shape[1]} slots for a window of {window}"
                         f": a windowed layer's cache must hold at most W "
                         f"slots")
    qh = q[:, 0].reshape(B, G, Hq // G, hd)
    cache = [t.transpose(1, 2) for t in (codes_k, signs_k, scale_k, codes_v,
                                         signs_v, scale_v)]
    out = kv_dequant_decode_attention_ref(qh, *cache, pos, kv_dtype=kv_dtype)
    return out.reshape(B, 1, Hq, hd)


def kv_dequant_decode_attention_tiled_ref(q, codes_k, signs_k, scale_k,
                                          codes_v, signs_v, scale_v, pos,
                                          span: int, tile: int, *,
                                          kv_dtype=None) -> torch.Tensor:
    """The B11 kernel's order of operations, for a check of it far tighter
    than the bf16 bound: q (..., rep, hd); cache leaves (..., T, ·) ->
    (..., rep, hd) f32, attending to j <= pos.  The tokens go in spans of
    ``span`` (the kernel's splits), each walked in tiles of ``tile`` with a
    running max m: f32 scores s, p = exp(s - m_new) in f32 (for a bf16 q
    rounded to bf16 unnormalised, and K/V rounded to bf16, as
    :func:`kv_dequant_decode_attention_ref` rounds them), the sum of the
    unrounded p and the accumulator rescaled by exp(m - m_new); the spans
    combined by their maxima.  ``kv_dtype=torch.bfloat16`` with an f32 q
    (the kernel's ``KV_BF16`` build) rounds K/V so too, and p after its
    normalisation, as the build's two passes do: the spans' running max and
    sum combined to the row's max M and sum L (f32, the combine's
    weights), p = bf16(exp(s - M) / L) in f32, and the spans' P·V added.
    Dot products and sums are f64, where the kernel's are f32 in its own
    order: the two differ by f32 rounding and by the odd p that rounds to
    its other bf16 neighbour."""
    bf = _rounds_kv(q, kv_dtype)
    normed = bf and q.dtype != torch.bfloat16

    def cast(x):
        return (x.bfloat16() if bf else x).double()

    live = min(codes_k.shape[-2], int(pos) + 1)
    k = cast(kv_dequant_ref(codes_k, signs_k, scale_k)[..., :live, :])
    v = cast(kv_dequant_ref(codes_v, signs_v, scale_v)[..., :live, :])
    one = torch.ones((), dtype=torch.float32, device=q.device)
    inv = one / torch.sqrt(one * q.shape[-1])            # 1 / sqrtf(hd)
    s = (q.double() @ k.transpose(-1, -2)).float() * inv  # (..., rep, live)
    ms, ls, accs = [], [], []
    for s0 in range(0, live, span):
        m = torch.full(s.shape[:-1] + (1,), NEG_INF, device=q.device)
        l = torch.zeros(m.shape, dtype=torch.float64, device=q.device)
        acc = torch.zeros(s.shape[:-1] + v.shape[-1:], dtype=torch.float64,
                          device=q.device)
        for t0 in range(s0, min(s0 + span, live), tile):
            sc = s[..., t0:min(t0 + tile, s0 + span, live)]
            m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
            alpha = torch.exp(m - m_new).double()
            p = torch.exp(sc - m_new)
            l = l * alpha + p.double().sum(-1, keepdim=True)
            acc = acc * alpha + cast(p) @ v[..., t0:t0 + sc.shape[-1], :]
            m = m_new
        ms.append(m)
        ls.append(l)
        accs.append(acc)
    if normed:
        M = torch.stack(ms).amax(0)
        L = sum(l.float() * torch.exp(m - M) for m, l in zip(ms, ls))
        p = torch.exp(s - M) / L.clamp(min=1e-30)
        return (cast(p) @ v).float()
    return kv_combine_ref(ms, ls, accs).float()


def kv_combine_ref(ms, ls, accs) -> torch.Tensor:
    """The spans' partials (running max m, sum l, P·V acc; one each a
    span) combined by their maxima, as B11's combine kernel does: the sum
    of acc·exp(m - max) over the sum of l·exp(m - max), floored at 1e-30.
    A neutral partial (m = NEG_INF, l = 0, acc = 0: a span past the live
    tokens) has weight exp(NEG_INF - max) = 0 and drops out."""
    mx = torch.stack(list(ms)).amax(0)
    w = [torch.exp(m - mx).double() for m in ms]
    return (sum(a * x for a, x in zip(accs, w))
            / sum(l * x for l, x in zip(ls, w)).clamp(min=1e-30))
