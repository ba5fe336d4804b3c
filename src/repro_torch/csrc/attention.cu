// Attention for Hopper (sm_90a): the LM serving path's two attention cores.
//
// flash_bf16_kernel / flash_f32_kernel replace
// repro/kernels/flash_attention.py::flash_attention (kernel body
// _flash_kernel, pl.pallas_call at :90): causal (or full) online-softmax
// attention, scale hd^-0.5, masked scores -2^30, a floor of 1e-30 on the
// softmax sum, K tiles wholly above the diagonal skipped.  One kernel per
// input type serves the TPU signature (BH, S, hd) and the model's layout:
// q (B, S, Hq, hd) and k/v (B, T, G, hd), all by strides, where query head h
// reads kv head h / rep (rep = Hq / G, the grouping of _gqa_scores).  No
// replicated KV heads and no (BH, S, hd) copy are made.  The key length T
// is the query length S for self-attention; cross-attention (llama-vision's
// image layers, whisper's decoder; repro/models/attention.py::
// attention_cross) reads T != S keys unmasked, and keys at or past T are
// masked in the last tile as rows past S are not stored.
//
// What bounds it: operations.  A (BH, S, hd) causal call does
// 2·BH·hd·S(S+1)/2 multiply-adds (two products over the unmasked pairs)
// over 3·BH·S·hd inputs, ~100 FLOP per byte at S = 2048 in f32.  At
// (128, 2048, 128) that is 2.05 ms as f32 FMAs on the CUDA cores, 0.833 ms
// as split TF32 (three products each) and 0.139 ms in bf16 on the tensor
// cores.  So both matmuls run as mma.sync on the tensor cores, with f32
// sums and the reference's accuracy:
//   * bf16 inputs: m16n8k16 bf16 MMAs.  Products of bf16 are exact in f32,
//     which is the arithmetic of _gqa_scores (preferred_element_type f32).
//     The scale is applied to the f32 scores (folded with log2 e into one
//     exp2f argument), never to q, which would round q to bf16 again.  p is
//     rounded to bf16 for P·V, as _gqa_out rounds the probabilities;
//   * f32 inputs: split TF32 (x = big + small, three m16n8k8 MMAs a product,
//     as in gate_apply.cu); p stays f32 and is split, not rounded;
//   * FlashAttention-2's structure: a block of 4 warps owns 128 query rows
//     of one head, a warp two tiles of 16; the online softmax runs on the
//     accumulator fragments (a row's max and sum over the thread quad that
//     holds it), so scores and p never reach shared memory, and K/V tiles
//     are double-buffered in shared memory with 16-byte cp.async;
//   * causal K tiles past the block's last row are never read, a warp skips
//     a tile wholly above its rows, and blocks of the causal diagonal's far
//     end (the longest rows) launch first, to shorten the tail;
//   * a sliding window W (gemma3's local layers; repro masks i - j < W in
//     XLA, models/attention.py:110-112) skips the K tiles wholly below the
//     block's first row's window and a warp those below its own, and masks
//     the boundary tiles.  A row whose first tiles are all masked carries
//     p = 1 against m = -2^30 until its first live key, whose rescale
//     exp2(-2^30 - m) is 0 and clears it, as the plain softmax gives 0;
//   * hd = 256 (gemma3) holds one m-tile a warp (a 64 x 256 accumulator is
//     128 registers) and narrower K/V tiles, so two blocks share an SM.
//
// kvdq_partial_kernel / kvdq_combine_kernel replace
// repro/kernels/kv_dequant_attention.py::kv_dequant_decode_attention (body
// _kernel at :49, _dequant at :37, pl.pallas_call at :98): one decode step's
// attention over a pwrel-compressed KV cache (uint8 codes, LSB-first packed
// sign bytes, a per-(token, head) f32 log2 scale), dequantized in registers
// as |x| = exp2(scale - (255 - c)·16/254), 0 for c = 0, masked to j <= pos.
// The cache is read through strides as (B, G, T, ·) views, so a layer's
// slice of the stacked (U, B, T, G, hd) serving cache is never copied, and q
// (B, 1, Hq, hd) is read as (B·G, rep, hd).
//
// What bounds it: bytes, then the dequantize.  Each cached token costs
// hd + hd/8 + 4 bytes for K and the same for V: 0.0232 ms at the serve shape
// (B 8, G 8, T 4,096, hd 128).  Dequantizing its 67.1 M elements takes one
// MUFU.EX2 each, 16 an SM a clock: 0.016 ms at 1.98 GHz; with the FMAs (4·rep
// per element counting K and V) and the rest of the arithmetic the issue
// slots come close to the bytes.  So the kernel streams, and dequantizes each
// element once with as few instructions as it can:
//   * the grid is (B·G·ceil(rep/4), splits): a block takes 4 query rows of
//     one (batch, kv head) over a span of tokens, as many spans as fill the
//     card (kv_dequant_attention.py::splits), and walks its span in tiles
//     through a ring of cp.async stages that carry each tile's K and V
//     codes, signs and scales together, so the next tiles load while this
//     one computes;
//   * the online softmax runs across the tiles inside the block (running max
//     m, sum l, accumulators rescaled by exp(m - m_new)); partial blocks
//     leave (m, l, P·V) to a combine kernel (flash-decoding), one split
//     writes the result itself;
//   * the dequantize (dequant4) is bit for bit the previous form: the code
//     to float by the magic number 2^23 (no I2F), the scale's two rounded
//     operations (__fmul_rn/__fsub_rn, so nvcc cannot fuse them into an FMA
//     the plain version does not do), exp2f as one MUFU.EX2 where the tile's
//     scales keep every argument normal, the sign as bit 31, and for a bf16
//     q the bf16 rounding as one packed cvt.rn.bf16x2 for two values.
// Measured on one H100 (PERF.md §6): at the serve shape with a bf16 q the
// arithmetic alone (no copies) takes 0.064 ms and the stream alone 0.035;
// together 0.074.  The arithmetic, not the bytes, sets the pace, and not
// through issue slots alone: QK^T on the tensor cores saved ~5%, integer
// bf16 rounding (+3 integer ops an element) cost 17%.
// pos lives in device memory (repro's pos_ref), so one launch serves every
// step of a captured decode (CUDA graphs): the grid is fixed on the host
// from the cache length T, and each block finds live = min(T, pos + 1) and
// its span itself, by kv_dequant_attention.py::splits; a split whose span
// starts at or past live leaves a neutral partial (m = -2^30, l = 0, P·V =
// 0) that the combine weighs by exp(-2^30 - max) = 0.  At hd = 256 a tile
// is 64 tokens (two blocks an SM) and a lane takes 8 dims in P·V.
// Rounding follows q's type, as repro's serving decode does (the cache
// dequantizes to the model's dtype, dequantize_kv; _gqa_out rounds the
// probabilities to v's): for a bf16 q each dequantized K and V element is
// rounded to bf16 (nearest even) before its products, and p = exp(s - m) to
// bf16 before P·V, unnormalised and relative to the block's running max m,
// divided by the f32 sum of the unrounded p; the sums stay f32.  For an f32
// q nothing is rounded, unless the build takes KV_BF16: then the f32-q path
// rounds each dequantized K and V element to bf16 before its products and p
// to bf16 before P·V (QK^T and P·V stay f32 FMAs and the sums f32), as
// repro's serving decode of an f32 model does (dequantize_kv's bf16
// default, _gqa_out's bf16 P).  That build rounds p where repro does, after
// the softmax's normalisation: p = bf16(exp(s - M) / L) with the row's max M
// and sum L over every live token, which no split knows while it walks its
// span.  So it takes two launches over the one grid: kStats (QK^T alone, each
// split's running max and sum) and kNormed (each block combines the splits'
// (max, sum) of its rows to M and L, as the combine weighs them, then rounds
// the normalised p and sums P·V; the combine adds the partials).  Its cost
// is a second pass over K.  KV_BF16 is the compressed decode's build
// (serving/kvcache.py); without it the kernel keeps the Pallas kernel's f32
// semantics.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

#include "cp_async.cuh"

namespace {

constexpr float kNegInf = -1073741824.0f;  // -2^30, the TPU kernels' mask
constexpr float kLFloor = 1e-30f;

// The dynamic shared memory a kernel may take, set once a device: after the
// first (eager) launch a launch makes no runtime call but the launch itself
// and cudaGetDevice / cudaGetLastError, all legal under stream capture.
template <auto Kernel>
cudaError_t smem_once(int smem) {
  static std::atomic<bool> done[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 64 && done[dev].load())) return err;
  err = cudaFuncSetAttribute(Kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && dev < 64) done[dev].store(true);
  return err;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// ---------------------------------------------------------------- B10 -----

constexpr int kFThreads = 128;  // 4 warps

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d += a b over one m16n8k16 bf16 tile, f32 sums (the products are exact)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x's TF32 rounding (nearest, ties away from zero) in an f32 container
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = big + small, both TF32 (gate_apply.cu's split)
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = tf32_rna(x);
  small = tf32_rna(x - __uint_as_float(big));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b in split TF32: small*big + big*small, then big*big
__device__ __forceinline__ void mma_3xtf32(float (&d)[4],
                                           const uint32_t (&ab)[4],
                                           const uint32_t (&as)[4],
                                           uint32_t bb0, uint32_t bb1,
                                           uint32_t bs0, uint32_t bs1) {
  mma_tf32(d, as, bb0, bb1);
  mma_tf32(d, ab, bs0, bs1);
  mma_tf32(d, ab, bb0, bb1);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16_rn(0.f);
}

// Rows [s0, s0 + ROWS) of one head (row stride rs elements, D contiguous)
// into a shared tile of pitch P elements; rows at or past S are zeros.
// vec: 16-byte cp.async (base and strides 16-byte aligned), else element
// copies.
template <int ROWS, int D, int P, typename T>
__device__ __forceinline__ void load_tile(T* dst, const T* src, long long rs,
                                          int s0, int S, bool vec) {
  if (vec) {
    constexpr int E = 16 / (int)sizeof(T);  // elements a chunk
    constexpr int CH = D / E;               // chunks a row
    for (int e = threadIdx.x; e < ROWS * CH; e += kFThreads) {
      const int r = e / CH, c = e % CH, s = s0 + r;
      const bool in = s < S;
      // src-size 0 zero-fills the 16 bytes (rows past S)
      cp_async16(dst + r * P + c * E, in ? src + s * rs + c * E : src,
                 in ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < ROWS * D; e += kFThreads) {
      const int r = e / D, d = e % D, s = s0 + r;
      dst[r * P + d] = s < S ? src[s * rs + d] : zero<T>();
    }
  }
}

// Scores of n-tile j (keys k0 + 8j + 2t + {0, 1}) for rows r0 (c0, c1) and
// r0 + 8 (c2, c3) set to -2^30 where masked: at or past the key length T,
// above the diagonal, or (window W > 0) W or more keys below the row.
template <int NJ>
__device__ __forceinline__ void mask_scores(float (&sc)[NJ][4], int k0,
                                            int r0, int t, int T,
                                            int causal, int window) {
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int key = k0 + 8 * j + 2 * t + (u & 1);
      const int row = r0 + 8 * (u >> 1);
      if (key >= T || (causal && key > row) ||
          (window && row - key >= window))
        sc[j][u] = kNegInf;
    }
}

// Does m-tile rows [r, r + 15] x keys [k0, k0 + BK) hold a masked pair?
template <int BK>
__device__ __forceinline__ bool needs_mask(int k0, int r, int T, int causal,
                                           int window) {
  return k0 + BK > T || (causal && k0 + BK - 1 > r) ||
         (window && r + 15 - k0 >= window);
}

// Does a warp whose lowest row is w0 and highest w1 read K tile [k0, k0 +
// BK) at all: not wholly above its rows (causal), not wholly W or more
// below its lowest row (window)?
template <int BK>
__device__ __forceinline__ bool warp_reads(int k0, int w0, int w1, int causal,
                                           int window) {
  return !(causal && k0 > w1) && !(window && w0 - (k0 + BK - 1) >= window);
}

// One tile's online softmax on the accumulator fragments of rows g (i = 0)
// and g + 8 (i = 1): the rows' max over the quad (two shuffles), scores
// turned into p = exp2((s - m) scale log2 e) in place, the thread's share
// of the row sums l rescaled and summed (the quad sums them at the end).
template <int NJ>
__device__ __forceinline__ void softmax_tile(float (&sc)[NJ][4],
                                             float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], float sl2) {
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    mx[0] = fmaxf(mx[0], fmaxf(sc[j][0], sc[j][1]));
    mx[1] = fmaxf(mx[1], fmaxf(sc[j][2], sc[j][3]));
  }
  float mb[2], rs[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    alpha[i] = exp2f((m[i] - mx[i]) * sl2);
    m[i] = mx[i];
    mb[i] = mx[i] * sl2;
  }
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float p = exp2f(fmaf(sc[j][u], sl2, -mb[u >> 1]));
      sc[j][u] = p;
      rs[u >> 1] += p;
    }
#pragma unroll
  for (int i = 0; i < 2; ++i) l[i] = fmaf(l[i], alpha[i], rs[i]);
}

// The denominators of rows g and g + 8: the quad's shares summed, floored.
__device__ __forceinline__ void finish_rows(float (&l)[2]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    l[i] = fmaxf(l[i], kLFloor);
  }
}

// Tiles: a warp owns MT m-tiles of 16 query rows (rows 16w + 64i of the
// block's 64·MT, i < MT, so the causal diagonal's work spreads over the
// four warps); K/V tiles of BK rows.  Each K or V fragment read from shared
// memory feeds MT MMAs, which sets the ratio of MMAs to shared-memory
// reads; MT = 2 holds 32 rows' accumulators, the most 255 registers take.
// The values below timed fastest at hd = 128 on one H100 among those
// chip_tiles.py tries (PERF.md §6); it builds the source with others by
// defining FLASH_TILING (MT, BK for bf16, then for f32).  At hd = 256 a
// warp holds one m-tile (128 accumulator registers) and the K/V tiles are
// narrower, so that a block's shared memory lets two share an SM
// (FLASH_TILING_256: bf16 64 x 256 Q and 2 x 2 x 32 K/V rows of 264 bf16,
// 101,376 bytes; f32 1 x 16, 137,728 bytes, one block an SM).
#ifndef FLASH_TILING
#define FLASH_TILING 2, 64, 2, 16
#endif
#ifndef FLASH_TILING_256
#define FLASH_TILING_256 1, 32, 1, 16
#endif
constexpr int kFlashTiling[] = {FLASH_TILING};
constexpr int kFlashTiling256[] = {FLASH_TILING_256};
// tiling constant i (MT, BK for bf16, then for f32) at head dim D
template <int D>
constexpr int flash_tile(int i) {
  return D > 128 ? kFlashTiling256[i] : kFlashTiling[i];
}

template <int D, int MT, int BK>
constexpr int flash_bf16_smem() {
  return (64 * MT + 4 * BK) * (D + 8) * 2;
}

// bf16 q/k/v: QK^T and P·V as m16n8k16 bf16 MMAs with f32 sums.  Tiles
// are rows of D + 8 bf16 (16 bytes mod 128 apart: ldmatrix reads 8 rows
// from 8 bank groups).  Q's fragments come from shared memory through
// ldmatrix; K/V tiles are double-buffered with cp.async; K feeds the B
// fragments through ldmatrix, V through ldmatrix.trans; p is rounded to
// bf16 in registers and used as P·V's A operand (the m16n8 accumulator
// layout of two n-tiles is the m16n8k16 A layout), so it never touches
// shared memory.
template <int D, int MT, int BK>
__global__ void __launch_bounds__(kFThreads, 2)
flash_bf16_kernel(const __nv_bfloat16* __restrict__ q, long long qb,
                  long long qs, long long qh,
                  const __nv_bfloat16* __restrict__ k, long long kb,
                  long long ks, long long kh,
                  const __nv_bfloat16* __restrict__ v, long long vb,
                  long long vs, long long vh, __nv_bfloat16* __restrict__ o,
                  long long ob, long long os, long long oh, int S, int T,
                  int Hq, int rep, int causal, int window, float sl2,
                  int vec) {
  using bf16 = __nv_bfloat16;
  constexpr int BQ = 64 * MT, P = D + 8, NJ = BK / 8, ND = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + BQ * P;       // two stages
  bf16* Vs = Ks + 2 * BK * P;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x;
  const int b = bh / Hq, h = bh % Hq, kvh = h / rep;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // longest rows first
  const int w0 = q0 + 16 * warp;             // the warp's first row
  const int w1 = w0 + 64 * (MT - 1) + 15;    // and its last
  const bf16* qp = q + b * qb + h * qh;
  const bf16* kp = k + b * kb + kvh * kh;
  const bf16* vp = v + b * vb + kvh * vh;

  int n_kt = (T + BK - 1) / BK;
  if (causal) n_kt = min(n_kt, (q0 + BQ + BK - 1) / BK);
  // the first K tile any row of the block reads (window: key q0 - W + 1)
  const int kt0 = window ? max(0, q0 - window + 1) / BK : 0;
  load_tile<BQ, D, P>(Qs, qp, qs, q0, S, vec);
  load_tile<BK, D, P>(Ks, kp, ks, kt0 * BK, T, vec);
  load_tile<BK, D, P>(Vs, vp, vs, kt0 * BK, T, vec);
  cp_async_commit();

  float acc[MT][ND][4], m[MT][2], l[MT][2];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    m[i][0] = m[i][1] = kNegInf;
    l[i][0] = l[i][1] = 0.f;
#pragma unroll
    for (int dt = 0; dt < ND; ++dt)
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[i][dt][u] = 0.f;
  }
  const bf16* qa_row = Qs + (16 * warp + (lane & 15)) * P + 8 * (lane >> 4);

  for (int kt = kt0; kt < n_kt; ++kt) {
    const int k0 = kt * BK, buf = (kt - kt0) & 1;
    if (kt + 1 < n_kt) {
      load_tile<BK, D, P>(Ks + (buf ^ 1) * BK * P, kp, ks, k0 + BK, T, vec);
      load_tile<BK, D, P>(Vs + (buf ^ 1) * BK * P, vp, vs, k0 + BK, T, vec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    // a warp whose rows all lie above the tile's first key, or W or more
    // past its last, has nothing here
    if (warp_reads<BK>(k0, w0, w1, causal, window)) {
      const bf16* Kt = Ks + buf * BK * P;
      const bf16* Vt = Vs + buf * BK * P;
      float sc[MT][NJ][4];
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int u = 0; u < 4; ++u) sc[i][j][u] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t qa[MT][4];
#pragma unroll
        for (int i = 0; i < MT; ++i)
          ldmatrix_x4(qa[i], qa_row + 64 * i * P + 16 * kk);
#pragma unroll
        for (int jp = 0; jp < NJ / 2; ++jp) {
          uint32_t bk[4];
          ldmatrix_x4(bk, Kt + (16 * jp + (lane & 7) + 8 * (lane >> 4)) * P +
                              16 * kk + 8 * ((lane >> 3) & 1));
#pragma unroll
          for (int i = 0; i < MT; ++i) {
            mma_bf16(sc[i][2 * jp], qa[i], bk[0], bk[1]);
            mma_bf16(sc[i][2 * jp + 1], qa[i], bk[2], bk[3]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        if (needs_mask<BK>(k0, w0 + 64 * i, T, causal, window))
          mask_scores(sc[i], k0, w0 + 64 * i + g, t, T, causal, window);
        float alpha[2];
        softmax_tile(sc[i], m[i], l[i], alpha, sl2);
#pragma unroll
        for (int dt = 0; dt < ND; ++dt) {
          acc[i][dt][0] *= alpha[0];
          acc[i][dt][1] *= alpha[0];
          acc[i][dt][2] *= alpha[1];
          acc[i][dt][3] *= alpha[1];
        }
      }
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t pa[MT][4];
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          pa[i][0] = pack_bf16(sc[i][2 * kk][0], sc[i][2 * kk][1]);
          pa[i][1] = pack_bf16(sc[i][2 * kk][2], sc[i][2 * kk][3]);
          pa[i][2] = pack_bf16(sc[i][2 * kk + 1][0], sc[i][2 * kk + 1][1]);
          pa[i][3] = pack_bf16(sc[i][2 * kk + 1][2], sc[i][2 * kk + 1][3]);
        }
#pragma unroll
        for (int dp = 0; dp < ND / 2; ++dp) {
          uint32_t bv[4];
          ldmatrix_x4_trans(bv, Vt + (16 * kk + (lane & 7) +
                                      8 * ((lane >> 3) & 1)) * P +
                                    16 * dp + 8 * (lane >> 4));
#pragma unroll
          for (int i = 0; i < MT; ++i) {
            mma_bf16(acc[i][2 * dp], pa[i], bv[0], bv[1]);
            mma_bf16(acc[i][2 * dp + 1], pa[i], bv[2], bv[3]);
          }
        }
      }
    }
    __syncthreads();  // the tile's readers are done before it is refilled
  }

#pragma unroll
  for (int i = 0; i < MT; ++i) {
    finish_rows(l[i]);
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int r = w0 + 64 * i + g + 8 * hi;
      if (r >= S) continue;
      bf16* orow = o + b * ob + r * os + h * oh;
#pragma unroll
      for (int dt = 0; dt < ND; ++dt)
        *reinterpret_cast<uint32_t*>(orow + 8 * dt + 2 * t) =
            pack_bf16(acc[i][dt][2 * hi] / l[i][hi],
                      acc[i][dt][2 * hi + 1] / l[i][hi]);
    }
  }
}

template <int D>
struct F32Pitch {
  // Q/K rows 16 floats mod 32 apart: a float4 fragment read of 8 lanes
  // (rows g, g+1; columns 4t) hits 8 distinct bank groups; V rows 4 apart:
  // the float2 reads of rows 2t, 2t+1 by 16 lanes hit distinct banks
  static constexpr int K = D + (D % 32 == 0 ? 16 : 0);
  static constexpr int V = D + 4;
};

template <int D, int MT, int BK>
constexpr int flash_f32_smem() {
  return (64 * MT * F32Pitch<D>::K +
          2 * BK * (F32Pitch<D>::K + F32Pitch<D>::V)) * 4;
}

// f32 q/k/v: the same skeleton with split TF32 (three m16n8k8 MMAs a
// product, as in gate_apply.cu) for QK^T and P·V; p stays f32 and is split,
// not rounded.  The reduction indices are permuted so that fragments come
// as float4 (Q, K: slots t, t+4 of steps 2c, 2c+1 are columns 16c + 4t ..
// +3) and float2 (V: rows 2t, 2t+1 are the keys of slots t, t+4, which
// are where the score accumulators hold them); V's output columns are
// permuted (n-tile pair 2p, 2p+1, column g -> 16p + 2g + {0, 1}) so each
// V read is one float2 and each output write one float4.
template <int D, int MT, int BK>
__global__ void __launch_bounds__(kFThreads, 2)
flash_f32_kernel(const float* __restrict__ q, long long qb, long long qs,
                 long long qh, const float* __restrict__ k, long long kb,
                 long long ks, long long kh, const float* __restrict__ v,
                 long long vb, long long vs, long long vh,
                 float* __restrict__ o, long long ob, long long os,
                 long long oh, int S, int T, int Hq, int rep, int causal,
                 int window, float sl2, int vec) {
  constexpr int BQ = 64 * MT, NJ = BK / 8, ND = D / 8;
  constexpr int PK = F32Pitch<D>::K, PV = F32Pitch<D>::V;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * PK;     // two stages
  float* Vs = Ks + 2 * BK * PK;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x;
  const int b = bh / Hq, h = bh % Hq, kvh = h / rep;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // longest rows first
  const int w0 = q0 + 16 * warp;             // the warp's first row
  const int w1 = w0 + 64 * (MT - 1) + 15;    // and its last
  const float* qp = q + b * qb + h * qh;
  const float* kp = k + b * kb + kvh * kh;
  const float* vp = v + b * vb + kvh * vh;

  int n_kt = (T + BK - 1) / BK;
  if (causal) n_kt = min(n_kt, (q0 + BQ + BK - 1) / BK);
  // the first K tile any row of the block reads (window: key q0 - W + 1)
  const int kt0 = window ? max(0, q0 - window + 1) / BK : 0;
  load_tile<BQ, D, PK>(Qs, qp, qs, q0, S, vec);
  load_tile<BK, D, PK>(Ks, kp, ks, kt0 * BK, T, vec);
  load_tile<BK, D, PV>(Vs, vp, vs, kt0 * BK, T, vec);
  cp_async_commit();

  float acc[MT][ND][4], m[MT][2], l[MT][2];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    m[i][0] = m[i][1] = kNegInf;
    l[i][0] = l[i][1] = 0.f;
#pragma unroll
    for (int dt = 0; dt < ND; ++dt)
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[i][dt][u] = 0.f;
  }
  const float* qrow = Qs + (16 * warp + g) * PK + 4 * t;

  for (int kt = kt0; kt < n_kt; ++kt) {
    const int k0 = kt * BK, buf = (kt - kt0) & 1;
    if (kt + 1 < n_kt) {
      load_tile<BK, D, PK>(Ks + (buf ^ 1) * BK * PK, kp, ks, k0 + BK, T, vec);
      load_tile<BK, D, PV>(Vs + (buf ^ 1) * BK * PV, vp, vs, k0 + BK, T, vec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (warp_reads<BK>(k0, w0, w1, causal, window)) {
      const float* Kt = Ks + buf * BK * PK + g * PK + 4 * t;
      const float* Vt = Vs + buf * BK * PV + 2 * t * PV + 2 * g;
      float sc[MT][NJ][4];
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int u = 0; u < 4; ++u) sc[i][j][u] = 0.f;
#pragma unroll
      for (int c = 0; c < D / 16; ++c) {
        uint32_t ab[MT][2][4], as[MT][2][4];
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          const float* qi = qrow + 64 * i * PK + 16 * c;
          const float4 qx = *reinterpret_cast<const float4*>(qi);
          const float4 qy = *reinterpret_cast<const float4*>(qi + 8 * PK);
          const float fa[2][4] = {{qx.x, qy.x, qx.y, qy.y},
                                  {qx.z, qy.z, qx.w, qy.w}};
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
#pragma unroll
            for (int u = 0; u < 4; ++u)
              split_tf32(fa[hh][u], ab[i][hh][u], as[i][hh][u]);
        }
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const float4 kx =
              *reinterpret_cast<const float4*>(Kt + 8 * j * PK + 16 * c);
          uint32_t kbg[4], ksm[4];
          split_tf32(kx.x, kbg[0], ksm[0]);
          split_tf32(kx.y, kbg[1], ksm[1]);
          split_tf32(kx.z, kbg[2], ksm[2]);
          split_tf32(kx.w, kbg[3], ksm[3]);
#pragma unroll
          for (int i = 0; i < MT; ++i) {
            mma_3xtf32(sc[i][j], ab[i][0], as[i][0], kbg[0], kbg[1], ksm[0],
                       ksm[1]);
            mma_3xtf32(sc[i][j], ab[i][1], as[i][1], kbg[2], kbg[3], ksm[2],
                       ksm[3]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        if (needs_mask<BK>(k0, w0 + 64 * i, T, causal, window))
          mask_scores(sc[i], k0, w0 + 64 * i + g, t, T, causal, window);
        float alpha[2];
        softmax_tile(sc[i], m[i], l[i], alpha, sl2);
#pragma unroll
        for (int dt = 0; dt < ND; ++dt) {
          acc[i][dt][0] *= alpha[0];
          acc[i][dt][1] *= alpha[0];
          acc[i][dt][2] *= alpha[1];
          acc[i][dt][3] *= alpha[1];
        }
      }
#pragma unroll
      for (int kk = 0; kk < NJ; ++kk) {
        // slots t, t+4 of this step are keys 8kk + 2t, 8kk + 2t + 1
        uint32_t pb[MT][4], ps[MT][4];
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          const float fp[4] = {sc[i][kk][0], sc[i][kk][2], sc[i][kk][1],
                               sc[i][kk][3]};
#pragma unroll
          for (int u = 0; u < 4; ++u) split_tf32(fp[u], pb[i][u], ps[i][u]);
        }
        const float* v0 = Vt + 8 * kk * PV;
#pragma unroll
        for (int p = 0; p < ND / 2; ++p) {
          const float2 x0 = *reinterpret_cast<const float2*>(v0 + 16 * p);
          const float2 x1 = *reinterpret_cast<const float2*>(v0 + PV + 16 * p);
          uint32_t vb[4], vsm[4];
          split_tf32(x0.x, vb[0], vsm[0]);
          split_tf32(x1.x, vb[1], vsm[1]);
          split_tf32(x0.y, vb[2], vsm[2]);
          split_tf32(x1.y, vb[3], vsm[3]);
#pragma unroll
          for (int i = 0; i < MT; ++i) {
            mma_3xtf32(acc[i][2 * p], pb[i], ps[i], vb[0], vb[1], vsm[0],
                       vsm[1]);
            mma_3xtf32(acc[i][2 * p + 1], pb[i], ps[i], vb[2], vb[3],
                       vsm[2], vsm[3]);
          }
        }
      }
    }
    __syncthreads();  // the tile's readers are done before it is refilled
  }

#pragma unroll
  for (int i = 0; i < MT; ++i) {
    finish_rows(l[i]);
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int r = w0 + 64 * i + g + 8 * hi;
      if (r >= S) continue;
      float* orow = o + b * ob + r * os + h * oh;
#pragma unroll
      for (int p = 0; p < ND / 2; ++p)
        *reinterpret_cast<float4*>(orow + 16 * p + 4 * t) = make_float4(
            acc[i][2 * p][2 * hi] / l[i][hi],
            acc[i][2 * p + 1][2 * hi] / l[i][hi],
            acc[i][2 * p][2 * hi + 1] / l[i][hi],
            acc[i][2 * p + 1][2 * hi + 1] / l[i][hi]);
    }
  }
}

// base and (batch, sequence, head) strides all 16-byte multiples
inline bool aligned16(const void* p, const long long* st, size_t el) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0 &&
         (st[0] * el) % 16 == 0 && (st[1] * el) % 16 == 0 &&
         (st[2] * el) % 16 == 0;
}

template <typename T, auto Kernel>
cudaError_t launch_flash(int smem, int bq, const void* q, const long long* qst,
                         const void* k, const long long* kst, const void* v,
                         const long long* vst, void* o, const long long* ost,
                         int B, int S, int Tk, int Hq, int G, int D,
                         int causal, int window, cudaStream_t stream) {
  cudaError_t err = smem_once<Kernel>(smem);
  if (err != cudaSuccess) return err;
  const int vec = aligned16(q, qst, sizeof(T)) &&
                  aligned16(k, kst, sizeof(T)) && aligned16(v, vst, sizeof(T));
  const dim3 grid((unsigned)(B * Hq), (unsigned)((S + bq - 1) / bq));
  Kernel<<<grid, kFThreads, smem, stream>>>(
      static_cast<const T*>(q), qst[0], qst[1], qst[2],
      static_cast<const T*>(k), kst[0], kst[1], kst[2],
      static_cast<const T*>(v), vst[0], vst[1], vst[2], static_cast<T*>(o),
      ost[0], ost[1], ost[2], S, Tk, Hq, Hq / G, causal, window,
      1.4426950408889634f / sqrtf((float)D), vec);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_flash_d(int bf16, const void* q, const long long* qst,
                           const void* k, const long long* kst,
                           const void* v, const long long* vst, void* o,
                           const long long* ost, int B, int S, int T, int Hq,
                           int G, int causal, int window, cudaStream_t s) {
  constexpr int MTh = flash_tile<D>(0), BKh = flash_tile<D>(1);
  constexpr int MTf = flash_tile<D>(2), BKf = flash_tile<D>(3);
  if (bf16)
    return launch_flash<__nv_bfloat16, flash_bf16_kernel<D, MTh, BKh>>(
        flash_bf16_smem<D, MTh, BKh>(), 64 * MTh, q, qst, k, kst, v, vst, o,
        ost, B, S, T, Hq, G, D, causal, window, s);
  return launch_flash<float, flash_f32_kernel<D, MTf, BKf>>(
      flash_f32_smem<D, MTf, BKf>(), 64 * MTf, q, qst, k, kst, v, vst, o,
      ost, B, S, T, Hq, G, D, causal, window, s);
}

cudaError_t dispatch_flash(int bf16, const void* q, const long long* qst,
                           const void* k, const long long* kst,
                           const void* v, const long long* vst, void* o,
                           const long long* ost, int B, int S, int T, int Hq,
                           int G, int hd, int causal, int window,
                           cudaStream_t s) {
  switch (hd) {
    case 16: return launch_flash_d<16>(bf16, q, qst, k, kst, v, vst, o, ost, B, S, T, Hq, G, causal, window, s);
    case 32: return launch_flash_d<32>(bf16, q, qst, k, kst, v, vst, o, ost, B, S, T, Hq, G, causal, window, s);
    case 64: return launch_flash_d<64>(bf16, q, qst, k, kst, v, vst, o, ost, B, S, T, Hq, G, causal, window, s);
    case 128: return launch_flash_d<128>(bf16, q, qst, k, kst, v, vst, o, ost, B, S, T, Hq, G, causal, window, s);
    case 256: return launch_flash_d<256>(bf16, q, qst, k, kst, v, vst, o, ost, B, S, T, Hq, G, causal, window, s);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------- B11 -----

// Tokens a tile, tiles in the ring, blocks an SM (registers are capped for
// it), and cached dims a lane in QK^T.  The values below timed fastest at
// the serve shape on one H100 among those chip_tiles.py tries (PERF.md §6);
// it builds the source with others by defining KV_TILING.
#ifndef KV_TILING
#define KV_TILING 128, 2, 2, 16
#endif
constexpr int kKvTiling[] = {KV_TILING};
constexpr int kKvTile = kKvTiling[0], kKvStages = kKvTiling[1],
              kKvBlocksSM = kKvTiling[2], kKvKDims = kKvTiling[3];
// Tokens a tile at hd = 256: 64, so that two blocks share an SM (two ring
// stages of 74,752 bytes)
#ifndef KV_TILE_256
#define KV_TILE_256 64
#endif
constexpr int kKvTile256 = KV_TILE_256;
__host__ __device__ constexpr int kv_tile(int hd) {
  return hd > 128 ? kKvTile256 : kKvTile;
}
constexpr int kKvThreads = 256, kKvWarps = kKvThreads / 32;
constexpr int kKvRows = 4;         // query rows a block (a row block)
constexpr float kKvFastScale = -100.0f;

// One layer's K or V cache seen as (B, G, T, ·) by element strides.
struct KvView {
  const uint8_t* codes;
  const uint8_t* signs;
  const float* scale;
  long long cb, cg, ct, sb, sg, st, lb, lg, lt;
};

// One element as _dequant: |x| = exp2(scale - (255 - c)·step), 0 for
// c = 0, negative where its sign bit is set; the previous kernel's form,
// kept as the reference of kv_dequant_rows_f32.
__device__ __forceinline__ float dequant1(uint32_t c, uint32_t neg, float sc,
                                          float step) {
  const float d = 255.0f - (float)c;
  const float mag = c == 0 ? 0.0f : exp2f(__fsub_rn(sc, __fmul_rn(d, step)));
  return neg ? -mag : mag;
}

// x in the cache's dequantized type: T's rounding, back in f32
template <typename T>
__device__ __forceinline__ float round_as(float x);
template <>
__device__ __forceinline__ float round_as<float>(float x) { return x; }
template <>
__device__ __forceinline__ float round_as<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float ex2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// byte U of x under the exponent byte of `magic` (the float 2^23 + byte)
template <int U>
__device__ __forceinline__ uint32_t magic_byte(uint32_t x, uint32_t magic) {
  uint32_t r;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(r) : "r"(x), "r"(magic),
      "n"(0x7440 | U));
  return r;
}

// Four elements of a cache row, bit for bit dequant1 then round_as<TQ>:
// codes c_u = byte u of `word`, sign u = bit u of `sgn`.  255 - c is c ^ 255
// for a byte, so one PRMT builds the float 2^23 + (255 - c) and one
// subtraction of 2^23 gives d exactly; the scale's two rounded operations
// stay; c = 0 (d = 255) selects +0; the sign is bit 31 (so c = 0 with its
// sign set is -0, as -mag); bf16 rounding is cvt.rn.bf16x2 on two values
// at once (round to nearest even, as __float2bfloat16_rn).  FAST: every
// exp2 argument of the tile is >= -126 (its scales are >= kKvFastScale and
// d·step <= 16.1), where exp2f is the single MUFU.EX2 that ex2.approx.ftz
// is; elsewhere exp2f itself.  dequant_mag4 gives the magnitudes (c = 0 as
// +0), dequant4 the signed values.
template <bool FAST>
__device__ __forceinline__ void dequant_mag4(uint32_t word, float sc,
                                             float step, float (&mag)[4]) {
  const uint32_t inv = ~word;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const uint32_t f = u == 0   ? magic_byte<0>(inv, 0x4b000000u)
                       : u == 1 ? magic_byte<1>(inv, 0x4b000000u)
                       : u == 2 ? magic_byte<2>(inv, 0x4b000000u)
                                : magic_byte<3>(inv, 0x4b000000u);
    const float d = __uint_as_float(f) - 8388608.0f;
    const float x = __fsub_rn(sc, __fmul_rn(d, step));
    const float m = FAST ? ex2_ftz(x) : exp2f(x);
    mag[u] = d == 255.0f ? 0.0f : m;
  }
}

template <typename TQ, bool FAST>
__device__ __forceinline__ void dequant4(uint32_t word, uint32_t sgn,
                                         float sc, float step, float (&v)[4]) {
  float mag[4];
  dequant_mag4<FAST>(word, sc, step, mag);
  uint32_t bits[4];
  if constexpr (std::is_same<TQ, float>::value) {
#pragma unroll
    for (int u = 0; u < 4; ++u) bits[u] = __float_as_uint(mag[u]);
  } else {  // two cvt.rn.bf16x2.f32, each value back in its f32 container
    const __nv_bfloat162 lo = __floats2bfloat162_rn(mag[0], mag[1]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(mag[2], mag[3]);
    const uint32_t l = *reinterpret_cast<const uint32_t*>(&lo);
    const uint32_t h = *reinterpret_cast<const uint32_t*>(&hi);
    bits[0] = l << 16, bits[1] = l & 0xffff0000u;
    bits[2] = h << 16, bits[3] = h & 0xffff0000u;
  }
#pragma unroll
  for (int u = 0; u < 4; ++u)
    v[u] = __uint_as_float(bits[u] | ((sgn << (31 - u)) & 0x80000000u));
}

// The same four elements of a bf16 cache as two packed bf16 pairs
// (elements 0, 1 in the first word, the lower half first), the signs in
// bits 15 and 31: the B fragment registers of an m16n8k16 bf16 MMA, the
// values dequant4<bf16> gives, with no unpacking.
template <bool FAST>
__device__ __forceinline__ void dequant4_bf16x2(uint32_t word, uint32_t sgn,
                                                float sc, float step,
                                                uint32_t (&b)[2]) {
  float mag[4];
  dequant_mag4<FAST>(word, sc, step, mag);
  const __nv_bfloat162 lo = __floats2bfloat162_rn(mag[0], mag[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(mag[2], mag[3]);
  b[0] = *reinterpret_cast<const uint32_t*>(&lo) | ((sgn << 15) & 0x8000u) |
         ((sgn << 30) & 0x80000000u);
  b[1] = *reinterpret_cast<const uint32_t*>(&hi) | ((sgn << 13) & 0x8000u) |
         ((sgn << 28) & 0x80000000u);
}

__host__ __device__ constexpr int kv_log2(int x) {
  return x > 1 ? 1 + kv_log2(x / 2) : 0;
}

// Bytes of one ring stage: codes of K, of V; signs of K, of V; scales of K,
// of V (every section a 16-byte multiple)
template <int HD>
__host__ __device__ constexpr int kv_stage_bytes() {
  return kv_tile(HD) * (2 * HD + 2 * (HD / 8) + 2 * 4);
}

// Cached dims a lane takes in QK^T, and the pitch (in floats) of a lane's
// share of a q row in shared memory: 4 floats of padding put the 8 lanes of
// a quarter warp on distinct banks
template <int HD>
__host__ __device__ constexpr int kv_kdims() {
  return HD < kKvKDims ? HD : kKvKDims;
}
template <int HD>
__host__ __device__ constexpr int kv_qpitch() {
  return kv_kdims<HD>() + 4;
}

template <int HD>
__host__ __device__ constexpr int kv_smem_bytes() {
  return kKvStages * kv_stage_bytes<HD>() +
         4 * (kKvRows * (HD / kv_kdims<HD>()) * kv_qpitch<HD>() +
              2 * kKvRows * kv_tile(HD) + kKvWarps * kKvRows + kKvRows);
}

// The passes of B11's partial kernel: kOnePass, the online softmax below (p
// rounded unnormalised); the KV_BF16 build of an f32 q runs kStats then
// kNormed (see the note at the top).
enum KvPass : int { kOnePass = 0, kStats = 1, kNormed = 2 };

// One block: query rows r0 .. r0 + 3 of one (batch, kv head) over the
// tokens [s0, s1) of its split, walked as tiles of kv_tile(HD) tokens through a
// ring of kKvStages cp.async stages that carry each tile's K and V codes,
// signs and scales together, so the next tiles are in flight while this one
// is dequantized and multiplied.  A tile:
//   * QK^T with a bf16 q (what serve runs): on the tensor cores, one
//     m16n8k16 MMA a 16-dim chunk of 8 tokens, q's 4 rows as the A
//     fragments in registers and each lane dequantizing one 32-bit code
//     word straight into its packed-bf16 B fragment (dequant4_bf16x2);
//     the reduction index is permuted within a chunk so a lane's four k
//     are four neighbouring dims, and products of bf16 are exact in the
//     MMA's f32 sums;
//   * QK^T with an f32 q: LPT = HD / kKvKDims lanes a token, each
//     dequantizing its kKvKDims elements once (one 16-byte code load for
//     16) against the four rows of q, read from shared memory as
//     broadcast float4s (in registers they would cost 64 and force
//     spills); the rows' partial dots are summed
//     over the token's lanes by a butterfly that halves the rows it carries
//     at each of its first two levels; scores go to shared memory (-2^30
//     past the split's last token);
//   * barrier; then each warp on its own: the tile's max of every row from
//     all scores, the running max m and the rescale exp(m - m_new) of its
//     accumulators, p = exp(s - m_new) for its own tokens (rounded to bf16
//     for a bf16 q, the f32 sum of the unrounded p kept a lane), then P·V
//     over the same tokens: 4 dims a lane (one 32-bit code load; 8 at hd =
//     256, two loads), the 4 rows' p as one broadcast float4;
//   * the block barrier at the top of the next tile both publishes that
//     tile's copies and frees the stage the next copy reuses.
// At the end the warps' accumulators and sums meet in shared memory (the
// ring's bytes) and the block writes its rows, normalised (one split) or as
// a partial (max, sum, P·V) for kvdq_combine_kernel.  The block reads pos
// itself: live = min(T, pos + 1), and its span by splits' rule with at most
// max_split spans; a split past the last span writes the neutral partial.
// PASS kStats copies no V, stops after each tile's max and sum, and writes
// its rows' (max, sum) to part_ml whatever n_split; kNormed reads them from
// there, so its p needs no running max (nothing is rescaled), and writes
// normalised rows (one split) or partials that the combine adds.
template <int HD, typename TQ, bool KV_BF16, int PASS>
__global__ void __launch_bounds__(kKvThreads, kKvBlocksSM)
kvdq_partial_kernel(const TQ* __restrict__ q, long long qb, long long qg,
                    long long qr, KvView kc, KvView vc, int sign_lw,
                    float* __restrict__ out, float* __restrict__ part_acc,
                    float* __restrict__ part_ml, int G, int rep, int n_rb,
                    const int* __restrict__ pos, int T, int max_split,
                    float scale, float step) {
  constexpr int TT = kv_tile(HD), S = kKvStages, R = kKvRows;
  constexpr int KD = kv_kdims<HD>(), QP = kv_qpitch<HD>();
  constexpr int LPT = HD / KD;        // QK^T: lanes a token
  constexpr int TPW = 32 / LPT;       // tokens a warp step
  constexpr int KPASS = (TT + kKvWarps * TPW - 1) / (kKvWarps * TPW);
  constexpr int DPL = HD > 128 ? HD / 32 : 4;  // P·V: dims a lane
  constexpr int LPV = HD / DPL;       // P·V: lanes a token
  constexpr int TPV = 32 / LPV;       // tokens a warp step
  constexpr int TW = TT / kKvWarps;   // P·V: tokens a warp owns a tile
  constexpr int SB = kv_stage_bytes<HD>();
  static_assert((KD == 8 || KD == 16) && LPT <= 32 && LPV <= 32,
                "hd in 16 .. 256; a lane's QK^T signs are one or two bytes");
  static_assert(TT % 64 == 0 && TW % TPV == 0, "whole warps of pairs");
  static_assert(S * SB >= 4 * kKvWarps * R * HD, "the ring holds the sums");
  extern __shared__ __align__(16) unsigned char kv_smem[];
  unsigned char* ring = kv_smem;
  float* q_s = reinterpret_cast<float*>(kv_smem + S * SB);   // [R][LPT][QP]
  float* sc_s = q_s + R * LPT * QP;                          // [R][TT] scores
  float* p_s = sc_s + R * TT;                                // [TT][R] p
  float* l_s = p_s + TT * R;                                 // [warps][R]
  float* m_s = l_s + kKvWarps * R;                           // [R]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bg = blockIdx.x / n_rb, rb = blockIdx.x % n_rb;
  const int b = bg / G, g = bg % G, r0 = rb * R;
  const int split = blockIdx.y, n_split = gridDim.y;
  // splits(blocks, live, slots, tile) of kv_dequant_attention.py, with
  // max_split = slots // blocks (pos + 1 taken after the clamp: no overflow)
  const int live = max(0, min(T - 1, __ldg(pos)) + 1);
  const int n_span = max(1, min(max_split, (live + TT - 1) / TT));
  const int span = ((live + n_span - 1) / n_span + TT - 1) / TT * TT;
  const int s0 = split * span, s1 = min(live, s0 + span);
  const int n_tiles = (s1 - s0 + TT - 1) / TT;
  const int rows = min(R, rep - r0);
  const long long slot = (long long)bg * n_split + split;
  if (n_split > 1 && s0 >= live) {  // past the live tokens: a neutral partial
    for (int e = tid; e < rows * HD; e += kKvThreads) {
      const int r = e / HD, d = e % HD;
      if (PASS != kStats) part_acc[(slot * rep + r0 + r) * HD + d] = 0.f;
      if (d == 0 && PASS != kNormed) {
        part_ml[(slot * rep + r0 + r) * 2] = kNegInf;
        part_ml[(slot * rep + r0 + r) * 2 + 1] = 0.f;
      }
    }
    return;
  }

  // f32 q: rows r0 .. r0 + 3 (0 past rep) in shared memory, a lane's KD
  // dims QP floats apart, published by the ring's first barrier.  bf16 q:
  // the A fragments of QK^T's MMAs in registers, row gq (0 past the 4
  // rows or rep), reduction index k of 16-dim chunk kc permuted so that
  // k = 2 tq, 2 tq + 1, 2 tq + 8, 2 tq + 9 are dims 16 kc + 4 tq + 0 .. 3,
  // the four codes of one 32-bit word (the B side reads them so)
  constexpr bool BF = !std::is_same<TQ, float>::value;
  static_assert(KV_BF16 || !BF, "a bf16 q rounds K/V and p to bf16");
  static_assert((PASS != kOnePass) == (KV_BF16 && !BF),
                "the KV_BF16 build of an f32 q rounds p normalised");
  // the type K/V and p are rounded to before their products
  using TK = typename std::conditional<KV_BF16, __nv_bfloat16, float>::type;
  constexpr int NC = HD / 16;
  const int li = lane % LPT, gq = lane >> 2, tq = lane & 3;
  uint32_t qa[BF ? NC : 1][2];
  if constexpr (BF) {
    const unsigned short* qp = reinterpret_cast<const unsigned short*>(
        q + b * qb + g * qg + (r0 + gq) * qr);
    const bool live_row = gq < R && r0 + gq < rep;
#pragma unroll
    for (int kc = 0; kc < NC; ++kc) {
      const int d = 16 * kc + 4 * tq;
      qa[kc][0] = live_row ? qp[d] | (uint32_t)qp[d + 1] << 16 : 0u;
      qa[kc][1] = live_row ? qp[d + 2] | (uint32_t)qp[d + 3] << 16 : 0u;
    }
  } else {
    const TQ* qp = q + b * qb + g * qg;
    for (int e = tid; e < R * HD; e += kKvThreads) {
      const int r = e / HD, d = e % HD;
      q_s[(r * LPT + d / KD) * QP + d % KD] =
          r0 + r < rep ? to_f32(qp[(r0 + r) * qr + d]) : 0.f;
    }
  }

  // Tile i's tokens into stage i % S; rows past s1 are not copied (nothing
  // reads them), nor V in kStats (NKV = 1: K alone).  A thread copies the same chunks of the same rows of every
  // tile, so its sources are fixed pointers, one tile further on each time.
  // Codes: 16-byte chunk cc of rows tc + k·TS.
  constexpr int CC = HD / 16, TS = kKvThreads / CC;
  constexpr int NKV = PASS == kStats ? 1 : 2;
  const int cc = tid % CC, tc = tid / CC;
  const uint8_t* const kcp = kc.codes + b * kc.cb + g * kc.cg +
                             (long long)(s0 + tc) * kc.ct + 16 * cc;
  const uint8_t* const vcp = vc.codes + b * vc.cb + g * vc.cg +
                             (long long)(s0 + tc) * vc.ct + 16 * cc;
  // signs: 1 << cs_l chunks of 1 << sign_lw bytes (16, 8 or 4 by cp.async,
  // 2 by a plain copy) a row of hd/8 bytes; thread tid takes chunk
  // tid % (1 << cs_l) of the rows tid >> cs_l + k·(256 >> cs_l) of K, then V
  const int cs_l = kv_log2(HD / 8) - sign_lw;
  const int s_off = (tid & ((1 << cs_l) - 1)) << sign_lw, s_row = tid >> cs_l;
  const uint8_t* const ksp = kc.signs + b * kc.sb + g * kc.sg +
                             (long long)s0 * kc.st + s_off;
  const uint8_t* const vsp = vc.signs + b * vc.sb + g * vc.sg +
                             (long long)s0 * vc.st + s_off;
  const float* const klp = kc.scale + b * kc.lb + g * kc.lg +
                           (long long)s0 * kc.lt;
  const float* const vlp = vc.scale + b * vc.lb + g * vc.lg +
                           (long long)s0 * vc.lt;
  auto copy_tile = [&](int i) {
    unsigned char* st = ring + (i % S) * SB;
    const int n = min(TT, s1 - s0 - i * TT);
#pragma unroll
    for (int k = 0; k < (TT + TS - 1) / TS; ++k) {
      const int t = tc + k * TS;
      if (t < n) {
        const int row = i * TT + k * TS;  // tokens past this thread's first
        cp_async16(st + t * HD + 16 * cc, kcp + (long long)row * kc.ct, 16);
        if (PASS != kStats)
          cp_async16(st + TT * HD + t * HD + 16 * cc,
                     vcp + (long long)row * vc.ct, 16);
      }
    }
    unsigned char* ss = st + 2 * TT * HD;
    for (int r = s_row; r < NKV * TT; r += kKvThreads >> cs_l) {
      const int t = r % TT;
      if (t < n) {
        const int row = i * TT + t;
        const uint8_t* src = r < TT ? ksp + (long long)row * kc.st
                                    : vsp + (long long)row * vc.st;
        unsigned char* dst = ss + r * (HD / 8) + s_off;
        if (sign_lw == 4)
          cp_async16(dst, src, 16);
        else if (sign_lw == 3)
          cp_async8(dst, src);
        else if (sign_lw == 2)
          cp_async4(dst, src);
        else
          *reinterpret_cast<uint16_t*>(dst) =
              *reinterpret_cast<const uint16_t*>(src);
      }
    }
    float* sl = reinterpret_cast<float*>(ss + 2 * TT * (HD / 8));
    for (int e = tid; e < NKV * TT; e += kKvThreads) {
      const int t = e % TT;
      if (t < n) {
        const int row = i * TT + t;
        cp_async4(sl + e, e < TT ? klp + (long long)row * kc.lt
                                 : vlp + (long long)row * vc.lt);
      }
    }
  };
  // after this thread's copies of tile i have landed: are the scales it
  // copied in the fast range (see dequant4)?
  auto fast_scales = [&](int i) {
    const float* sl = reinterpret_cast<const float*>(ring + (i % S) * SB +
                                                     2 * TT * HD +
                                                     2 * TT * (HD / 8));
    const int n = min(TT, s1 - s0 - i * TT);
    bool ok = true;
    for (int e = tid; e < NKV * TT; e += kKvThreads)
      if (e % TT < n) ok = ok && sl[e] >= kKvFastScale;
    return (int)ok;
  };

  // kNormed: the max M and sum L of row r0 + lane % R (the row of the p a
  // lane computes) over every split, weighed as the combine weighs them
  float nm = 0.f, nl = 1.f;
  if constexpr (PASS == kNormed) {
    const int r = lane & (R - 1);
    if (r0 + r < rep) {
      const float* mlp =
          part_ml + ((long long)bg * n_split * rep + r0 + r) * 2;
      float mx = kNegInf, sum = 0.f;
      for (int s = 0; s < n_split; ++s) mx = fmaxf(mx, mlp[s * rep * 2]);
      for (int s = 0; s < n_split; ++s)
        sum = fmaf(mlp[s * rep * 2 + 1], expf(mlp[s * rep * 2] - mx), sum);
      nm = mx;
      nl = fmaxf(sum, kLFloor);
    }
  }

  float m_run[R], acc[R][DPL], l_part = 0.f;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m_run[r] = kNegInf;
#pragma unroll
    for (int u = 0; u < DPL; ++u) acc[r][u] = 0.f;
  }

  auto tile = [&](int i, auto fast) {
    constexpr bool FAST = decltype(fast)::value;
    const unsigned char* st = ring + (i % S) * SB;
    const unsigned char* kcs = st;
    const unsigned char* vcs = st + TT * HD;
    const unsigned char* kss = st + 2 * TT * HD;
    const unsigned char* vss = kss + TT * (HD / 8);
    const float* kls = reinterpret_cast<const float*>(vss + TT * (HD / 8));
    const float* vls = kls + TT;
    const int n = min(TT, s1 - s0 - i * TT);

    // QK^T.  bf16 q: a warp takes groups of 8 tokens, lane (gq, tq)
    // dequantizing token gq's four dims 16 kc + 4 tq .. + 3 straight into
    // its B fragment, one m16n8k16 MMA a 16-dim chunk; rows 0 .. 3 of the
    // product are the scores (tokens 2 tq, 2 tq + 1 in lanes gq < 4)
    if constexpr (BF) {
#pragma unroll
      for (int grp = warp; grp < TT / 8; grp += kKvWarps) {
        const int t = grp * 8 + gq;
        const bool in = t < n;
        const float sc = in ? kls[t] : 0.f;
        float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int kc = 0; kc < NC; ++kc) {
          uint32_t w = 0u, sg = 0u;
          if (in) {
            w = *reinterpret_cast<const uint32_t*>(kcs + t * HD + 16 * kc +
                                                   4 * tq);
            sg = (uint32_t)*reinterpret_cast<const uint16_t*>(
                     kss + t * (HD / 8) + 2 * kc) >> (4 * tq);
          }
          uint32_t bk[2];
          dequant4_bf16x2<FAST>(w, sg, sc, step, bk);
          const uint32_t a[4] = {qa[kc][0], 0u, qa[kc][1], 0u};
          mma_bf16(c, a, bk[0], bk[1]);
        }
        if (gq < R) {
          const int tok = grp * 8 + 2 * tq;
          sc_s[gq * TT + tok] = tok < n ? c[0] * scale : kNegInf;
          sc_s[gq * TT + tok + 1] = tok + 1 < n ? c[1] * scale : kNegInf;
        }
      }
    } else {
#pragma unroll
      for (int pass = 0; pass < KPASS; ++pass) {
        const int t = (pass * kKvWarps + warp) * TPW + lane / LPT;
        const bool in = t < n;
        uint32_t w[KD / 4], sgn = 0;
        float sc = 0.f;
        if (in) {
          if constexpr (KD == 16) {
            const uint4 c4 =
                *reinterpret_cast<const uint4*>(kcs + t * HD + KD * li);
            w[0] = c4.x, w[1] = c4.y, w[2] = c4.z, w[3] = c4.w;
          } else {
            const uint2 c2 =
                *reinterpret_cast<const uint2*>(kcs + t * HD + KD * li);
            w[0] = c2.x, w[1] = c2.y;
          }
          if constexpr (KD == 16)
            sgn = *reinterpret_cast<const uint16_t*>(kss + t * (HD / 8) +
                                                     2 * li);
          else
            sgn = kss[t * (HD / 8) + li];
          sc = kls[t];
        } else {
#pragma unroll
          for (int c = 0; c < KD / 4; ++c) w[c] = 0u;
        }
        float dot[R];
#pragma unroll
        for (int r = 0; r < R; ++r) dot[r] = 0.f;
#pragma unroll
        for (int c = 0; c < KD / 4; ++c) {
          float kv[4];
          dequant4<TK, FAST>(w[c], sgn >> (4 * c), sc, step, kv);
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const float4 qv = *reinterpret_cast<const float4*>(
                q_s + (r * LPT + li) * QP + 4 * c);
            dot[r] = fmaf(qv.x, kv[0], dot[r]);
            dot[r] = fmaf(qv.y, kv[1], dot[r]);
            dot[r] = fmaf(qv.z, kv[2], dot[r]);
            dot[r] = fmaf(qv.w, kv[3], dot[r]);
          }
        }
        // the token's dots summed over its LPT lanes; after the first two
        // levels a lane carries one row, (lane bit LPT/2, bit LPT/4) = row
        if constexpr (LPT >= 4) {
          const bool hi = li & (LPT / 2), h2 = li & (LPT / 4);
          float k0 = hi ? dot[2] : dot[0], k1 = hi ? dot[3] : dot[1];
          const float s0v = hi ? dot[0] : dot[2], s1v = hi ? dot[1] : dot[3];
          k0 += __shfl_xor_sync(0xffffffffu, s0v, LPT / 2);
          k1 += __shfl_xor_sync(0xffffffffu, s1v, LPT / 2);
          float val = (h2 ? k1 : k0) +
                      __shfl_xor_sync(0xffffffffu, h2 ? k0 : k1, LPT / 4);
#pragma unroll
          for (int off = LPT / 8; off > 0; off >>= 1)
            val += __shfl_xor_sync(0xffffffffu, val, off);
          const int row = 2 * hi + h2;
          if (t < TT && (li & (LPT / 4 - 1)) == 0)
            sc_s[row * TT + t] = in ? val * scale : kNegInf;
        } else {
#pragma unroll
          for (int off = LPT / 2; off > 0; off >>= 1)
#pragma unroll
            for (int r = 0; r < R; ++r)
              dot[r] += __shfl_xor_sync(0xffffffffu, dot[r], off);
          if (t < TT && li == 0)
#pragma unroll
            for (int r = 0; r < R; ++r)
              sc_s[r * TT + t] = in ? dot[r] * scale : kNegInf;
        }
      }
    }
    __syncthreads();

    if constexpr (PASS == kNormed) {
      // p normalised, then rounded: bf16(exp(s - M) / L), as repro's
      // softmax(s).astype(bf16)
#pragma unroll
      for (int e = lane; e < TW * R; e += 32) {
        const int t = warp * TW + e / R;
        p_s[t * R + e % R] =
            round_as<TK>(expf(sc_s[(e % R) * TT + t] - nm) / nl);
      }
    } else {
      // the tile's max of each row (every warp the same), the new running
      // max, and p for this warp's TW tokens: pair e = (token e / R, row
      // e % R)
      float mt[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        mt[r] = kNegInf;
#pragma unroll
        for (int k = 0; k < TT / 32; ++k)
          mt[r] = fmaxf(mt[r], sc_s[r * TT + lane + 32 * k]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
#pragma unroll
        for (int r = 0; r < R; ++r)
          mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], off));
      float alpha[R], my_m = 0.f, my_a = 0.f;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float mn = fmaxf(m_run[r], mt[r]);
        alpha[r] = expf(m_run[r] - mn);
        m_run[r] = mn;
        if ((lane & (R - 1)) == r) {
          my_m = mn;
          my_a = alpha[r];
        }
      }
      l_part *= my_a;
#pragma unroll
      for (int e = lane; e < TW * R; e += 32) {
        const int t = warp * TW + e / R;
        const float pv = expf(sc_s[(e % R) * TT + t] - my_m);
        l_part += pv;
        if (PASS == kOnePass) p_s[t * R + e % R] = round_as<TK>(pv);
      }
      if constexpr (PASS == kStats) return;
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int u = 0; u < DPL; ++u) acc[r][u] *= alpha[r];
    }
    __syncwarp();

    // P·V over the warp's tokens
    const int d0 = DPL * (lane % LPV);
#pragma unroll
    for (int k = 0; k < TW; k += TPV) {
      const int t = warp * TW + k + lane / LPV;
      if (t < n) {
        const float4 p4 = *reinterpret_cast<const float4*>(p_s + t * R);
        const float pr[R] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
        for (int c = 0; c < DPL / 4; ++c) {
          const int d = d0 + 4 * c;
          const uint32_t cw =
              *reinterpret_cast<const uint32_t*>(vcs + t * HD + d);
          const uint32_t sgn = vss[t * (HD / 8) + (d >> 3)] >> (d & 7);
          float vv[4];
          dequant4<TK, FAST>(cw, sgn, vls[t], step, vv);
#pragma unroll
          for (int r = 0; r < R; ++r)
#pragma unroll
            for (int u = 0; u < 4; ++u)
              acc[r][4 * c + u] = fmaf(pr[r], vv[u], acc[r][4 * c + u]);
        }
      }
    }
  };

  // the ring: tile i + S - 1 in flight during tile i; its barrier also
  // votes on the fast exp2
  ring_walk<S>(
      n_tiles, copy_tile,
      [&](int i) { return __syncthreads_and(fast_scales(i)); },
      [&](int i, int fast) {
        if (fast)
          tile(i, std::true_type{});
        else
          tile(i, std::false_type{});
      });
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: the sums meet in its bytes

  float* red = reinterpret_cast<float*>(ring);  // [warps][R][HD]
  if constexpr (PASS != kStats) {
#pragma unroll
    for (int off = LPV; off < 32; off <<= 1)
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int u = 0; u < DPL; ++u)
          acc[r][u] += __shfl_xor_sync(0xffffffffu, acc[r][u], off);
    if (lane < LPV) {
      const int d0 = DPL * lane;
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int c = 0; c < DPL / 4; ++c)
          *reinterpret_cast<float4*>(red + (warp * R + r) * HD + d0 + 4 * c) =
              make_float4(acc[r][4 * c], acc[r][4 * c + 1], acc[r][4 * c + 2],
                          acc[r][4 * c + 3]);
    }
  }
#pragma unroll
  for (int off = R; off < 32; off <<= 1)
    l_part += __shfl_xor_sync(0xffffffffu, l_part, off);
  if (lane < R) l_s[warp * R + lane] = l_part;
  if (tid == 0)
#pragma unroll
    for (int r = 0; r < R; ++r) m_s[r] = m_run[r];
  __syncthreads();

  if constexpr (PASS == kStats) {
    for (int r = tid; r < rows; r += kKvThreads) {
      float l = 0.f;
#pragma unroll
      for (int w = 0; w < kKvWarps; ++w) l += l_s[w * R + r];
      part_ml[(slot * rep + r0 + r) * 2] = m_s[r];
      part_ml[(slot * rep + r0 + r) * 2 + 1] = l;
    }
    return;
  }
  for (int e = tid; e < rows * HD; e += kKvThreads) {
    const int r = e / HD, d = e % HD;
    float s = 0.f, l = 0.f;
#pragma unroll
    for (int w = 0; w < kKvWarps; ++w) {
      s += red[(w * R + r) * HD + d];
      l += l_s[w * R + r];
    }
    if (PASS == kNormed) {  // normalised already
      if (n_split == 1)
        out[((long long)bg * rep + r0 + r) * HD + d] = s;
      else
        part_acc[(slot * rep + r0 + r) * HD + d] = s;
    } else if (n_split == 1) {
      out[((long long)bg * rep + r0 + r) * HD + d] = s / fmaxf(l, kLFloor);
    } else {
      part_acc[(slot * rep + r0 + r) * HD + d] = s;
      if (d == 0) {
        part_ml[(slot * rep + r0 + r) * 2] = m_s[r];
        part_ml[(slot * rep + r0 + r) * 2 + 1] = l;
      }
    }
  }
}

// The partials of every split combined by their maxima (flash-decoding); a
// neutral partial (m = -2^30, l = 0, P·V = 0) weighs exp(-2^30 - max) = 0.
// `summed`: kNormed's partials, normalised already, are added in split order.
__global__ void __launch_bounds__(kKvThreads)
kvdq_combine_kernel(const float* __restrict__ part_acc,
                    const float* __restrict__ part_ml, float* __restrict__ out,
                    int n_split, int rep, int hd, int summed) {
  const int bg = blockIdx.x;
  for (int e = threadIdx.x; e < rep * hd; e += kKvThreads) {
    const int r = e / hd, d = e % hd;
    if (summed) {
      float a = 0.f;
      for (int s = 0; s < n_split; ++s)
        a += part_acc[(((long long)bg * n_split + s) * rep + r) * hd + d];
      out[((long long)bg * rep + r) * hd + d] = a;
      continue;
    }
    const float* mlp = part_ml + ((long long)bg * n_split * rep + r) * 2;
    float mx = kNegInf;
    for (int s = 0; s < n_split; ++s) mx = fmaxf(mx, mlp[s * rep * 2]);
    float sum = 0.f, a = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const float w = expf(mlp[s * rep * 2] - mx);
      sum = fmaf(mlp[s * rep * 2 + 1], w, sum);
      a = fmaf(part_acc[(((long long)bg * n_split + s) * rep + r) * hd + d], w, a);
    }
    out[((long long)bg * rep + r) * hd + d] = a / fmaxf(sum, kLFloor);
  }
}

// log2 of the widest copy (16, 8, 4 or 2 bytes) that divides a sign row of
// hd/8 bytes, its base and its three strides (the wrapper checks 2)
int sign_log_width(const KvView& v, int hd) {
  for (int lw = 4; lw >= 2; --lw) {
    const int w = 1 << lw;
    if ((hd / 8) % w == 0 && reinterpret_cast<uintptr_t>(v.signs) % w == 0 &&
        v.sb % w == 0 && v.sg % w == 0 && v.st % w == 0)
      return lw;
  }
  return 1;
}

// The KV_BF16 build of an f32 q rounds p normalised: two passes (KvPass)
template <typename TQ, bool KV_BF16>
constexpr bool kv_normed() {
  return KV_BF16 && std::is_same<TQ, float>::value;
}

template <int HD, typename TQ, bool KV_BF16, int PASS>
cudaError_t launch_kvdq_pass(const void* q, const long long* qst,
                             const KvView& kc, const KvView& vc, float* out,
                             float* part_acc, float* part_ml, int B, int G,
                             int rep, const int* pos, int T, int n_split,
                             int max_split, cudaStream_t stream) {
  constexpr auto kernel = kvdq_partial_kernel<HD, TQ, KV_BF16, PASS>;
  const int smem = kv_smem_bytes<HD>();
  cudaError_t err = smem_once<kernel>(smem);
  if (err != cudaSuccess) return err;
  const int sw = sign_log_width(kc, HD), vw = sign_log_width(vc, HD);
  const int n_rb = (rep + kKvRows - 1) / kKvRows;
  kernel<<<dim3((unsigned)(B * G * n_rb), (unsigned)n_split), kKvThreads,
           smem, stream>>>(
      static_cast<const TQ*>(q), qst[0], qst[1], qst[2], kc, vc,
      sw < vw ? sw : vw, out, part_acc, part_ml, G, rep, n_rb, pos, T,
      max_split, 1.0f / sqrtf((float)HD), 16.0f / 254.0f);
  return cudaGetLastError();
}

template <int HD, typename TQ, bool KV_BF16>
cudaError_t launch_kvdq(const void* q, const long long* qst, const KvView& kc,
                        const KvView& vc, float* out, float* part_acc,
                        float* part_ml, int B, int G, int rep, const int* pos,
                        int T, int n_split, int max_split,
                        cudaStream_t stream) {
  constexpr bool NORMED = kv_normed<TQ, KV_BF16>();
  cudaError_t err;
  if constexpr (NORMED) {
    err = launch_kvdq_pass<HD, TQ, KV_BF16, kStats>(
        q, qst, kc, vc, out, part_acc, part_ml, B, G, rep, pos, T, n_split,
        max_split, stream);
    if (err != cudaSuccess) return err;
    err = launch_kvdq_pass<HD, TQ, KV_BF16, kNormed>(
        q, qst, kc, vc, out, part_acc, part_ml, B, G, rep, pos, T, n_split,
        max_split, stream);
  } else {
    err = launch_kvdq_pass<HD, TQ, KV_BF16, kOnePass>(
        q, qst, kc, vc, out, part_acc, part_ml, B, G, rep, pos, T, n_split,
        max_split, stream);
  }
  if (err != cudaSuccess || n_split == 1) return err;
  kvdq_combine_kernel<<<(unsigned)(B * G), kKvThreads, 0, stream>>>(
      part_acc, part_ml, out, n_split, rep, HD, (int)NORMED);
  return cudaGetLastError();
}

template <typename TQ, bool KV_BF16>
cudaError_t dispatch_kvdq(const void* q, const long long* qst,
                          const KvView& kc, const KvView& vc, float* out,
                          float* part_acc, float* part_ml, int B, int G,
                          int rep, int hd, const int* pos, int T, int n_split,
                          int max_split, cudaStream_t s) {
  switch (hd) {
    case 16: return launch_kvdq<16, TQ, KV_BF16>(q, qst, kc, vc, out, part_acc, part_ml, B, G, rep, pos, T, n_split, max_split, s);
    case 32: return launch_kvdq<32, TQ, KV_BF16>(q, qst, kc, vc, out, part_acc, part_ml, B, G, rep, pos, T, n_split, max_split, s);
    case 64: return launch_kvdq<64, TQ, KV_BF16>(q, qst, kc, vc, out, part_acc, part_ml, B, G, rep, pos, T, n_split, max_split, s);
    case 128: return launch_kvdq<128, TQ, KV_BF16>(q, qst, kc, vc, out, part_acc, part_ml, B, G, rep, pos, T, n_split, max_split, s);
    case 256: return launch_kvdq<256, TQ, KV_BF16>(q, qst, kc, vc, out, part_acc, part_ml, B, G, rep, pos, T, n_split, max_split, s);
    default: return cudaErrorInvalidValue;
  }
}

template <int HD, typename TQ, bool KV_BF16>
int kvdq_slots() {
  int dev = 0, sms = 0, per_sm = 0;
  constexpr auto kernel =
      kvdq_partial_kernel<HD, TQ, KV_BF16,
                          kv_normed<TQ, KV_BF16>() ? kNormed : kOnePass>;
  const int smem = kv_smem_bytes<HD>();
  cudaError_t err = smem_once<kernel>(smem);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kKvThreads, smem);
  return err == cudaSuccess ? sms * per_sm : -(int)err;
}

template <typename TQ, bool KV_BF16>
int kvdq_slots_hd(int hd) {
  switch (hd) {
    case 16: return kvdq_slots<16, TQ, KV_BF16>();
    case 32: return kvdq_slots<32, TQ, KV_BF16>();
    case 64: return kvdq_slots<64, TQ, KV_BF16>();
    case 128: return kvdq_slots<128, TQ, KV_BF16>();
    case 256: return kvdq_slots<256, TQ, KV_BF16>();
    default: return -(int)cudaErrorInvalidValue;
  }
}

// The check of dequant4 (and, for bf16, of dequant4_bf16x2) against
// dequant1 + round_as: every element of contiguous (rows, hd) codes /
// (rows, hd/8) signs / (rows,) scales, both ways; each row takes the fast
// form where its scale allows it.
template <typename TQ>
__global__ void kv_dequant_rows_kernel(const uint8_t* __restrict__ codes,
                                       const uint8_t* __restrict__ signs,
                                       const float* __restrict__ scale,
                                       float* __restrict__ got,
                                       float* __restrict__ want,
                                       long long rows, int hd, float step) {
  const long long n = rows * (hd / 4);
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += (long long)gridDim.x * blockDim.x) {
    const long long row = e / (hd / 4);
    const int d0 = 4 * (int)(e % (hd / 4));
    const uint32_t w =
        *reinterpret_cast<const uint32_t*>(codes + row * hd + d0);
    const uint32_t sg = signs[row * (hd / 8) + (d0 >> 3)] >> (d0 & 7);
    const float sc = scale[row];
    float v[4];
    uint32_t bb[2] = {0u, 0u};
    if (sc >= kKvFastScale) {
      dequant4<TQ, true>(w, sg, sc, step, v);
      dequant4_bf16x2<true>(w, sg, sc, step, bb);
    } else {
      dequant4<TQ, false>(w, sg, sc, step, v);
      dequant4_bf16x2<false>(w, sg, sc, step, bb);
    }
    if constexpr (!std::is_same<TQ, float>::value) {
      // the packed pairs QK^T's MMAs read must be the same values: any
      // difference turns got into a NaN that the bitwise check reports
      const uint32_t unpacked[4] = {bb[0] << 16, bb[0] & 0xffff0000u,
                                    bb[1] << 16, bb[1] & 0xffff0000u};
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (unpacked[u] != __float_as_uint(v[u]))
          v[u] = __uint_as_float(0x7fc00000u);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      got[row * hd + d0 + u] = v[u];
      want[row * hd + d0 + u] = round_as<TQ>(
          dequant1((w >> (8 * u)) & 255u, (sg >> u) & 1u, sc, step));
    }
  }
}

KvView make_view(const void* codes, const long long* cst, const void* signs,
                 const long long* sst, const void* scale,
                 const long long* lst) {
  return KvView{static_cast<const uint8_t*>(codes),
                static_cast<const uint8_t*>(signs),
                static_cast<const float*>(scale),
                cst[0], cst[1], cst[2], sst[0], sst[1], sst[2],
                lst[0], lst[1], lst[2]};
}

}  // namespace

extern "C" {

// Each entry returns the cudaError_t of its launches (0 = launched).
// Strides are in elements, each array of three is (batch, head, sequence);
// the last axis of every operand is contiguous.  bf16 = 1 means q/k/v (and
// the output) are bfloat16, else float32.

// B10.  q (B, S, Hq, hd), k/v (B, T, G, hd), o (B, S, Hq, hd): S query
// rows over T keys (kv_seq; keys at or past T are masked); hd in
// {16, 32, 64, 128, 256}; Hq a multiple of G; window W > 0 masks the keys
// W or more below a row (i - j >= W), 0 none.  causal or a window needs
// T == S (the diagonal is the self-attention's).
int flash_attention_fwd(const void* q, const long long* q_st, const void* k,
                        const long long* k_st, const void* v,
                        const long long* v_st, void* o, const long long* o_st,
                        int batch, int seq, int kv_seq, int heads,
                        int kv_heads, int hd, int causal, int window,
                        int bf16, void* stream) {
  if (batch <= 0 || seq <= 0 || kv_seq <= 0 || kv_heads <= 0 ||
      heads % kv_heads != 0 || window < 0 ||
      ((causal || window) && kv_seq != seq))
    return (int)cudaErrorInvalidValue;
  return (int)dispatch_flash(bf16, q, q_st, k, k_st, v, v_st, o, o_st, batch,
                             seq, kv_seq, heads, kv_heads, hd, causal, window,
                             static_cast<cudaStream_t>(stream));
}

// B11.  q (B, G, rep, hd) f32 or bf16 (bf16 = 1); kv_bf16 = 1 rounds the
// dequantized K/V and p to bf16 for an f32 q too (a bf16 q always rounds
// them), p after its normalisation in two passes (part_ml then holds the
// splits' maxima and sums whatever n_split); each cache operand (B, G, T, ·):
// codes uint8 (·, hd) with 16-byte aligned rows, signs uint8 (·, hd/8) with
// 2-byte aligned rows, scale f32 (·, 1); out (B, G, rep, hd) f32
// contiguous; hd in {16, 32, 64, 128, 256}; pos one int32 in device memory.
// The grid is n_split blocks deep for every (b, g) and block of kKvRows
// query rows; each block reads pos and takes its span of the tokens j <
// live = min(T, pos + 1) by splits' rule with at most max_split spans (a
// grid of max(1, min(max_split, ceil(T / tile))) serves every pos); with
// more than one split, part_acc (B·G, n_split, rep, hd) and part_ml (B·G,
// n_split, rep, 2) are f32 scratch.
int kv_dequant_decode_attention_fwd(
    const void* q, const long long* q_st, const void* ck, const long long* ck_st,
    const void* sk, const long long* sk_st, const void* lk,
    const long long* lk_st, const void* cv, const long long* cv_st,
    const void* sv, const long long* sv_st, const void* lv,
    const long long* lv_st, float* out, float* part_acc, float* part_ml,
    int batch, int kv_heads, int rep, int hd, const int* pos, int T,
    int n_split, int max_split, int bf16, int kv_bf16, void* stream) {
  if (batch <= 0 || kv_heads <= 0 || rep <= 0 || T <= 0 || hd < 16 ||
      hd > 256 || (hd & (hd - 1)) || n_split <= 0 || max_split < n_split ||
      pos == nullptr || (n_split > 1 && (part_acc == nullptr ||
                                         part_ml == nullptr)) ||
      (kv_bf16 && !bf16 && part_ml == nullptr))
    return (int)cudaErrorInvalidValue;
  const KvView kc = make_view(ck, ck_st, sk, sk_st, lk, lk_st);
  const KvView vc = make_view(cv, cv_st, sv, sv_st, lv, lv_st);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return (int)dispatch_kvdq<__nv_bfloat16, true>(
        q, q_st, kc, vc, out, part_acc, part_ml, batch, kv_heads, rep, hd, pos,
        T, n_split, max_split, s);
  if (kv_bf16)
    return (int)dispatch_kvdq<float, true>(q, q_st, kc, vc, out, part_acc,
                                           part_ml, batch, kv_heads, rep, hd,
                                           pos, T, n_split, max_split, s);
  return (int)dispatch_kvdq<float, false>(q, q_st, kc, vc, out, part_acc,
                                          part_ml, batch, kv_heads, rep, hd,
                                          pos, T, n_split, max_split, s);
}

// Blocks of B11's partial kernel the card runs at once (SMs times blocks an
// SM) for head dim hd, q's type and the kv_bf16 build, a negative
// cudaError_t on failure; and its tiling: tokens a tile (a span is best whole
// tiles) and query rows a block.
int kv_dequant_decode_attention_slots(int hd, int bf16, int kv_bf16,
                                      int* tile, int* rows) {
  *tile = kv_tile(hd);
  *rows = kKvRows;
  if (bf16) return kvdq_slots_hd<__nv_bfloat16, true>(hd);
  return kv_bf16 ? kvdq_slots_hd<float, true>(hd)
                 : kvdq_slots_hd<float, false>(hd);
}

// B11's dequantize on its own, for the check that it equals the previous
// form bit for bit: contiguous (rows, hd) codes, (rows, hd/8) signs, (rows,)
// scales -> got (dequant4) and want (dequant1 + round_as), both (rows, hd)
// f32; bf16 = 1 rounds as for a bf16 q.
int kv_dequant_rows_f32(const void* codes, const void* signs,
                        const float* scale, float* got, float* want,
                        long long rows, int hd, int bf16, void* stream) {
  if (rows <= 0 || hd < 16 || hd % 16) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n = rows * (hd / 4);
  const long long need = (n + 255) / 256;
  const unsigned blocks = (unsigned)(need < 4096 ? need : 4096);
  const float step = 16.0f / 254.0f;
  if (bf16)
    kv_dequant_rows_kernel<__nv_bfloat16><<<blocks, 256, 0, s>>>(
        static_cast<const uint8_t*>(codes), static_cast<const uint8_t*>(signs),
        scale, got, want, rows, hd, step);
  else
    kv_dequant_rows_kernel<float><<<blocks, 256, 0, s>>>(
        static_cast<const uint8_t*>(codes), static_cast<const uint8_t*>(signs),
        scale, got, want, rows, hd, step);
  return (int)cudaGetLastError();
}

const char* attention_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
