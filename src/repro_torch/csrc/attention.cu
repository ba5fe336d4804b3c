// Attention for Hopper (sm_90a): the LM serving path's two attention cores.
//
// flash_bf16_kernel / flash_f32_kernel replace
// repro/kernels/flash_attention.py::flash_attention (kernel body
// _flash_kernel, pl.pallas_call at :90): causal (or full) online-softmax
// attention, scale hd^-0.5, masked scores -2^30, a floor of 1e-30 on the
// softmax sum, K tiles wholly above the diagonal skipped.  One kernel per
// input type serves the TPU signature (BH, S, hd) and the model's layout:
// q (B, S, Hq, hd) and k/v (B, S, G, hd), all by strides, where query head h
// reads kv head h / rep (rep = Hq / G, the grouping of _gqa_scores).  No
// replicated KV heads and no (BH, S, hd) copy are made.
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
//     end (the longest rows) launch first, to shorten the tail.
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
// What bounds it: bytes.  Each cached token costs hd + hd/8 + 4 bytes for
// K and the same for V against 4·rep·hd FMAs, ~2 FMA per byte.  The TPU grid
// is (B·G,): 64 blocks at the serving shape, too few to keep 132 SMs'
// loads in flight.  So the grid is (B·G, splits): a block takes 256 tokens
// of one (batch, kv head), keeps its rep query rows in shared memory, and
// leaves the chunk's (max, sum, P·V) to a combine kernel (flash-decoding);
// with one split the block writes the result itself.  Registers are capped
// for two blocks an SM.  Chunks past pos are not launched: their tokens are
// masked, so they would add exactly 0.
// Within a chunk, QK^T takes one token a thread: its codes come as 16-byte
// words and its sign bits as 16-bit words, all loads issued before any
// use, and no shuffles are needed; P·V spreads a token over hd/4 lanes (4
// codes a 32-bit load, tokens in flight unrolled by 4) and sums the lane
// groups through shared memory.  The dequantize uses __fmul_rn/__fsub_rn so
// nvcc cannot fuse it into an FMA the plain version does not do.
// Rounding follows q's type, as repro's serving decode does (the cache
// dequantizes to the model's dtype, dequantize_kv; _gqa_out rounds the
// probabilities to v's): for a bf16 q each dequantized K and V element is
// rounded to bf16 (nearest even) before its products, and p = exp(s - m)
// to bf16 before P·V, unnormalised, divided by the f32 sum of the unrounded
// p; the sums stay f32.  For an f32 q nothing is rounded.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1073741824.0f;  // -2^30, the TPU kernels' mask
constexpr float kLFloor = 1e-30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// ---------------------------------------------------------------- B10 -----

constexpr int kFThreads = 128;  // 4 warps

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full) {
  // src-size 0 zero-fills the 16 bytes (rows past S)
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(full ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

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
      cp_async16(dst + r * P + c * E, in ? src + s * rs + c * E : src, in);
    }
  } else {
    for (int e = threadIdx.x; e < ROWS * D; e += kFThreads) {
      const int r = e / D, d = e % D, s = s0 + r;
      dst[r * P + d] = s < S ? src[s * rs + d] : zero<T>();
    }
  }
}

// Scores of n-tile j (keys k0 + 8j + 2t + {0, 1}) for rows r0 (c0, c1) and
// r0 + 8 (c2, c3) set to -2^30 where masked: past S, or above the diagonal.
template <int NJ>
__device__ __forceinline__ void mask_scores(float (&sc)[NJ][4], int k0,
                                            int r0, int t, int S,
                                            int causal) {
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int key = k0 + 8 * j + 2 * t + (u & 1);
      const int row = r0 + 8 * (u >> 1);
      if (key >= S || (causal && key > row)) sc[j][u] = kNegInf;
    }
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
// chip_tiles.py tries (PERF.md §6).
constexpr int kMTh = 2, kBKh = 64;  // bf16
constexpr int kMTf = 2, kBKf = 16;  // f32

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
                  long long ob, long long os, long long oh, int S, int Hq,
                  int rep, int causal, float sl2, int vec) {
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

  int n_kt = (S + BK - 1) / BK;
  if (causal) n_kt = min(n_kt, (q0 + BQ + BK - 1) / BK);
  load_tile<BQ, D, P>(Qs, qp, qs, q0, S, vec);
  load_tile<BK, D, P>(Ks, kp, ks, 0, S, vec);
  load_tile<BK, D, P>(Vs, vp, vs, 0, S, vec);
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

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK, buf = kt & 1;
    if (kt + 1 < n_kt) {
      load_tile<BK, D, P>(Ks + (buf ^ 1) * BK * P, kp, ks, k0 + BK, S, vec);
      load_tile<BK, D, P>(Vs + (buf ^ 1) * BK * P, vp, vs, k0 + BK, S, vec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    // a warp whose rows all lie above the tile's first key has nothing here
    if (!(causal && k0 > w1)) {
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
        if (k0 + BK > S || (causal && k0 + BK - 1 > w0 + 64 * i))
          mask_scores(sc[i], k0, w0 + 64 * i + g, t, S, causal);
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
                 long long oh, int S, int Hq, int rep, int causal, float sl2,
                 int vec) {
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

  int n_kt = (S + BK - 1) / BK;
  if (causal) n_kt = min(n_kt, (q0 + BQ + BK - 1) / BK);
  load_tile<BQ, D, PK>(Qs, qp, qs, q0, S, vec);
  load_tile<BK, D, PK>(Ks, kp, ks, 0, S, vec);
  load_tile<BK, D, PV>(Vs, vp, vs, 0, S, vec);
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

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK, buf = kt & 1;
    if (kt + 1 < n_kt) {
      load_tile<BK, D, PK>(Ks + (buf ^ 1) * BK * PK, kp, ks, k0 + BK, S, vec);
      load_tile<BK, D, PV>(Vs + (buf ^ 1) * BK * PV, vp, vs, k0 + BK, S, vec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (!(causal && k0 > w1)) {
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
        if (k0 + BK > S || (causal && k0 + BK - 1 > w0 + 64 * i))
          mask_scores(sc[i], k0, w0 + 64 * i + g, t, S, causal);
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

template <typename T, typename Kernel>
cudaError_t launch_flash(Kernel kernel, int smem, int bq, const void* q,
                         const long long* qst, const void* k,
                         const long long* kst, const void* v,
                         const long long* vst, void* o, const long long* ost,
                         int B, int S, int Hq, int G, int D, int causal,
                         cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int vec = aligned16(q, qst, sizeof(T)) &&
                  aligned16(k, kst, sizeof(T)) && aligned16(v, vst, sizeof(T));
  const dim3 grid((unsigned)(B * Hq), (unsigned)((S + bq - 1) / bq));
  kernel<<<grid, kFThreads, smem, stream>>>(
      static_cast<const T*>(q), qst[0], qst[1], qst[2],
      static_cast<const T*>(k), kst[0], kst[1], kst[2],
      static_cast<const T*>(v), vst[0], vst[1], vst[2], static_cast<T*>(o),
      ost[0], ost[1], ost[2], S, Hq, Hq / G, causal,
      1.4426950408889634f / sqrtf((float)D), vec);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_flash_d(int bf16, const void* q, const long long* qst,
                           const void* k, const long long* kst,
                           const void* v, const long long* vst, void* o,
                           const long long* ost, int B, int S, int Hq, int G,
                           int causal, cudaStream_t s) {
  if (bf16)
    return launch_flash<__nv_bfloat16>(
        flash_bf16_kernel<D, kMTh, kBKh>,
        flash_bf16_smem<D, kMTh, kBKh>(), 64 * kMTh, q, qst, k, kst, v, vst,
        o, ost, B, S, Hq, G, D, causal, s);
  return launch_flash<float>(
      flash_f32_kernel<D, kMTf, kBKf>, flash_f32_smem<D, kMTf, kBKf>(),
      64 * kMTf, q, qst, k, kst, v, vst, o, ost, B, S, Hq, G, D, causal, s);
}

cudaError_t dispatch_flash(int bf16, const void* q, const long long* qst,
                           const void* k, const long long* kst,
                           const void* v, const long long* vst, void* o,
                           const long long* ost, int B, int S, int Hq, int G,
                           int hd, int causal, cudaStream_t s) {
  switch (hd) {
    case 16: return launch_flash_d<16>(bf16, q, qst, k, kst, v, vst, o, ost, B, S, Hq, G, causal, s);
    case 32: return launch_flash_d<32>(bf16, q, qst, k, kst, v, vst, o, ost, B, S, Hq, G, causal, s);
    case 64: return launch_flash_d<64>(bf16, q, qst, k, kst, v, vst, o, ost, B, S, Hq, G, causal, s);
    case 128: return launch_flash_d<128>(bf16, q, qst, k, kst, v, vst, o, ost, B, S, Hq, G, causal, s);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------- B11 -----

constexpr int kDThreads = 256;
constexpr int kChunk = kDThreads;  // tokens per block: one a thread in QK^T
constexpr int kRB = 8;             // query rows per pass

// One layer's K or V cache seen as (B, G, T, ·) by element strides.
struct KvView {
  const uint8_t* codes;
  const uint8_t* signs;
  const float* scale;
  long long cb, cg, ct, sb, sg, st, lb, lg, lt;
};

// One element exactly as _dequant: |x| = exp2(scale - (255 - c)·step), 0
// for c = 0, negative where its sign bit is set.
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

__host__ __device__ constexpr int kvdq_smem_floats(int rep, int hd) {
  return rep * hd + rep * kChunk + kDThreads * 4 * kRB + 2 * rep;
}

template <int HD, typename TQ>
__global__ void __launch_bounds__(kDThreads, 2)
kvdq_partial_kernel(const TQ* __restrict__ q, long long qb, long long qg,
                    long long qr, KvView kc, KvView vc, float* __restrict__ out,
                    float* __restrict__ part_acc, float* __restrict__ part_ml,
                    int G, int rep, int T, int pos, float scale, float step) {
  constexpr int LPT = HD / 4;            // P·V: lanes a token, 4 elements each
  constexpr int GROUPS = kDThreads / LPT;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                      // [rep][HD]
  float* ps = qs + rep * HD;             // [rep][kChunk] scores, then p
  float* red = ps + rep * kChunk;        // [GROUPS][kRB][HD] partial P·V
  float* ml = red + kDThreads * 4 * kRB; // [rep][2] chunk max and sum

  const int tid = threadIdx.x;
  const int bg = blockIdx.x, split = blockIdx.y, n_split = gridDim.y;
  const int b = bg / G, g = bg % G;
  const int t0 = split * kChunk;
  const int t_end = min(t0 + kChunk, min(T, pos + 1));  // tokens j <= pos

  const TQ* qp = q + b * qb + g * qg;
  for (int e = tid; e < rep * HD; e += kDThreads)
    qs[e] = to_f32(qp[(e / HD) * qr + e % HD]);
  __syncthreads();

  // QK^T: one token a thread, its codes read as 16-byte words and its K
  // row dequantized once a pass of kRB query rows
  {
    const int t = t0 + tid;
    const bool live = t < t_end;
    const uint8_t* crow = kc.codes + b * kc.cb + g * kc.cg + (long long)t * kc.ct;
    const uint8_t* srow = kc.signs + b * kc.sb + g * kc.sg + (long long)t * kc.st;
    const float sc = live ? kc.scale[b * kc.lb + g * kc.lg + (long long)t * kc.lt] : 0.f;
    uint4 cw[HD / 16];
    uint32_t sw[HD / 16];
#pragma unroll
    for (int c = 0; c < HD / 16; ++c) {
      cw[c] = live ? reinterpret_cast<const uint4*>(crow)[c] : make_uint4(0, 0, 0, 0);
      sw[c] = live ? reinterpret_cast<const uint16_t*>(srow)[c] : 0u;
    }
    for (int r0 = 0; r0 < rep; r0 += kRB) {
      float dot[kRB];
#pragma unroll
      for (int rr = 0; rr < kRB; ++rr) dot[rr] = 0.f;
#pragma unroll
      for (int c = 0; c < HD / 16; ++c) {
        const uint32_t words[4] = {cw[c].x, cw[c].y, cw[c].z, cw[c].w};
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          float kv[4];
#pragma unroll
          for (int u = 0; u < 4; ++u)
            kv[u] = round_as<TQ>(dequant1((words[w] >> (8 * u)) & 255u,
                                          (sw[c] >> (4 * w + u)) & 1u, sc,
                                          step));
          const int d = 16 * c + 4 * w;
#pragma unroll
          for (int rr = 0; rr < kRB; ++rr) {
            if (r0 + rr < rep) {
              const float4 qv =
                  *reinterpret_cast<const float4*>(&qs[(r0 + rr) * HD + d]);
              dot[rr] = fmaf(qv.x, kv[0], dot[rr]);
              dot[rr] = fmaf(qv.y, kv[1], dot[rr]);
              dot[rr] = fmaf(qv.z, kv[2], dot[rr]);
              dot[rr] = fmaf(qv.w, kv[3], dot[rr]);
            }
          }
        }
      }
#pragma unroll
      for (int rr = 0; rr < kRB; ++rr)
        if (r0 + rr < rep)
          ps[(r0 + rr) * kChunk + tid] = live ? dot[rr] * scale : kNegInf;
    }
  }
  __syncthreads();

  // per row: the chunk's max, p = exp(s - max), and its sum
  const int warp = tid >> 5, wl = tid & 31;
  for (int r = warp; r < rep; r += kDThreads / 32) {
    float* row = ps + r * kChunk;
    float mx = kNegInf;
    for (int t = wl; t < kChunk; t += 32) mx = fmaxf(mx, row[t]);
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float sum = 0.f;
    for (int t = wl; t < kChunk; t += 32) {
      const float p = expf(row[t] - mx);
      row[t] = round_as<TQ>(p);
      sum += p;
    }
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (wl == 0) {
      ml[2 * r] = mx;
      ml[2 * r + 1] = sum;
    }
  }
  __syncthreads();

  // P·V: LPT lanes share a token (4 elements a lane, one 32-bit code
  // load), GROUPS tokens at a time, then a sum over the groups
  const int grp = tid / LPT, d0 = 4 * (tid % LPT);
  const long long slot = (long long)bg * n_split + split;
  for (int r0 = 0; r0 < rep; r0 += kRB) {
    float acc[kRB][4];
#pragma unroll
    for (int rr = 0; rr < kRB; ++rr)
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[rr][u] = 0.f;
#pragma unroll 4
    for (int t = t0 + grp; t < t_end; t += GROUPS) {
      const uint32_t c4 = *reinterpret_cast<const uint32_t*>(
          vc.codes + b * vc.cb + g * vc.cg + (long long)t * vc.ct + d0);
      const uint32_t s4 =
          (uint32_t)vc.signs[b * vc.sb + g * vc.sg + (long long)t * vc.st +
                             (d0 >> 3)] >> (d0 & 7);
      const float sc = vc.scale[b * vc.lb + g * vc.lg + (long long)t * vc.lt];
      float vv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        vv[u] = round_as<TQ>(
            dequant1((c4 >> (8 * u)) & 255u, (s4 >> u) & 1u, sc, step));
#pragma unroll
      for (int rr = 0; rr < kRB; ++rr) {
        if (r0 + rr < rep) {
          const float p = ps[(r0 + rr) * kChunk + (t - t0)];
#pragma unroll
          for (int u = 0; u < 4; ++u) acc[rr][u] = fmaf(p, vv[u], acc[rr][u]);
        }
      }
    }
#pragma unroll
    for (int rr = 0; rr < kRB; ++rr)
      *reinterpret_cast<float4*>(&red[(grp * kRB + rr) * HD + d0]) =
          make_float4(acc[rr][0], acc[rr][1], acc[rr][2], acc[rr][3]);
    __syncthreads();
    for (int e = tid; e < kRB * HD; e += kDThreads) {
      const int rr = e / HD, d = e % HD, r = r0 + rr;
      if (r >= rep) continue;
      float s = 0.f;
#pragma unroll 8
      for (int gi = 0; gi < GROUPS; ++gi) s += red[(gi * kRB + rr) * HD + d];
      if (n_split == 1) {
        out[((long long)bg * rep + r) * HD + d] = s / fmaxf(ml[2 * r + 1], kLFloor);
      } else {
        part_acc[(slot * rep + r) * HD + d] = s;
        if (d == 0) {
          part_ml[(slot * rep + r) * 2] = ml[2 * r];
          part_ml[(slot * rep + r) * 2 + 1] = ml[2 * r + 1];
        }
      }
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kDThreads)
kvdq_combine_kernel(const float* __restrict__ part_acc,
                    const float* __restrict__ part_ml, float* __restrict__ out,
                    int n_split, int rep, int hd) {
  const int bg = blockIdx.x;
  for (int e = threadIdx.x; e < rep * hd; e += kDThreads) {
    const int r = e / hd, d = e % hd;
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

template <int HD, typename TQ>
cudaError_t launch_kvdq(const void* q, const long long* qst, const KvView& kc,
                        const KvView& vc, float* out, float* part_acc,
                        float* part_ml, int B, int G, int rep, int T, int pos,
                        int n_split, cudaStream_t stream) {
  const int smem = kvdq_smem_floats(rep, HD) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      kvdq_partial_kernel<HD, TQ>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const float step = 16.0f / 254.0f;
  kvdq_partial_kernel<HD, TQ><<<dim3((unsigned)(B * G), (unsigned)n_split),
                                kDThreads, smem, stream>>>(
      static_cast<const TQ*>(q), qst[0], qst[1], qst[2], kc, vc, out,
      part_acc, part_ml, G, rep, T, pos, 1.0f / sqrtf((float)HD), step);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return err;
  kvdq_combine_kernel<<<(unsigned)(B * G), kDThreads, 0, stream>>>(
      part_acc, part_ml, out, n_split, rep, HD);
  return cudaGetLastError();
}

template <typename TQ>
cudaError_t dispatch_kvdq(const void* q, const long long* qst,
                          const KvView& kc, const KvView& vc, float* out,
                          float* part_acc, float* part_ml, int B, int G,
                          int rep, int hd, int T, int pos, int n_split,
                          cudaStream_t s) {
  switch (hd) {
    case 16: return launch_kvdq<16, TQ>(q, qst, kc, vc, out, part_acc, part_ml, B, G, rep, T, pos, n_split, s);
    case 32: return launch_kvdq<32, TQ>(q, qst, kc, vc, out, part_acc, part_ml, B, G, rep, T, pos, n_split, s);
    case 64: return launch_kvdq<64, TQ>(q, qst, kc, vc, out, part_acc, part_ml, B, G, rep, T, pos, n_split, s);
    case 128: return launch_kvdq<128, TQ>(q, qst, kc, vc, out, part_acc, part_ml, B, G, rep, T, pos, n_split, s);
    default: return cudaErrorInvalidValue;
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

// B10.  q (B, S, Hq, hd), k/v (B, S, G, hd), o (B, S, Hq, hd); hd in
// {16, 32, 64, 128}; Hq a multiple of G.
int flash_attention_fwd(const void* q, const long long* q_st, const void* k,
                        const long long* k_st, const void* v,
                        const long long* v_st, void* o, const long long* o_st,
                        int batch, int seq, int heads, int kv_heads, int hd,
                        int causal, int bf16, void* stream) {
  if (batch <= 0 || seq <= 0 || kv_heads <= 0 || heads % kv_heads != 0)
    return (int)cudaErrorInvalidValue;
  return (int)dispatch_flash(bf16, q, q_st, k, k_st, v, v_st, o, o_st, batch,
                             seq, heads, kv_heads, hd, causal,
                             static_cast<cudaStream_t>(stream));
}

// B11.  q (B, G, rep, hd) f32 or bf16; each cache operand (B, G, T, ·):
// codes uint8 (·, hd) with 16-byte aligned rows, signs uint8 (·, hd/8) with
// 2-byte aligned rows, scale f32 (·, 1); out (B, G, rep, hd) f32
// contiguous; hd in {16, 32, 64, 128}.
// n_split = ceil(min(T, pos + 1) / 256) blocks per (b, g); with more than
// one, part_acc (B·G, n_split, rep, hd) and part_ml (B·G, n_split, rep, 2)
// are f32 scratch.
int kv_dequant_decode_attention_fwd(
    const void* q, const long long* q_st, const void* ck, const long long* ck_st,
    const void* sk, const long long* sk_st, const void* lk,
    const long long* lk_st, const void* cv, const long long* cv_st,
    const void* sv, const long long* sv_st, const void* lv,
    const long long* lv_st, float* out, float* part_acc, float* part_ml,
    int batch, int kv_heads, int rep, int hd, int seq, int pos, int n_split,
    int bf16, void* stream) {
  if (batch <= 0 || kv_heads <= 0 || rep <= 0 || seq <= 0 || pos < 0 ||
      hd < 16 || hd > 128 || (hd & (hd - 1)) || n_split <= 0)
    return (int)cudaErrorInvalidValue;
  const KvView kc = make_view(ck, ck_st, sk, sk_st, lk, lk_st);
  const KvView vc = make_view(cv, cv_st, sv, sv_st, lv, lv_st);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? (int)dispatch_kvdq<__nv_bfloat16>(q, q_st, kc, vc, out,
                                                  part_acc, part_ml, batch,
                                                  kv_heads, rep, hd, seq, pos,
                                                  n_split, s)
              : (int)dispatch_kvdq<float>(q, q_st, kc, vc, out, part_acc,
                                          part_ml, batch, kv_heads, rep, hd,
                                          seq, pos, n_split, s);
}

const char* attention_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
