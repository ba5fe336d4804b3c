// Attention for Hopper (sm_90a): the LM serving path's two attention cores.
//
// flash_kernel replaces repro/kernels/flash_attention.py::flash_attention
// (kernel body _flash_kernel, pl.pallas_call at :90): causal (or full)
// online-softmax attention, scale hd^-0.5, masked scores -2^30, a floor of
// 1e-30 on the softmax sum, K tiles wholly above the diagonal skipped.
// One kernel serves the TPU signature (BH, S, hd) and the model's layout:
// q (B, S, Hq, hd) and k/v (B, S, G, hd), all by strides, where query head h
// reads kv head h / rep (rep = Hq / G, the grouping of _gqa_scores).  No
// replicated KV heads and no (BH, S, hd) copy are made.
//
// What bounds it: f32 operations.  A (BH, S, hd) causal call does
// 2·BH·S²·hd FMAs over 3·BH·S·hd inputs, ~100 FMA per byte at S = 2048, far
// above the ~20 FLOP/byte where the card's 3.35 TB/s would take over from
// its 67 TFLOP/s of f32 FMAs.  This first version runs on the CUDA cores in
// full f32 (the reference's arithmetic; the tensor cores' bf16 or TF32 would
// change the numbers).  What its design does about it:
//   * a block owns 64 query rows of one head and walks that head's K/V in
//     32-row tiles with running (max, sum) per row: scores never reach
//     device memory, and the causal tiles past the block's last row are
//     never read;
//   * Q, K, V and P tiles sit in shared memory as f32 (bf16 inputs are
//     widened on load, exactly), rows padded by 4 floats so that the
//     float4 reads of 8 neighbouring rows hit 8 distinct bank groups; at
//     hd = 128 that is 77 KB, so two blocks share an SM (registers capped
//     to match), which measured faster than one block with 64-row tiles;
//   * each thread owns a 4 x 2 block of the score tile (rows ty + 16i, cols
//     tx + 16j) and the same 4 rows of the output, so the softmax rescale
//     stays in registers; a row's 16 owners sit in one half-warp, so its
//     max and sum take four shuffles;
//   * blocks of the causal diagonal's far end (the longest rows) launch
//     first, to shorten the tail.
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
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// ---------------------------------------------------------------- B10 -----

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 32;        // key rows per tile
constexpr int kFThreads = 256;

template <int D>
constexpr int flash_smem_bytes() {
  return (kBQ * (D + 4) + 2 * kBK * (D + 4) + kBQ * (kBK + 4)) * 4;
}

template <int D, typename T>
__global__ void __launch_bounds__(kFThreads, 2)
flash_kernel(const T* __restrict__ q, long long qb, long long qs,
             long long qh, const T* __restrict__ k, long long kb,
             long long ks, long long kh, const T* __restrict__ v,
             long long vb, long long vs, long long vh, T* __restrict__ o,
             long long ob, long long os, long long oh, int S, int Hq,
             int rep, int causal, float scale) {
  constexpr int LD = D + 4;      // row pitch of the Q/K/V tiles (floats)
  constexpr int LP = kBK + 4;    // row pitch of the P tile
  constexpr int CPT = D / 16;    // output columns a thread owns
  constexpr int SJ = kBK / 16;   // score columns a thread owns
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Ks = Qs + kBQ * LD;
  float* Vs = Ks + kBK * LD;
  float* Ps = Vs + kBK * LD;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int bh = blockIdx.x;
  const int b = bh / Hq, h = bh % Hq, g = h / rep;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const T* qp = q + b * qb + h * qh;
  const T* kp = k + b * kb + g * kh;
  const T* vp = v + b * vb + g * vh;

  for (int e = tid; e < kBQ * D; e += kFThreads) {
    const int r = e / D, d = e % D, s = q0 + r;
    Qs[r * LD + d] = s < S ? to_f32(qp[s * qs + d]) * scale : 0.f;
  }

  float m[4], l[4], acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
  }

  int n_kt = (S + kBK - 1) / kBK;
  if (causal) n_kt = min(n_kt, (q0 + kBQ + kBK - 1) / kBK);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's readers are done
    for (int e = tid; e < kBK * D; e += kFThreads) {
      const int r = e / D, d = e % D, s = k0 + r;
      const bool in = s < S;
      Ks[r * LD + d] = in ? to_f32(kp[s * ks + d]) : 0.f;
      Vs[r * LD + d] = in ? to_f32(vp[s * vs + d]) : 0.f;
    }
    __syncthreads();

    float sc[4][SJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < SJ; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qa[4], ka[SJ];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qa[i] = *reinterpret_cast<const float4*>(&Qs[(ty + 16 * i) * LD + d]);
#pragma unroll
      for (int j = 0; j < SJ; ++j)
        ka[j] = *reinterpret_cast<const float4*>(&Ks[(tx + 16 * j) * LD + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < SJ; ++j) {
          float t = sc[i][j];
          t = fmaf(qa[i].x, ka[j].x, t);
          t = fmaf(qa[i].y, ka[j].y, t);
          t = fmaf(qa[i].z, ka[j].z, t);
          t = fmaf(qa[i].w, ka[j].w, t);
          sc[i][j] = t;
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < SJ; ++j) {
        const int c = k0 + tx + 16 * j;
        if (c >= S || (causal && c > r)) sc[i][j] = kNegInf;
        mx = fmaxf(mx, sc[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < SJ; ++j) {
        const float p = expf(sc[i][j] - m_new);
        Ps[(ty + 16 * i) * LP + tx + 16 * j] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      const float alpha = expf(m[i] - m_new);
      l[i] = alpha * l[i] + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 2
    for (int kk = 0; kk < kBK; kk += 4) {
      float4 pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pa[i] = *reinterpret_cast<const float4*>(&Ps[(ty + 16 * i) * LP + kk]);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float* vrow = &Vs[(kk + u) * LD];
        float vv[CPT];
        if constexpr (CPT >= 4) {
#pragma unroll
          for (int c4 = 0; c4 < CPT / 4; ++c4) {
            const float4 t =
                *reinterpret_cast<const float4*>(&vrow[64 * c4 + 4 * tx]);
            vv[4 * c4] = t.x;
            vv[4 * c4 + 1] = t.y;
            vv[4 * c4 + 2] = t.z;
            vv[4 * c4 + 3] = t.w;
          }
        } else {
#pragma unroll
          for (int c = 0; c < CPT; ++c) vv[c] = vrow[tx * CPT + c];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = u == 0 ? pa[i].x : u == 1 ? pa[i].y
                        : u == 2 ? pa[i].z : pa[i].w;
#pragma unroll
          for (int c = 0; c < CPT; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= S) continue;
    const float den = fmaxf(l[i], kLFloor);
    T* orow = o + b * ob + r * os + h * oh;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int col = CPT >= 4 ? 64 * (c / 4) + 4 * tx + (c % 4) : tx * CPT + c;
      put(&orow[col], acc[i][c] / den);
    }
  }
}

template <int D, typename T>
cudaError_t launch_flash(const void* q, const long long* qst, const void* k,
                         const long long* kst, const void* v,
                         const long long* vst, void* o, const long long* ost,
                         int B, int S, int Hq, int G, int causal,
                         cudaStream_t stream) {
  constexpr int smem = flash_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<D, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)(B * Hq), (unsigned)((S + kBQ - 1) / kBQ));
  flash_kernel<D, T><<<grid, kFThreads, smem, stream>>>(
      static_cast<const T*>(q), qst[0], qst[1], qst[2],
      static_cast<const T*>(k), kst[0], kst[1], kst[2],
      static_cast<const T*>(v), vst[0], vst[1], vst[2], static_cast<T*>(o),
      ost[0], ost[1], ost[2], S, Hq, Hq / G, causal,
      1.0f / sqrtf((float)D));
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_flash(const void* q, const long long* qst, const void* k,
                           const long long* kst, const void* v,
                           const long long* vst, void* o, const long long* ost,
                           int B, int S, int Hq, int G, int hd, int causal,
                           cudaStream_t s) {
  switch (hd) {
    case 16: return launch_flash<16, T>(q, qst, k, kst, v, vst, o, ost, B, S, Hq, G, causal, s);
    case 32: return launch_flash<32, T>(q, qst, k, kst, v, vst, o, ost, B, S, Hq, G, causal, s);
    case 64: return launch_flash<64, T>(q, qst, k, kst, v, vst, o, ost, B, S, Hq, G, causal, s);
    case 128: return launch_flash<128, T>(q, qst, k, kst, v, vst, o, ost, B, S, Hq, G, causal, s);
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
            kv[u] = dequant1((words[w] >> (8 * u)) & 255u,
                             (sw[c] >> (4 * w + u)) & 1u, sc, step);
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
      row[t] = p;
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
        vv[u] = dequant1((c4 >> (8 * u)) & 255u, (s4 >> u) & 1u, sc, step);
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? (int)dispatch_flash<__nv_bfloat16>(q, q_st, k, k_st, v, v_st,
                                                   o, o_st, batch, seq, heads,
                                                   kv_heads, hd, causal, s)
              : (int)dispatch_flash<float>(q, q_st, k, k_st, v, v_st, o, o_st,
                                           batch, seq, heads, kv_heads, hd,
                                           causal, s);
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
