// Complex products on separate re/im f32 planes, for Hopper (sm_90a): the
// stage compute's gate kernels.
//
// gemm_planes_batch_kernel replaces two TPU kernels of
// repro/kernels/gate_apply.py:
//   gemm_planes_batch (kernel body _gemm_batch_kernel, pl.pallas_call at
//     :112) — for every lane l of an (L, R, K) row stack A and per-lane
//     B = U^T planes (L, K, K), K = 2^k, 2 <= K <= 128:
//
//       Cr[l] = Ar[l] Br[l] - Ai[l] Bi[l],   Ci[l] = Ar[l] Bi[l] + Ai[l] Br[l]
//
//   gemm_planes (_gemm_kernel, :69) — the same with one B for all rows:
//     the entry gemm_planes_f32 launches this body with L = 1.
//
// What bounds it: HBM bytes.  Every amplitude is read once and written once
// (16 bytes of planes in and out per complex amplitude) for 4K FMAs, so at
// the main path's K <= 32 the kernel does about 16 FLOP per byte, far below
// the ~20 FLOP/byte where the card's f32 FMA rate (67 TFLOP/s) would take
// over from its 3.35 TB/s.  Sums are plain f32 FMAs: no TF32 and no tensor
// cores, because the reference is full f32.
//
// What the design does about it:
//   * one block owns a run of row tiles of one lane (blockIdx.y = lane) and
//     loads that lane's two K x K B planes into shared memory once, from any
//     strides — a single-lane wave passes B with lane stride 0, so the
//     broadcast over the wave is never materialised;
//   * A tiles (kTile elements of each plane) are read with coalesced float4
//     loads into shared memory, and C is written coalesced: the whole
//     plane stream moves at full-sector efficiency, once;
//   * each thread owns one output column j (kThreads is a multiple of K) and,
//     for K <= 32, keeps column j of both B planes in registers, so the inner
//     loop reads only A from shared memory, as broadcast float4 loads: the
//     shared-memory traffic stays well under the FMA rate and the kernel
//     waits on HBM, not on the SM.
//
// gemm_planes_mid_kernel replaces gemm_planes_mid (_gemm_mid_kernel,
// pl.pallas_call at :153): the batched left contraction over an (O, K, I)
// stack, C[o] = U A[o], with U untransposed — a gate whose qubit axes sit
// together but not minor-most, applied with no transpose.  Bound by bytes
// like the GEMM above (each amplitude in and out once, 4K FMAs).  The inner
// axis is the contiguous one, so one thread owns one inner column (o, i):
// walking k, the 32 threads of a warp read 32 neighbouring floats of row k
// (coalesced), and each value feeds every output row's sum at once, so A is
// read from HBM exactly once for K <= 32.  U^T (2 K^2 floats) lives in
// shared memory and is read as broadcast float4s (four output rows a load).
// Above K = 32 the output rows go in passes of 32 (registers hold 64
// running sums) and A is read once a pass, mostly from L2.
//
// diag_apply_kernel replaces diag_apply (_diag_kernel, pl.pallas_call at
// :186): (R, K) planes times a complex (1, K) diagonal, elementwise.  It
// reads each float of A once and writes each of C once (16 bytes an
// amplitude; 6 FLOP), so it is bound by bytes; float4 loads and stores
// where the planes are 16-byte aligned, and the diagonal (K floats, in
// L1 after the first warp) is read through the read-only cache, as a
// float4 per four elements for K >= 4.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 4096;  // elements of one plane per tile (16 KiB)

template <int K>
__global__ void __launch_bounds__(kThreads)
gemm_planes_batch_kernel(const float* __restrict__ ar,
                         const float* __restrict__ ai, long long a_lane,
                         const float* __restrict__ br,
                         const float* __restrict__ bi, long long b_lane,
                         long long b_row, long long b_col,
                         float* __restrict__ cr, float* __restrict__ ci,
                         long long rows, int vec4) {
  static_assert(kThreads % K == 0, "a thread must own one column");
  constexpr bool kRegB = K <= 32;
  extern __shared__ __align__(16) float smem[];
  float* sar = smem;
  float* sai = sar + kTile;
  float* sbr = sai + kTile;
  float* sbi = sbr + K * K;

  const long long lane = blockIdx.y;
  const float* lbr = br + lane * b_lane;
  const float* lbi = bi + lane * b_lane;
  for (int e = threadIdx.x; e < K * K; e += kThreads) {
    const int r = e / K, c = e % K;
    sbr[e] = lbr[r * b_row + c * b_col];
    sbi[e] = lbi[r * b_row + c * b_col];
  }
  __syncthreads();

  const int j = threadIdx.x % K;  // the output column this thread owns
  float rbr[kRegB ? K : 1], rbi[kRegB ? K : 1];
  if constexpr (kRegB) {
#pragma unroll
    for (int kk = 0; kk < K; ++kk) {
      rbr[kk] = sbr[kk * K + j];
      rbi[kk] = sbi[kk * K + j];
    }
  }

  const long long n = rows * K;  // elements of one plane of this lane
  const float* lar = ar + lane * a_lane;
  const float* lai = ai + lane * a_lane;
  float* lcr = cr + lane * n;
  float* lci = ci + lane * n;

  for (long long base = (long long)blockIdx.x * kTile; base < n;
       base += (long long)gridDim.x * kTile) {
    const int cnt = (int)(n - base < kTile ? n - base : kTile);
    __syncthreads();  // the previous tile's readers are done
    if (vec4 && (cnt & 3) == 0) {
      const float4* gr = reinterpret_cast<const float4*>(lar + base);
      const float4* gi = reinterpret_cast<const float4*>(lai + base);
      float4* tr = reinterpret_cast<float4*>(sar);
      float4* ti = reinterpret_cast<float4*>(sai);
      for (int q = threadIdx.x; q < cnt / 4; q += kThreads) {
        tr[q] = gr[q];
        ti[q] = gi[q];
      }
    } else {
      for (int e = threadIdx.x; e < cnt; e += kThreads) {
        sar[e] = lar[base + e];
        sai[e] = lai[base + e];
      }
    }
    __syncthreads();

    // e % K == j for every e this thread visits (kThreads % K == 0)
    for (int e = threadIdx.x; e < cnt; e += kThreads) {
      const float* rowr = sar + (e - j);
      const float* rowi = sai + (e - j);
      float rr = 0.f, ii = 0.f, ri = 0.f, ir = 0.f;
      auto step = [&](float a_r, float a_i, int kk) {
        float b_r, b_i;
        if constexpr (kRegB) {
          b_r = rbr[kk];
          b_i = rbi[kk];
        } else {
          b_r = sbr[kk * K + j];
          b_i = sbi[kk * K + j];
        }
        rr = fmaf(a_r, b_r, rr);
        ii = fmaf(a_i, b_i, ii);
        ri = fmaf(a_r, b_i, ri);
        ir = fmaf(a_i, b_r, ir);
      };
      if constexpr (K >= 4) {
        const float4* r4 = reinterpret_cast<const float4*>(rowr);
        const float4* i4 = reinterpret_cast<const float4*>(rowi);
#pragma unroll
        for (int q = 0; q < K / 4; ++q) {
          const float4 x = r4[q], y = i4[q];
          step(x.x, y.x, 4 * q + 0);
          step(x.y, y.y, 4 * q + 1);
          step(x.z, y.z, 4 * q + 2);
          step(x.w, y.w, 4 * q + 3);
        }
      } else {
#pragma unroll
        for (int kk = 0; kk < K; ++kk) step(rowr[kk], rowi[kk], kk);
      }
      lcr[base + e] = rr - ii;
      lci[base + e] = ri + ir;
    }
  }
}

template <int K>
cudaError_t launch(const float* ar, const float* ai, long long a_lane,
                   const float* br, const float* bi, long long b_lane,
                   long long b_row, long long b_col, float* cr, float* ci,
                   long long lanes, long long rows, int vec4,
                   cudaStream_t stream) {
  const size_t smem = (2 * (size_t)kTile + 2 * (size_t)K * K) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        gemm_planes_batch_kernel<K>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const long long tiles = (rows * K + kTile - 1) / kTile;
  const long long cap = 1024;
  dim3 grid((unsigned)(tiles < cap ? tiles : cap), (unsigned)lanes);
  gemm_planes_batch_kernel<K><<<grid, kThreads, smem, stream>>>(
      ar, ai, a_lane, br, bi, b_lane, b_row, b_col, cr, ci, rows, vec4);
  return cudaGetLastError();
}


// -- gemm_planes_mid ---------------------------------------------------------

constexpr int kMidThreads = 256;

template <int K>
__global__ void __launch_bounds__(kMidThreads)
gemm_planes_mid_kernel(const float* __restrict__ ar,
                       const float* __restrict__ ai,
                       const float* __restrict__ ur,
                       const float* __restrict__ ui, long long u_row,
                       long long u_col, float* __restrict__ cr,
                       float* __restrict__ ci, long long outer,
                       long long inner) {
  constexpr int JC = K < 32 ? K : 32;  // output rows a pass
  extern __shared__ __align__(16) float smem[];
  float* sur = smem;       // sur[k * K + j] = Re U[j][k]
  float* sui = smem + K * K;
  for (int e = threadIdx.x; e < K * K; e += kMidThreads) {
    const int k = e / K, j = e % K;
    sur[e] = ur[j * u_row + k * u_col];
    sui[e] = ui[j * u_row + k * u_col];
  }
  __syncthreads();

  const long long cols = outer * inner;
  for (long long c = (long long)blockIdx.x * kMidThreads + threadIdx.x;
       c < cols; c += (long long)gridDim.x * kMidThreads) {
    const long long o = c / inner;
    const long long base = o * K * inner + (c - o * inner);
    for (int j0 = 0; j0 < K; j0 += JC) {
      float accr[JC], acci[JC];
#pragma unroll
      for (int j = 0; j < JC; ++j) accr[j] = acci[j] = 0.f;
#pragma unroll 8
      for (int k = 0; k < K; ++k) {
        const float xr = ar[base + k * inner];
        const float xi = ai[base + k * inner];
        auto step = [&](float u_r, float u_i, int j) {
          accr[j] = fmaf(u_r, xr, accr[j]);
          accr[j] = fmaf(-u_i, xi, accr[j]);
          acci[j] = fmaf(u_r, xi, acci[j]);
          acci[j] = fmaf(u_i, xr, acci[j]);
        };
        if constexpr (JC >= 4) {
          const float4* u4 = reinterpret_cast<const float4*>(sur + k * K + j0);
          const float4* v4 = reinterpret_cast<const float4*>(sui + k * K + j0);
#pragma unroll
          for (int q = 0; q < JC / 4; ++q) {
            const float4 u = u4[q], v = v4[q];
            step(u.x, v.x, 4 * q + 0);
            step(u.y, v.y, 4 * q + 1);
            step(u.z, v.z, 4 * q + 2);
            step(u.w, v.w, 4 * q + 3);
          }
        } else {
#pragma unroll
          for (int j = 0; j < JC; ++j)
            step(sur[k * K + j0 + j], sui[k * K + j0 + j], j);
        }
      }
#pragma unroll
      for (int j = 0; j < JC; ++j) {
        cr[base + (long long)(j0 + j) * inner] = accr[j];
        ci[base + (long long)(j0 + j) * inner] = acci[j];
      }
    }
  }
}

template <int K>
cudaError_t launch_mid(const float* ar, const float* ai, const float* ur,
                       const float* ui, long long u_row, long long u_col,
                       float* cr, float* ci, long long outer,
                       long long inner, cudaStream_t stream) {
  const size_t smem = 2 * (size_t)K * K * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        gemm_planes_mid_kernel<K>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const long long cols = outer * inner;
  const long long blocks = (cols + kMidThreads - 1) / kMidThreads;
  const long long cap = 4096;
  gemm_planes_mid_kernel<K><<<(unsigned)(blocks < cap ? blocks : cap),
                              kMidThreads, smem, stream>>>(
      ar, ai, ur, ui, u_row, u_col, cr, ci, outer, inner);
  return cudaGetLastError();
}

// -- diag_apply --------------------------------------------------------------

constexpr int kDiagThreads = 256;

__global__ void __launch_bounds__(kDiagThreads)
diag_apply_kernel(const float* __restrict__ ar, const float* __restrict__ ai,
                  const float* __restrict__ dr, const float* __restrict__ di,
                  float* __restrict__ cr, float* __restrict__ ci,
                  long long n, long long kmask, int vec4) {
  const long long stride = (long long)gridDim.x * kDiagThreads;
  const long long t0 = (long long)blockIdx.x * kDiagThreads + threadIdx.x;
  if (vec4) {
    // four neighbouring elements of one row: for K >= 4 their diagonal
    // entries are four neighbours too, read as one float4 each
    const float4* a4 = reinterpret_cast<const float4*>(ar);
    const float4* b4 = reinterpret_cast<const float4*>(ai);
    float4* c4 = reinterpret_cast<float4*>(cr);
    float4* d4 = reinterpret_cast<float4*>(ci);
    const bool wide = kmask >= 3;
    for (long long q = t0; q < n / 4; q += stride) {
      const float4 x = a4[q], y = b4[q];
      const long long col = (4 * q) & kmask;
      float4 u, v;
      if (wide) {
        u = __ldg(reinterpret_cast<const float4*>(dr + col));
        v = __ldg(reinterpret_cast<const float4*>(di + col));
      } else {
        u = make_float4(__ldg(dr + (col & kmask)),
                        __ldg(dr + ((col + 1) & kmask)),
                        __ldg(dr + ((col + 2) & kmask)),
                        __ldg(dr + ((col + 3) & kmask)));
        v = make_float4(__ldg(di + (col & kmask)),
                        __ldg(di + ((col + 1) & kmask)),
                        __ldg(di + ((col + 2) & kmask)),
                        __ldg(di + ((col + 3) & kmask)));
      }
      c4[q] = make_float4(x.x * u.x - y.x * v.x, x.y * u.y - y.y * v.y,
                          x.z * u.z - y.z * v.z, x.w * u.w - y.w * v.w);
      d4[q] = make_float4(x.x * v.x + y.x * u.x, x.y * v.y + y.y * u.y,
                          x.z * v.z + y.z * u.z, x.w * v.w + y.w * u.w);
    }
  } else {
    for (long long e = t0; e < n; e += stride) {
      const long long col = e & kmask;
      const float d_r = __ldg(dr + col), d_i = __ldg(di + col);
      const float x = ar[e], y = ai[e];
      cr[e] = x * d_r - y * d_i;
      ci[e] = x * d_i + y * d_r;
    }
  }
}

}  // namespace

namespace {

int dispatch_gemm(const float* ar, const float* ai, long long a_lane,
                  const float* br, const float* bi, long long b_lane,
                  long long b_row, long long b_col, float* cr, float* ci,
                  long long lanes, long long rows, int k, int vec4,
                  cudaStream_t s) {
  if (lanes <= 0 || lanes > 65535 || rows <= 0) return (int)cudaErrorInvalidValue;
  switch (k) {
    case 2: return (int)launch<2>(ar, ai, a_lane, br, bi, b_lane, b_row, b_col, cr, ci, lanes, rows, vec4, s);
    case 4: return (int)launch<4>(ar, ai, a_lane, br, bi, b_lane, b_row, b_col, cr, ci, lanes, rows, vec4, s);
    case 8: return (int)launch<8>(ar, ai, a_lane, br, bi, b_lane, b_row, b_col, cr, ci, lanes, rows, vec4, s);
    case 16: return (int)launch<16>(ar, ai, a_lane, br, bi, b_lane, b_row, b_col, cr, ci, lanes, rows, vec4, s);
    case 32: return (int)launch<32>(ar, ai, a_lane, br, bi, b_lane, b_row, b_col, cr, ci, lanes, rows, vec4, s);
    case 64: return (int)launch<64>(ar, ai, a_lane, br, bi, b_lane, b_row, b_col, cr, ci, lanes, rows, vec4, s);
    case 128: return (int)launch<128>(ar, ai, a_lane, br, bi, b_lane, b_row, b_col, cr, ci, lanes, rows, vec4, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Each entry returns the cudaError_t of its launch (0 = launched).  Strides
// are in elements.

// B1.  A's rows must be contiguous with row stride K, and the two A planes
// share a lane stride, as do the two B planes their three strides.  C is
// written contiguous (L, R, K).
int gemm_planes_batch_f32(const float* ar, const float* ai, long long a_lane,
                          const float* br, const float* bi, long long b_lane,
                          long long b_row, long long b_col, float* cr,
                          float* ci, long long lanes, long long rows, int k,
                          int vec4, void* stream) {
  return dispatch_gemm(ar, ai, a_lane, br, bi, b_lane, b_row, b_col, cr, ci,
                       lanes, rows, k, vec4, static_cast<cudaStream_t>(stream));
}

// B6: one (R, K) x (K, K) product — B1's body with one lane.
int gemm_planes_f32(const float* ar, const float* ai, const float* br,
                    const float* bi, long long b_row, long long b_col,
                    float* cr, float* ci, long long rows, int k, int vec4,
                    void* stream) {
  return dispatch_gemm(ar, ai, 0, br, bi, 0, b_row, b_col, cr, ci, 1, rows,
                       k, vec4, static_cast<cudaStream_t>(stream));
}

// B7.  A is a contiguous (O, K, I) stack; U (K, K) any strides; C is
// written contiguous (O, K, I).
int gemm_planes_mid_f32(const float* ar, const float* ai, const float* ur,
                        const float* ui, long long u_row, long long u_col,
                        float* cr, float* ci, long long outer, int k,
                        long long inner, void* stream) {
  if (outer <= 0 || inner <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 2: return (int)launch_mid<2>(ar, ai, ur, ui, u_row, u_col, cr, ci, outer, inner, s);
    case 4: return (int)launch_mid<4>(ar, ai, ur, ui, u_row, u_col, cr, ci, outer, inner, s);
    case 8: return (int)launch_mid<8>(ar, ai, ur, ui, u_row, u_col, cr, ci, outer, inner, s);
    case 16: return (int)launch_mid<16>(ar, ai, ur, ui, u_row, u_col, cr, ci, outer, inner, s);
    case 32: return (int)launch_mid<32>(ar, ai, ur, ui, u_row, u_col, cr, ci, outer, inner, s);
    case 64: return (int)launch_mid<64>(ar, ai, ur, ui, u_row, u_col, cr, ci, outer, inner, s);
    case 128: return (int)launch_mid<128>(ar, ai, ur, ui, u_row, u_col, cr, ci, outer, inner, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// B8.  A and C are contiguous (R, K) planes, the diagonal (K,) contiguous;
// K a power of two.  vec4 = every plane 16-byte aligned and R*K % 4 == 0,
// and for K >= 4 the diagonal 16-byte aligned too.
int diag_apply_f32(const float* ar, const float* ai, const float* dr,
                   const float* di, float* cr, float* ci, long long rows,
                   long long k, int vec4, void* stream) {
  if (rows <= 0 || k <= 0 || (k & (k - 1))) return (int)cudaErrorInvalidValue;
  const long long n = rows * k;
  const long long items = vec4 ? n / 4 : n;
  const long long blocks = (items + kDiagThreads - 1) / kDiagThreads;
  const long long cap = 8192;
  diag_apply_kernel<<<(unsigned)(blocks < cap ? blocks : cap), kDiagThreads,
                      0, static_cast<cudaStream_t>(stream)>>>(
      ar, ai, dr, di, cr, ci, n, k - 1, vec4);
  return (int)cudaGetLastError();
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
