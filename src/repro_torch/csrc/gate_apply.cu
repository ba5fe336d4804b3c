// Lane-batched complex GEMM on separate re/im f32 planes, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/gate_apply.py::gemm_planes_batch
// (kernel body _gemm_batch_kernel).  For every lane l:
//
//     Cr[l] = Ar[l] Br[l] - Ai[l] Bi[l],   Ci[l] = Ar[l] Bi[l] + Ai[l] Br[l]
//
// with A (L, R, K) row planes and B = U^T (L, K, K), K = 2^k, 2 <= K <= 128.
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

}  // namespace

extern "C" {

// Returns the cudaError_t of the launch (0 = launched).  Strides are in
// elements; A's rows must be contiguous with row stride K, and the two A
// planes share a lane stride, as do the two B planes their three strides.
// C is written contiguous (L, R, K).
int gemm_planes_batch_f32(const float* ar, const float* ai, long long a_lane,
                          const float* br, const float* bi, long long b_lane,
                          long long b_row, long long b_col, float* cr,
                          float* ci, long long lanes, long long rows, int k,
                          int vec4, void* stream) {
  if (lanes <= 0 || lanes > 65535 || rows <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
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

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
