// Complex products on separate re/im f32 planes, for Hopper (sm_90a): the
// stage compute's gate kernels.
//
// gemm_planes_ring_kernel (K <= 32) and gemm_planes_wide_kernel (K >= 64)
// replace two TPU kernels of repro/kernels/gate_apply.py:
//   gemm_planes_batch (kernel body _gemm_batch_kernel, pl.pallas_call at
//     :112) — for every lane l of an (L, R, K) row stack A and per-lane
//     B = U^T planes (L, K, K), K = 2^k, 2 <= K <= 128:
//
//       Cr[l] = Ar[l] Br[l] - Ai[l] Bi[l],   Ci[l] = Ar[l] Bi[l] + Ai[l] Br[l]
//
//   gemm_planes (_gemm_kernel, :69) — the same with one B for all rows:
//     the entry gemm_planes_f32 launches these bodies with L = 1.
//
// What bounds it at the main path's K <= 32: HBM bytes, closely followed by
// the f32 FMAs.  Every amplitude is read once and written once (16 bytes of
// planes in and out per complex amplitude) for 4K FMAs: at K = 32 and
// R K = 2^22 that is 0.020 ms of bytes at 3.35 TB/s against 0.016 ms of
// FMAs at 67 TFLOP/s.  Done one after the other the two phases add up, so
// the kernel has to keep the HBM stream and the FMAs busy at once.  Sums
// stay plain f32 FMAs on the CUDA cores, in the plain version's order per
// column (the 1e-6 absolute agreement with it does not survive even a
// reordered f32 sum, let alone split TF32 on the tensor cores).
//
// What gemm_planes_ring_kernel does about it:
//   * persistent blocks, as many as fit on the SMs (occupancy API), spread
//     over the lanes (blockIdx.y = lane); each loads its lane's two K x K B
//     planes once, from any strides — a single-lane wave passes B with lane
//     stride 0, so the broadcast over the wave is never materialised;
//   * the block walks its lane's A tiles (kRingTile elements of each plane)
//     with a stride of the grid, through a ring of kRingStages tiles in
//     shared memory filled by cp.async: 16-byte cp.async.cg where the
//     planes are 16-byte aligned (a ragged last chunk zero-fills by
//     src-size), 4-byte cp.async.ca where they are not (vec4 = 0).  While
//     the FMAs run on tile t, the next tiles are in flight; one block
//     barrier a tile both publishes the arrived tile and frees the stage
//     the next copy reuses;
//   * each thread owns one output column j (kThreads is a multiple of K)
//     and keeps column j of both B planes in registers, so the inner loop
//     reads only A from shared memory, as broadcast float4 loads, and
//     writes C coalesced straight from registers.
// Measured (PERF.md §6): at K <= 16 the stream sets the pace; at K = 32 the
// FMA loop alone (no copies, no stores) takes as long as the whole kernel,
// ~40% of the FMA peak, with a broadcast float4 of A read from shared
// memory for every 8 FMAs.
//
// gemm_planes_wide_kernel is B1 at K >= 64 (and B6 there when its planes
// are not 16-byte aligned): column j of B no longer fits in registers, so
// B stays in shared memory and each tile is loaded, then computed.
//
// gemm_planes_tc_kernel is gemm_planes (B6) at K >= 64, where the wide body
// reads two floats of B from shared memory for every four FMAs: the SM's
// shared-memory port, not HBM, set its pace (17% of its bound at K = 128).
// At K = 128 the product does 8 R K^2 operations over 16 R K bytes, 64
// FLOP a byte: above the ~20 where the f32 FMA rate takes over from HBM.
// So this kernel moves the products to the tensor cores and keeps f32
// accuracy with split TF32:
//   * each operand is split as x = big + small, both TF32 (round to nearest,
//     ties away, on the bit pattern: big = (bits + 2^12) & ~(2^13 - 1));
//     a real product is three mma.sync.m16n8k8 TF32 with f32 sums,
//     small*big + big*small first, big*big last (CUTLASS's
//     OpMultiplyAddFastF32); only small*small, ~2^-22 relative, is dropped;
//   * the four real products of the complex one fold into two
//     accumulators: Cr += Ar Br + (-Ai) Bi, Ci += Ar Bi + Ai Br, so one split
//     A fragment feeds both;
//   * persistent blocks, as many as fit on the SMs: a block stores B's two
//     planes once, in fragment order (one 16-byte shared load a lane for the
//     (Br, Bi) pair of an 8x8 tile; 128 KB at K = 128), then each warp walks
//     16-row tiles of A (at K = 64 two warps share a row tile, each with half
//     the columns).  The reduction index is permuted so that a thread's
//     A fragments for two k-steps are one float4 of its row, read straight
//     from HBM into registers (next chunk prefetched), and the output index
//     so that its accumulators of two n-tiles are one float4 of C: A and C
//     cross HBM once, with no shared-memory staging.
//
// gemm_planes_mid_ring_kernel (K <= 32) and gemm_planes_mid_kernel (K >= 64)
// replace gemm_planes_mid (_gemm_mid_kernel, pl.pallas_call at :153): the
// batched left contraction over an (O, K, I) stack, C[o] = U A[o], with U
// untransposed — a gate whose qubit axes sit together but not minor-most,
// applied with no transpose.  Their lane-batched form, C[l, o] = U[l]
// A[l, o] over (L, O, K, I) with one U a lane, is the wave path's
// MidGemmOp (repro runs that product as an XLA einsum, with no Pallas
// kernel); gemm_planes_mid is its call with one lane.  Bound by bytes like
// the GEMM above (each amplitude in and out once, 4K FMAs: at (1, 32, 2^17)
// 0.020 ms of bytes against 0.016 ms of FMAs), and for the same reason the
// load and the FMAs must overlap.  The ring body does for B7 what
// gemm_planes_ring_kernel does for B1/B6, with the same cp.async helpers
// and ring_walk's stage rotation:
//   * persistent blocks, spread over the lanes (blockIdx.y = lane; each
//     loads its lane's U, from any strides, lane stride 0 included), walk
//     work units in order; a unit's slab is K rows of TI columns of each
//     plane, copied as 16-byte chunks (4-byte copies where I or the planes
//     are not 16-byte aligned; columns past a ragged edge are never copied
//     or stored) while the previous slab's FMAs run.  A unit is (o, a tile
//     of TI inner columns) where I fills a slab; where I is narrower (the
//     wave path's (32, 16384, 8) op), it is TI / I neighbouring o's, their
//     I columns side by side, so no thread idles and the copy stays whole
//     16-byte chunks (I % 4 == 0 keeps a chunk inside one o);
//   * a thread owns kMidCols neighbouring columns of the slab (one 8-byte
//     load of each plane a row; neighbouring threads on neighbouring
//     columns, so no bank conflicts) and kMidRows of their output rows, so
//     K / kMidRows threads share a column and the accumulators stay at
//     2 kMidRows kMidCols registers; U^T (2 K^2 floats) is read from shared
//     memory as broadcast float4s, four output rows a load, and each output
//     row is stored straight to global memory, coalesced (8-byte stores
//     where I is even).  The sums follow the plain version's order (four
//     in-order f32 FMA sums over k, then rr - ii and ri + ir), so the
//     kernel holds B1's rtol 1e-5, atol 1e-6 against it.
// The variant, the slab and a thread's columns follow from (K, I) alone,
// never from L or O, and an element's sum is one thread's in-order FMAs:
// lane l of an L-lane call is bit for bit the one-lane call on lane l's
// operands, for every L.  That is what lets SimService promise that merged
// lanes equal their solo runs, and no cuBLAS call (nor its TF32 flags) is
// left on the wave path.
// Measured on one H100 (PERF.md §6): at (1, 32, 2^17) the FMAs alone take
// 0.033 ms and the stream alone 0.029; together 0.037, under torch.matmul.
// At K >= 64 one thread owns one inner column (o, i) of its lane and reads
// its K values from HBM directly, the output rows in passes of 16; it is
// off the default fusion width (max_fused_qubits 5) and untimed.
//
// diag_apply_kernel replaces diag_apply (_diag_kernel, pl.pallas_call at
// :186): (R, K) planes times a complex (1, K) diagonal, elementwise.  It
// reads each float of A once and writes each of C once (16 bytes an
// amplitude; 6 FLOP), so it is bound by bytes; float4 loads and stores
// where the planes are 16-byte aligned, and the diagonal (K floats, in
// L1 after the first warp) is read through the read-only cache, as a
// float4 per four elements for K >= 4.
#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace {

constexpr int kThreads = 256;

// -- gemm_planes_batch at K <= 32: A streamed through a ring of tiles --------

// Elements of each plane a tile, tiles in the ring, and the most blocks an
// SM (0: as many as fit).  The values below timed fastest at R K = 2^22 on
// one H100 among those chip_tiles.py tries (PERF.md §6); it builds the
// source with others by defining RING_TILING.
#ifndef RING_TILING
#define RING_TILING 2048, 2, 0
#endif
constexpr int kRingTiling[] = {RING_TILING};
constexpr int kRingTile = kRingTiling[0], kRingStages = kRingTiling[1],
              kRingBlocksSM = kRingTiling[2];

template <int K>
__global__ void __launch_bounds__(kThreads, 2)
gemm_planes_ring_kernel(const float* __restrict__ ar,
                        const float* __restrict__ ai, long long a_lane,
                        const float* __restrict__ br,
                        const float* __restrict__ bi, long long b_lane,
                        long long b_row, long long b_col,
                        float* __restrict__ cr, float* __restrict__ ci,
                        long long rows, int vec4) {
  constexpr int T = kRingTile, S = kRingStages;
  static_assert(K <= 32 && kThreads % K == 0,
                "a thread owns one column of B, in registers");
  static_assert(T % kThreads == 0 && S >= 2, "whole tiles, two stages");
  extern __shared__ __align__(16) float smem[];
  float* sbr = smem;
  float* sbi = sbr + K * K;
  float* ring = sbi + K * K;  // stage s: T of Ar, then T of Ai, at 2 T s

  const int tid = threadIdx.x;
  const long long lane = blockIdx.y;
  const float* lbr = br + lane * b_lane;
  const float* lbi = bi + lane * b_lane;
  for (int e = tid; e < K * K; e += kThreads) {
    const int r = e / K, c = e % K;
    sbr[e] = lbr[r * b_row + c * b_col];
    sbi[e] = lbi[r * b_row + c * b_col];
  }
  __syncthreads();
  const int j = tid % K;  // the output column this thread owns
  float rbr[K], rbi[K];
#pragma unroll
  for (int kk = 0; kk < K; ++kk) {
    rbr[kk] = sbr[kk * K + j];
    rbi[kk] = sbi[kk * K + j];
  }

  const long long n = rows * K;  // elements of one plane of this lane
  const float* lar = ar + lane * a_lane;
  const float* lai = ai + lane * a_lane;
  float* lcr = cr + lane * n;
  float* lci = ci + lane * n;
  const long long tiles = (n + T - 1) / T;
  const int mine = blockIdx.x < tiles
      ? (int)((tiles - 1 - blockIdx.x) / gridDim.x + 1) : 0;
  auto tile_base = [&](int i) {
    return ((long long)blockIdx.x + (long long)i * gridDim.x) * T;
  };

  // this block's tile i into stage i % S
  auto copy_tile = [&](int i) {
    const long long base = tile_base(i);
    const int cnt = (int)(n - base < T ? n - base : T);
    float* dr = ring + (i % S) * 2 * T;
    float* di = dr + T;
    if (vec4) {
      for (int e = 4 * tid; e < cnt; e += 4 * kThreads) {
        const int bytes = 4 * (cnt - e < 4 ? cnt - e : 4);
        cp_async16(dr + e, lar + base + e, bytes);
        cp_async16(di + e, lai + base + e, bytes);
      }
    } else {
      for (int e = tid; e < cnt; e += kThreads) {
        cp_async4(dr + e, lar + base + e);
        cp_async4(di + e, lai + base + e);
      }
    }
  };

  ring_walk<S>(mine, copy_tile, [&](int i) {
    const long long base = tile_base(i);
    const int cnt = (int)(n - base < T ? n - base : T);
    const float* sar = ring + (i % S) * 2 * T;
    const float* sai = sar + T;
    // e % K == j for every e this thread visits (kThreads % K == 0)
    for (int e = tid; e < cnt; e += kThreads) {
      const float* rowr = sar + (e - j);
      const float* rowi = sai + (e - j);
      // the plain version's f32 FMAs in its order: four sums over
      // k = 0 .. K - 1, then rr - ii and ri + ir
      float rr = 0.f, ii = 0.f, ri = 0.f, ir = 0.f;
      auto step = [&](float a_r, float a_i, int kk) {
        rr = fmaf(a_r, rbr[kk], rr);
        ii = fmaf(a_i, rbi[kk], ii);
        ri = fmaf(a_r, rbi[kk], ri);
        ir = fmaf(a_i, rbr[kk], ir);
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
  });
}

template <int K>
cudaError_t launch_ring(const float* ar, const float* ai, long long a_lane,
                        const float* br, const float* bi, long long b_lane,
                        long long b_row, long long b_col, float* cr,
                        float* ci, long long lanes, long long rows, int vec4,
                        cudaStream_t stream) {
  auto kernel = gemm_planes_ring_kernel<K>;
  const int smem =
      (2 * K * K + 2 * kRingStages * kRingTile) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  if (kRingBlocksSM > 0 && per_sm > kRingBlocksSM) per_sm = kRingBlocksSM;
  const long long tiles = (rows * K + kRingTile - 1) / kRingTile;
  long long per_lane = (long long)sms * per_sm / lanes;
  if (per_lane < 1) per_lane = 1;
  if (per_lane > tiles) per_lane = tiles;
  kernel<<<dim3((unsigned)per_lane, (unsigned)lanes), kThreads, smem,
           stream>>>(ar, ai, a_lane, br, bi, b_lane, b_row, b_col, cr, ci,
                     rows, vec4);
  return cudaGetLastError();
}

// -- gemm_planes_batch at K >= 64: B in shared memory ------------------------

constexpr int kTile = 4096;  // elements of one plane per tile (16 KiB)

template <int K>
__global__ void __launch_bounds__(kThreads)
gemm_planes_wide_kernel(const float* __restrict__ ar,
                        const float* __restrict__ ai, long long a_lane,
                        const float* __restrict__ br,
                        const float* __restrict__ bi, long long b_lane,
                        long long b_row, long long b_col,
                        float* __restrict__ cr, float* __restrict__ ci,
                        long long rows, int vec4) {
  static_assert(K >= 64 && kThreads % K == 0, "a thread must own one column");
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
  const long long n = rows * K;   // elements of one plane of this lane
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
      const float4* r4 = reinterpret_cast<const float4*>(sar + (e - j));
      const float4* i4 = reinterpret_cast<const float4*>(sai + (e - j));
      float rr = 0.f, ii = 0.f, ri = 0.f, ir = 0.f;
      auto step = [&](float a_r, float a_i, int kk) {
        const float b_r = sbr[kk * K + j], b_i = sbi[kk * K + j];
        rr = fmaf(a_r, b_r, rr);
        ii = fmaf(a_i, b_i, ii);
        ri = fmaf(a_r, b_i, ri);
        ir = fmaf(a_i, b_r, ir);
      };
#pragma unroll
      for (int q = 0; q < K / 4; ++q) {
        const float4 x = r4[q], y = i4[q];
        step(x.x, y.x, 4 * q + 0);
        step(x.y, y.y, 4 * q + 1);
        step(x.z, y.z, 4 * q + 2);
        step(x.w, y.w, 4 * q + 3);
      }
      lcr[base + e] = rr - ii;
      lci[base + e] = ri + ir;
    }
  }
}

template <int K>
cudaError_t launch_wide(const float* ar, const float* ai, long long a_lane,
                        const float* br, const float* bi, long long b_lane,
                        long long b_row, long long b_col, float* cr,
                        float* ci, long long lanes, long long rows, int vec4,
                        cudaStream_t stream) {
  const size_t smem = (2 * (size_t)kTile + 2 * (size_t)K * K) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      gemm_planes_wide_kernel<K>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long tiles = (rows * K + kTile - 1) / kTile;
  const long long cap = 1024;
  dim3 grid((unsigned)(tiles < cap ? tiles : cap), (unsigned)lanes);
  gemm_planes_wide_kernel<K><<<grid, kThreads, smem, stream>>>(
      ar, ai, a_lane, br, bi, b_lane, b_row, b_col, cr, ci, rows, vec4);
  return cudaGetLastError();
}

// -- gemm_planes at K >= 64: split TF32 on the tensor cores ------------------

// x's TF32 rounding (nearest, ties away from zero) in an f32 container
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = tf32_rna(x);
  small = tf32_rna(x - __uint_as_float(big));
}

// d += a b over one m16n8k8 TF32 tile, f32 sums
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

// Fragment order of B: step s (8 reduction indices) and n-tile j (8 output
// columns) hold, for lane (g = lane / 4, t = lane % 4), the float4
// (Br[k0][n], Br[k0 + 1][n], Bi[k0][n], Bi[k0 + 1][n]) with
//   k0 = 16 (s / 2) + 4 t + 2 (s % 2)   (slots t and t + 4 of the step)
//   n  = 16 (j / 2) + 4 (g / 2) + 2 (j % 2) + g % 2.
// The first makes slots t, t+4 of steps 2c and 2c+1 the float4 at column
// 16c + 4t of A's row; the second makes accumulator columns 2t, 2t+1 of
// n-tiles 2p and 2p+1 the float4 at column 16p + 4t of C's row.
// Work units: a warp takes 16 rows by K / NC output columns at a time (NC
// warps share a row tile), WARPS warps a block.  The values below timed
// fastest at R K = 2^22 on one H100 among those chip_tiles.py tries
// (PERF.md §6; TC_TILING is NC, then warps, at K = 128 and at K = 64); at
// K = 128 more warps or fewer accumulators a warp did not help: mma.sync's
// TF32 rate sets the pace.
#ifndef TC_TILING
#define TC_TILING 1, 8, 2, 16
#endif
constexpr int kTcTiling[] = {TC_TILING};
constexpr int tc_nc(int K) { return K >= 128 ? kTcTiling[0] : kTcTiling[2]; }
constexpr int tc_warps(int K) {
  return K >= 128 ? kTcTiling[1] : kTcTiling[3];
}

template <int K, int NC, int WARPS>
__global__ void __launch_bounds__(WARPS * 32, 1)
gemm_planes_tc_kernel(const float* __restrict__ ar,
                      const float* __restrict__ ai,
                      const float* __restrict__ br,
                      const float* __restrict__ bi, long long b_row,
                      long long b_col, float* __restrict__ cr,
                      float* __restrict__ ci, long long rows) {
  constexpr int NT = K / 8;    // n-tiles (and k-steps) of the whole B
  constexpr int NTC = NT / NC; // n-tiles a warp owns
  constexpr int KC = K / 16;   // chunks of two k-steps: one float4 a row
  static_assert(NTC % 2 == 0, "n-tiles go in pairs");
  extern __shared__ __align__(16) float smem[];
  float4* sb = reinterpret_cast<float4*>(smem);  // [NT steps][NT][32]
  for (int e = threadIdx.x; e < NT * NT * 32; e += WARPS * 32) {
    const int lane = e & 31, j = (e >> 5) % NT, s = (e >> 5) / NT;
    const int g = lane >> 2, t = lane & 3;
    const long long k0 = 16 * (s >> 1) + 4 * t + 2 * (s & 1);
    const long long n = 16 * (j >> 1) + 4 * (g >> 1) + 2 * (j & 1) + (g & 1);
    const long long o = k0 * b_row + n * b_col;
    sb[e] = make_float4(br[o], br[o + b_row], bi[o], bi[o + b_row]);
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const long long units = (rows + 15) / 16 * NC;
  const long long n_warps = (long long)gridDim.x * WARPS;
  for (long long unit = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
       unit < units; unit += n_warps) {
    const long long tile = unit / NC;
    const int j0 = (int)(unit % NC) * NTC;  // the warp's first n-tile
    const long long r0 = tile * 16 + g, r1 = r0 + 8;
    const bool v0 = r0 < rows, v1 = r1 < rows;
    // row g and row g + 8 of both planes, as float4 chunks of 16 columns
    const float4* pa[4] = {
        reinterpret_cast<const float4*>(ar + r0 * K) + t,
        reinterpret_cast<const float4*>(ar + r1 * K) + t,
        reinterpret_cast<const float4*>(ai + r0 * K) + t,
        reinterpret_cast<const float4*>(ai + r1 * K) + t};
    const bool live[4] = {v0, v1, v0, v1};
    float4 x[4], nx[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      x[q] = live[q] ? __ldg(pa[q]) : make_float4(0.f, 0.f, 0.f, 0.f);

    float accr[NTC][4], acci[NTC][4];
#pragma unroll
    for (int j = 0; j < NTC; ++j)
#pragma unroll
      for (int u = 0; u < 4; ++u) accr[j][u] = acci[j][u] = 0.f;

#pragma unroll 1
    for (int c = 0; c < KC; ++c) {
      if (c + 1 < KC) {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          nx[q] = live[q] ? __ldg(pa[q] + 4 * (c + 1))
                          : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        // A fragments (rows g, g+8; slots t, t+4) of step 2c + h
        const float fr[4] = {h ? x[0].z : x[0].x, h ? x[1].z : x[1].x,
                             h ? x[0].w : x[0].y, h ? x[1].w : x[1].y};
        const float fi[4] = {h ? x[2].z : x[2].x, h ? x[3].z : x[3].x,
                             h ? x[2].w : x[2].y, h ? x[3].w : x[3].y};
        uint32_t rb[4], rs[4], ib[4], is[4], nb[4], ns[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          split_tf32(fr[u], rb[u], rs[u]);
          split_tf32(fi[u], ib[u], is[u]);
          nb[u] = ib[u] ^ 0x80000000u;  // -Ai: the split of -x is -(split)
          ns[u] = is[u] ^ 0x80000000u;
        }
        const float4* srow = sb + ((size_t)(2 * c + h) * NT + j0) * 32 + lane;
#pragma unroll
        for (int j = 0; j < NTC; ++j) {
          const float4 b = srow[j * 32];
          uint32_t brb0, brs0, brb1, brs1, bib0, bis0, bib1, bis1;
          split_tf32(b.x, brb0, brs0);
          split_tf32(b.y, brb1, brs1);
          split_tf32(b.z, bib0, bis0);
          split_tf32(b.w, bib1, bis1);
          mma_3xtf32(accr[j], rb, rs, brb0, brb1, brs0, brs1);  // Ar Br
          mma_3xtf32(acci[j], rb, rs, bib0, bib1, bis0, bis1);  // Ar Bi
          mma_3xtf32(accr[j], nb, ns, bib0, bib1, bis0, bis1);  // -Ai Bi
          mma_3xtf32(acci[j], ib, is, brb0, brb1, brs0, brs1);  // Ai Br
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) x[q] = nx[q];
    }

    // n-tiles 2p, 2p+1: columns 16p + 4t .. +3 of rows g and g + 8
    float* cr0 = cr + r0 * K + 4 * t + 8 * j0;
    float* ci0 = ci + r0 * K + 4 * t + 8 * j0;
#pragma unroll
    for (int p = 0; p < NTC / 2; ++p) {
      if (v0) {
        *reinterpret_cast<float4*>(cr0 + 16 * p) = make_float4(
            accr[2 * p][0], accr[2 * p][1], accr[2 * p + 1][0],
            accr[2 * p + 1][1]);
        *reinterpret_cast<float4*>(ci0 + 16 * p) = make_float4(
            acci[2 * p][0], acci[2 * p][1], acci[2 * p + 1][0],
            acci[2 * p + 1][1]);
      }
      if (v1) {
        *reinterpret_cast<float4*>(cr0 + 8 * K + 16 * p) = make_float4(
            accr[2 * p][2], accr[2 * p][3], accr[2 * p + 1][2],
            accr[2 * p + 1][3]);
        *reinterpret_cast<float4*>(ci0 + 8 * K + 16 * p) = make_float4(
            acci[2 * p][2], acci[2 * p][3], acci[2 * p + 1][2],
            acci[2 * p + 1][3]);
      }
    }
  }
}

template <int K>
cudaError_t launch_tc(const float* ar, const float* ai, const float* br,
                      const float* bi, long long b_row, long long b_col,
                      float* cr, float* ci, long long rows,
                      cudaStream_t stream) {
  constexpr int NC = tc_nc(K), WARPS = tc_warps(K);
  auto kernel = gemm_planes_tc_kernel<K, NC, WARPS>;
  const int smem = 2 * K * K * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, WARPS * 32, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long units = (rows + 15) / 16 * NC;
  const long long need = (units + WARPS - 1) / WARPS;
  const long long cap = (long long)sms * per_sm;
  kernel<<<(unsigned)(need < cap ? need : cap), WARPS * 32, smem, stream>>>(
      ar, ai, br, bi, b_row, b_col, cr, ci, rows);
  return cudaGetLastError();
}

// -- gemm_planes_mid(_batch) at K <= 32: slabs of A streamed through a ring -

// Output rows a thread at most (a column's K rows go to K / kMidRows
// threads), neighbouring columns a thread, and slabs in the ring.  The
// values below timed fastest at (O, K, I) = (1, 32, 2^17) on one H100 among
// those chip_tiles.py tries (PERF.md §6); it builds the source with others
// by defining MID_TILING.
#ifndef MID_TILING
#define MID_TILING 4, 2, 2
#endif
constexpr int kMidTiling[] = {MID_TILING};
constexpr int kMidRows = kMidTiling[0], kMidCols = kMidTiling[1],
              kMidStages = kMidTiling[2];

template <int K>
struct MidShape {
  static constexpr int RT = K < kMidRows ? K : kMidRows;  // rows a thread
  static constexpr int P = K / RT;                // threads on one column
  static constexpr int TC = kThreads / P;         // threads on one row
  static constexpr int TI = TC * kMidCols;        // columns a slab
};

// A slab's TI columns: TI neighbouring inner columns of one o where I is
// at least a slab wide (a unit is (o, inner tile)); where I is narrower
// (and a multiple of a thread's columns), the I columns of each of TI / I
// neighbouring o's side by side (a unit is that run of o's).  Like every
// choice that touches an element's sum, it depends on (K, I) alone.
template <int K>
__host__ __device__ constexpr bool mid_narrow(long long inner) {
  return inner < MidShape<K>::TI && inner % kMidCols == 0;
}

// work units of one lane
template <int K>
__host__ __device__ constexpr long long mid_units(long long outer,
                                                  long long inner) {
  return mid_narrow<K>(inner)
      ? (outer + MidShape<K>::TI / inner - 1) / (MidShape<K>::TI / inner)
      : outer * ((inner + MidShape<K>::TI - 1) / MidShape<K>::TI);
}

template <int K>
__global__ void __launch_bounds__(kThreads, 2)
gemm_planes_mid_ring_kernel(const float* __restrict__ ar,
                            const float* __restrict__ ai, long long a_lane,
                            const float* __restrict__ ur,
                            const float* __restrict__ ui, long long u_lane,
                            long long u_row, long long u_col,
                            float* __restrict__ cr, float* __restrict__ ci,
                            long long outer, long long inner, int vec4) {
  constexpr int RT = MidShape<K>::RT, TC = MidShape<K>::TC;
  constexpr int TI = MidShape<K>::TI, CT = kMidCols;
  constexpr int S = kMidStages, SLAB = K * TI;
  static_assert(K <= 32 && K % RT == 0 && TC >= 32 && TI % 4 == 0 &&
                (CT == 1 || CT == 2) && S >= 2,
                "a warp shares its output rows; whole float4 chunks");
  extern __shared__ __align__(16) float smem[];
  float* sur = smem;  // sur[k * K + j] = Re U[j][k] of this block's lane
  float* sui = sur + K * K;
  float* ring = sui + K * K;  // stage s: the slab's Ar, then its Ai, at 2 SLAB s

  // blockIdx.y is the lane: its (O, K, I) stacks of A and C, and its U
  const long long lane = blockIdx.y;
  ar += lane * a_lane;
  ai += lane * a_lane;
  cr += lane * outer * K * inner;
  ci += lane * outer * K * inner;
  ur += lane * u_lane;
  ui += lane * u_lane;
  const int tid = threadIdx.x;
  for (int e = tid; e < K * K; e += kThreads) {
    const int k = e / K, j = e % K;
    sur[e] = ur[j * u_row + k * u_col];
    sui[e] = ui[j * u_row + k * u_col];
  }
  // sur is published by ring_walk's first barrier
  const int c = (tid % TC) * CT;   // the first slab column this thread owns
  const int j0 = (tid / TC) * RT;  // and its first output row

  const bool narrow = mid_narrow<K>(inner);
  const int span = narrow ? (int)inner : TI;  // a slab's columns of one o
  const long long tiles = (inner + TI - 1) / TI;
  const long long units = mid_units<K>(outer, inner);
  const int mine = blockIdx.x < units
      ? (int)((units - 1 - blockIdx.x) / gridDim.x + 1) : 0;
  auto unit = [&](int i, long long& base, int& cnt) {
    const long long u = (long long)blockIdx.x + (long long)i * gridDim.x;
    if (narrow) {
      const long long o0 = u * (TI / span);
      const long long n = outer - o0 < TI / span ? outer - o0 : TI / span;
      base = o0 * K * inner;  // element (o0, 0, 0) of a plane
      cnt = (int)(n * inner);
    } else {
      const long long o = u / tiles, i0 = (u - o * tiles) * TI;
      base = o * K * inner + i0;  // element (o, 0, i0) of a plane
      cnt = (int)(inner - i0 < TI ? inner - i0 : TI);
    }
  };
  // slab column col's element in row 0, from base: each o's K rows of I
  // follow the previous o's
  auto col_at = [&](int col) -> long long {
    return narrow ? (long long)(col / span) * (K - 1) * inner + col : col;
  };

  auto copy_slab = [&](int i) {
    long long base;
    int cnt;
    unit(i, base, cnt);
    float* dr = ring + (i % S) * 2 * SLAB;
    float* di = dr + SLAB;
    if (vec4) {
      // I % 4 == 0: a chunk never crosses from one o into the next
      for (int e = tid; e < SLAB / 4; e += kThreads) {
        const int k = e / (TI / 4), col = 4 * (e % (TI / 4));
        if (col < cnt) {
          const int bytes = 4 * (cnt - col < 4 ? cnt - col : 4);
          const long long g = base + col_at(col) + k * inner;
          cp_async16(dr + k * TI + col, ar + g, bytes);
          cp_async16(di + k * TI + col, ai + g, bytes);
        }
      }
    } else {
      for (int e = tid; e < SLAB; e += kThreads) {
        const int k = e / TI, col = e % TI;
        if (col < cnt) {
          const long long g = base + col_at(col) + k * inner;
          cp_async4(dr + k * TI + col, ar + g);
          cp_async4(di + k * TI + col, ai + g);
        }
      }
    }
  };

  ring_walk<S>(mine, copy_slab, [&](int i) {
    long long base;
    int cnt;
    unit(i, base, cnt);
    if (c >= cnt) return;
    const float* xr = ring + (i % S) * 2 * SLAB + c;
    const float* xi = xr + SLAB;
    // the plain version's f32 FMAs in its order: four sums over
    // k = 0 .. K - 1, then rr - ii and ri + ir
    float rr[CT][RT], ii[CT][RT], ri[CT][RT], ir[CT][RT];
#pragma unroll
    for (int h = 0; h < CT; ++h)
#pragma unroll
      for (int j = 0; j < RT; ++j)
        rr[h][j] = ii[h][j] = ri[h][j] = ir[h][j] = 0.f;
    auto step = [&](const float (&x_r)[CT], const float (&x_i)[CT],
                    float u_r, float u_i, int j) {
#pragma unroll
      for (int h = 0; h < CT; ++h) {
        rr[h][j] = fmaf(u_r, x_r[h], rr[h][j]);
        ii[h][j] = fmaf(u_i, x_i[h], ii[h][j]);
        ri[h][j] = fmaf(u_r, x_i[h], ri[h][j]);
        ir[h][j] = fmaf(u_i, x_r[h], ir[h][j]);
      }
    };
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      float x_r[CT], x_i[CT];
      if constexpr (CT == 2) {
        const float2 a = *reinterpret_cast<const float2*>(xr + k * TI);
        const float2 b = *reinterpret_cast<const float2*>(xi + k * TI);
        x_r[0] = a.x; x_r[1] = a.y;
        x_i[0] = b.x; x_i[1] = b.y;
      } else {
        x_r[0] = xr[k * TI];
        x_i[0] = xi[k * TI];
      }
      if constexpr (RT >= 4) {
        // four output rows a broadcast float4 of each U^T plane
        const float4* u4 = reinterpret_cast<const float4*>(sur + k * K + j0);
        const float4* v4 = reinterpret_cast<const float4*>(sui + k * K + j0);
#pragma unroll
        for (int q = 0; q < RT / 4; ++q) {
          const float4 u = u4[q], v = v4[q];
          step(x_r, x_i, u.x, v.x, 4 * q + 0);
          step(x_r, x_i, u.y, v.y, 4 * q + 1);
          step(x_r, x_i, u.z, v.z, 4 * q + 2);
          step(x_r, x_i, u.w, v.w, 4 * q + 3);
        }
      } else {
#pragma unroll
        for (int j = 0; j < RT; ++j)
          step(x_r, x_i, sur[k * K + j0 + j], sui[k * K + j0 + j], j);
      }
    }
    float accr[CT][RT], acci[CT][RT];
#pragma unroll
    for (int h = 0; h < CT; ++h)
#pragma unroll
      for (int j = 0; j < RT; ++j) {
        accr[h][j] = rr[h][j] - ii[h][j];
        acci[h][j] = ri[h][j] + ir[h][j];
      }
    // row j0 + j of the output slab, straight from registers (coalesced;
    // two columns as one 8-byte store where I keeps them aligned: c is
    // even and, for a narrow I, both columns lie in one o)
    float* pr = cr + base + col_at(c) + (long long)j0 * inner;
    float* pi = ci + base + col_at(c) + (long long)j0 * inner;
    if (CT == 2 && inner % 2 == 0 && c + 2 <= cnt) {
#pragma unroll
      for (int j = 0; j < RT; ++j) {
        *reinterpret_cast<float2*>(pr + j * inner) =
            make_float2(accr[0][j], accr[CT - 1][j]);
        *reinterpret_cast<float2*>(pi + j * inner) =
            make_float2(acci[0][j], acci[CT - 1][j]);
      }
      return;
    }
#pragma unroll
    for (int j = 0; j < RT; ++j)
#pragma unroll
      for (int h = 0; h < CT; ++h)
        if (h == 0 || c + h < cnt) {
          pr[j * inner + h] = accr[h][j];
          pi[j * inner + h] = acci[h][j];
        }
  });
}

template <int K>
cudaError_t launch_mid_ring(const float* ar, const float* ai,
                            long long a_lane, const float* ur,
                            const float* ui, long long u_lane,
                            long long u_row, long long u_col, float* cr,
                            float* ci, long long lanes, long long outer,
                            long long inner, int vec4, cudaStream_t stream) {
  auto kernel = gemm_planes_mid_ring_kernel<K>;
  constexpr int TI = MidShape<K>::TI;
  const int smem = (2 * K * K + 2 * kMidStages * K * TI) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long lane_units = mid_units<K>(outer, inner);
  // the resident blocks shared out over the lanes (blockIdx.y)
  long long grid = (long long)sms * per_sm / lanes;
  if (grid < 1) grid = 1;
  if (grid > lane_units) grid = lane_units;
  kernel<<<dim3((unsigned)grid, (unsigned)lanes), kThreads, smem, stream>>>(
      ar, ai, a_lane, ur, ui, u_lane, u_row, u_col, cr, ci, outer, inner,
      vec4);
  return cudaGetLastError();
}

// -- gemm_planes_mid(_batch) at K >= 64: one inner column a thread ----------

constexpr int kMidThreads = 256;

template <int K>
__global__ void __launch_bounds__(kMidThreads)
gemm_planes_mid_kernel(const float* __restrict__ ar,
                       const float* __restrict__ ai, long long a_lane,
                       const float* __restrict__ ur,
                       const float* __restrict__ ui, long long u_lane,
                       long long u_row, long long u_col,
                       float* __restrict__ cr, float* __restrict__ ci,
                       long long outer, long long inner) {
  constexpr int JC = 16;  // output rows a pass
  static_assert(K >= 64, "K <= 32 runs gemm_planes_mid_ring_kernel");
  extern __shared__ __align__(16) float smem[];
  float* sur = smem;       // sur[k * K + j] = Re U[j][k] of this block's lane
  float* sui = smem + K * K;
  // blockIdx.y is the lane, as in the ring body
  const long long lane = blockIdx.y;
  ar += lane * a_lane;
  ai += lane * a_lane;
  cr += lane * outer * K * inner;
  ci += lane * outer * K * inner;
  ur += lane * u_lane;
  ui += lane * u_lane;
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
      // four sums over k in order, then rr - ii and ri + ir, as the ring
      float rr[JC], ii[JC], ri[JC], ir[JC];
#pragma unroll
      for (int j = 0; j < JC; ++j) rr[j] = ii[j] = ri[j] = ir[j] = 0.f;
#pragma unroll 8
      for (int k = 0; k < K; ++k) {
        const float xr = ar[base + k * inner];
        const float xi = ai[base + k * inner];
        const float4* u4 = reinterpret_cast<const float4*>(sur + k * K + j0);
        const float4* v4 = reinterpret_cast<const float4*>(sui + k * K + j0);
#pragma unroll
        for (int q = 0; q < JC / 4; ++q) {
          const float4 u = u4[q], v = v4[q];
          const float us[4] = {u.x, u.y, u.z, u.w};
          const float vs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int h = 0; h < 4; ++h) {
            const int j = 4 * q + h;
            rr[j] = fmaf(us[h], xr, rr[j]);
            ii[j] = fmaf(vs[h], xi, ii[j]);
            ri[j] = fmaf(us[h], xi, ri[j]);
            ir[j] = fmaf(vs[h], xr, ir[j]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < JC; ++j) {
        cr[base + (long long)(j0 + j) * inner] = rr[j] - ii[j];
        ci[base + (long long)(j0 + j) * inner] = ri[j] + ir[j];
      }
    }
  }
}

template <int K>
cudaError_t launch_mid(const float* ar, const float* ai, long long a_lane,
                       const float* ur, const float* ui, long long u_lane,
                       long long u_row, long long u_col, float* cr,
                       float* ci, long long lanes, long long outer,
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
  long long cap = 4096 / lanes;  // blocks a lane
  if (cap < 1) cap = 1;
  gemm_planes_mid_kernel<K><<<dim3((unsigned)(blocks < cap ? blocks : cap),
                                   (unsigned)lanes),
                              kMidThreads, smem, stream>>>(
      ar, ai, a_lane, ur, ui, u_lane, u_row, u_col, cr, ci, outer, inner);
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
    case 2: return (int)launch_ring<2>(ar, ai, a_lane, br, bi, b_lane, b_row, b_col, cr, ci, lanes, rows, vec4, s);
    case 4: return (int)launch_ring<4>(ar, ai, a_lane, br, bi, b_lane, b_row, b_col, cr, ci, lanes, rows, vec4, s);
    case 8: return (int)launch_ring<8>(ar, ai, a_lane, br, bi, b_lane, b_row, b_col, cr, ci, lanes, rows, vec4, s);
    case 16: return (int)launch_ring<16>(ar, ai, a_lane, br, bi, b_lane, b_row, b_col, cr, ci, lanes, rows, vec4, s);
    case 32: return (int)launch_ring<32>(ar, ai, a_lane, br, bi, b_lane, b_row, b_col, cr, ci, lanes, rows, vec4, s);
    case 64: return (int)launch_wide<64>(ar, ai, a_lane, br, bi, b_lane, b_row, b_col, cr, ci, lanes, rows, vec4, s);
    case 128: return (int)launch_wide<128>(ar, ai, a_lane, br, bi, b_lane, b_row, b_col, cr, ci, lanes, rows, vec4, s);
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

// B6: one (R, K) x (K, K) product — B1's ring body with one lane for
// K <= 32, the split-TF32 tensor-core kernel for K >= 64 when A's planes
// are 16-byte aligned (vec4; C is allocated by the caller, aligned), else
// the wide body.
int gemm_planes_f32(const float* ar, const float* ai, const float* br,
                    const float* bi, long long b_row, long long b_col,
                    float* cr, float* ci, long long rows, int k, int vec4,
                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec4 && rows > 0) {
    if (k == 64)
      return (int)launch_tc<64>(ar, ai, br, bi, b_row, b_col, cr, ci, rows, s);
    if (k == 128)
      return (int)launch_tc<128>(ar, ai, br, bi, b_row, b_col, cr, ci, rows, s);
  }
  return dispatch_gemm(ar, ai, 0, br, bi, 0, b_row, b_col, cr, ci, 1, rows,
                       k, vec4, s);
}

// B7 and its lane-batched form (gemm_planes_mid is the call with one lane).
// A is an (L, O, K, I) stack whose lanes are each a contiguous (O, K, I)
// stack, the two planes sharing the lane stride a_lane; U (L, K, K) any
// strides (u_lane 0: one U for every lane); C is written contiguous
// (L, O, K, I).  vec4 = both A planes 16-byte aligned, I % 4 == 0 and
// a_lane % 4 == 0 (every row of every slab is then 16-byte aligned).  The
// variant and the tiling follow from (K, I) alone, so lane l of an L-lane
// call is bit for bit the one-lane call on lane l's operands.
int gemm_planes_mid_batch_f32(const float* ar, const float* ai,
                              long long a_lane, const float* ur,
                              const float* ui, long long u_lane,
                              long long u_row, long long u_col, float* cr,
                              float* ci, long long lanes, long long outer,
                              int k, long long inner, int vec4,
                              void* stream) {
  if (lanes <= 0 || lanes > 65535 || outer <= 0 || inner <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 2: return (int)launch_mid_ring<2>(ar, ai, a_lane, ur, ui, u_lane, u_row, u_col, cr, ci, lanes, outer, inner, vec4, s);
    case 4: return (int)launch_mid_ring<4>(ar, ai, a_lane, ur, ui, u_lane, u_row, u_col, cr, ci, lanes, outer, inner, vec4, s);
    case 8: return (int)launch_mid_ring<8>(ar, ai, a_lane, ur, ui, u_lane, u_row, u_col, cr, ci, lanes, outer, inner, vec4, s);
    case 16: return (int)launch_mid_ring<16>(ar, ai, a_lane, ur, ui, u_lane, u_row, u_col, cr, ci, lanes, outer, inner, vec4, s);
    case 32: return (int)launch_mid_ring<32>(ar, ai, a_lane, ur, ui, u_lane, u_row, u_col, cr, ci, lanes, outer, inner, vec4, s);
    case 64: return (int)launch_mid<64>(ar, ai, a_lane, ur, ui, u_lane, u_row, u_col, cr, ci, lanes, outer, inner, s);
    case 128: return (int)launch_mid<128>(ar, ai, a_lane, ur, ui, u_lane, u_row, u_col, cr, ci, lanes, outer, inner, s);
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
