// Fused pwrel encode and decode of f32 planes, for Hopper (sm_90a).
//
// encode_kernel replaces two TPU kernels in one pass:
//   repro/kernels/quantize.py::quantize_tiles (kernel body _quantize_kernel,
//     src/repro/kernels/quantize.py:65) — codes, ballot sign words, per-tile
//     uniformity flags;
//   repro/kernels/pack.py::pack_codes_tiles (kernel body _pack_codes_kernel,
//     src/repro/kernels/pack.py:55) — two u16 codes per int32 word.
// It writes the u16 code stream directly (the little-endian view of B3's
// u16-pair words), so no int32 code array ever reaches device memory:
//
//   code = CODE_MAX - rint((l_max - log2|x|) / step), 0 for an exact zero,
//          clipped to [0, CODE_MAX];  sign bit i of word w = (x[32w+i] < 0).
//
// decode_kernel replaces
//   repro/kernels/pack.py::unpack_codes_tiles (_unpack_codes_kernel,
//     src/repro/kernels/pack.py:79) and
//   repro/kernels/quantize.py::dequantize_tiles (_dequantize_kernel,
//     src/repro/kernels/quantize.py:112):
//
//   x = ±exp2(l_max - (CODE_MAX - c) * step), 0 for c = 0,
//
// written straight into the wave's (R, 2, N) plane stack at the plane's own
// offset, so there is no per-block concatenate.
//
// Both kernels take a batch of P planes of n elements (any n: the ragged
// edge is masked here, where the TPU version padded each plane to whole
// 128-lane rows) and run once per wave.  Plane q of a batch is component
// q % 2 (re/im) of block q / 2, and block b lives in row b / n_blocks at
// element offset (b % n_blocks) * n of the (R, 2, N) stack.  The decode may
// take a plane map (wire plane j -> stack plane q) for waves in which some
// blocks crossed as raw complex64.
//
// Codes are templated: u16 for the wire, int32 for the TPU-layout wrappers
// quantize_tiles / dequantize_tiles, which hold the (rows, 128) i32 codes.
//
// What bounds them: HBM bytes.  Encode reads 4 B and writes 2 B of code and
// 1/8 B of sign per element (~2.13 B); decode the reverse.  log2f/exp2f and
// one IEEE division per element are far below the card's rate.  The design
// keeps that traffic to one read and one write: each thread loads kPer
// elements before it computes (the loads are in flight together), a warp
// covers 32 neighbouring elements so every global access is coalesced, and
// the sign word is one __ballot_sync per warp.  It is a simple kernel that
// is right; 16-byte stores of the codes are left for a later change.
// Triton could express both passes; CUDA C++ is the port's rule, and the
// warp ballot and the u16 stores are natural in it.
//
// Rounding follows the plain version, so codes agree to within one at a
// rounding tie: IEEE division (no --use_fast_math), rintf (half to even, as
// torch.round and jnp.round), and a decode exponent rounded as two separate
// f32 operations (__fmul_rn / __fsub_rn: nvcc would otherwise contract
// l_max - d*step into one fma).  Subnormals are not flushed (no -ftz).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 8;                       // elements per thread per chunk
constexpr int kChunk = kThreads * kPer;       // elements per block per chunk
constexpr float kCodeMax = 65535.f;
constexpr unsigned kFull = 0xffffffffu;

struct Stack {  // where plane q of a batch lives in an (R, 2, N) stack
  long long row_stride, comp_stride, n, n_blocks;
  __device__ long long offset(long long q) const {
    const long long blk = q >> 1;
    return (blk / n_blocks) * row_stride + (q & 1) * comp_stride +
           (blk % n_blocks) * n;
  }
};

__device__ __forceinline__ int encode_one(float v, float l_max, float step) {
  const float a = fabsf(v);
  if (!(a > 0.f)) return 0;  // exact zero: the escape code
  const float d = rintf(__fdiv_rn(__fsub_rn(l_max, log2f(a)), step));
  return (int)fminf(fmaxf(__fsub_rn(kCodeMax, d), 0.f), kCodeMax);
}

// flags (when not null) must come in as 1s: a warp that finds a tile not
// uniform writes 0 there, and several warps write the same 0.
template <typename CodeT>
__global__ void __launch_bounds__(kThreads)
encode_kernel(const float* __restrict__ x, Stack geo,
              const float* __restrict__ l_max, float step,
              CodeT* __restrict__ codes, uint32_t* __restrict__ signs,
              int* __restrict__ flags, long long tile_elems,
              long long n_tiles) {
  const long long p = blockIdx.y;
  const long long n = geo.n;
  const long long words = (n + 31) >> 5;
  const float* src = x + geo.offset(p);
  const float lm = l_max[p];
  CodeT* pc = codes + p * n;
  uint32_t* ps = signs + p * words;
  // with flags, the pad of the last 128-lane row belongs to a tile: it
  // counts as zeros (code 0, sign 0), as in the TPU kernel's padded plane
  const long long limit = flags ? n_tiles * tile_elems : n;
  const int lane = threadIdx.x & 31;
  const int warp0 = threadIdx.x - lane;

  for (long long base = (long long)blockIdx.x * kChunk; base < limit;
       base += (long long)gridDim.x * kChunk) {
    float v[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const long long e = base + k * kThreads + threadIdx.x;
      v[k] = e < n ? src[e] : 0.f;
    }
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const long long e0 = base + k * kThreads + warp0;  // the warp's first
      if (e0 >= limit) break;                            // warp-uniform
      const long long e = e0 + lane;
      const int c = encode_one(v[k], lm, step);
      const unsigned s = __ballot_sync(kFull, v[k] < 0.f);
      if (e < n) pc[e] = (CodeT)c;
      if (lane == 0 && e0 < n) ps[e0 >> 5] = s;
      if (flags) {
        const bool any_code = __any_sync(kFull, c != 0);
        if (lane == 0) {
          int* f = flags + (p * n_tiles + e0 / tile_elems) * 3;
          if (any_code) f[0] = 0;
          if (s != 0u) f[1] = 0;
          if (s != kFull) f[2] = 0;
        }
      }
    }
  }
}

template <typename CodeT>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const CodeT* __restrict__ codes,
              const uint32_t* __restrict__ signs,
              const float* __restrict__ l_max, float step,
              const int* __restrict__ plane_map, long long stack_planes,
              Stack geo, float* __restrict__ out) {
  const long long j = blockIdx.y;
  const long long q = plane_map ? (long long)plane_map[j] : j;
  if (q < 0 || q >= stack_planes) return;  // a bad map entry writes nothing
  const long long n = geo.n;
  const long long words = (n + 31) >> 5;
  const CodeT* pc = codes + j * n;
  const uint32_t* ps = signs + j * words;
  const float lm = l_max[j];
  float* dst = out + geo.offset(q);

  for (long long base = (long long)blockIdx.x * kChunk; base < n;
       base += (long long)gridDim.x * kChunk) {
    int c[kPer];
    uint32_t w[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const long long e = base + k * kThreads + threadIdx.x;
      c[k] = e < n ? (int)pc[e] : 0;
      w[k] = e < n ? ps[e >> 5] : 0u;
    }
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const long long e = base + k * kThreads + threadIdx.x;
      if (e >= n) break;
      float mag = 0.f;
      if (c[k] != 0) {
        const float d = __fsub_rn(kCodeMax, (float)c[k]);
        mag = exp2f(__fsub_rn(lm, __fmul_rn(d, step)));
      }
      dst[e] = ((w[k] >> (e & 31)) & 1u) ? -mag : mag;
    }
  }
}

dim3 grid_for(long long elems, long long planes) {
  const long long chunks = (elems + kChunk - 1) / kChunk;
  const long long cap = 2048;
  return dim3((unsigned)(chunks < cap ? chunks : cap), (unsigned)planes);
}

bool bad_batch(long long planes, long long n) {
  return planes <= 0 || planes > 65535 || n <= 0;
}

}  // namespace

extern "C" {

// Returns the cudaError_t of the launch (0 = launched).  code_bytes is 2
// (u16 codes) or 4 (int32 codes).  flags is null, or (planes, n_tiles, 3)
// int32 filled with 1s, with n_tiles * tile_elems >= n (the padded plane).
int codec_encode_f32(const float* x, long long row_stride,
                     long long comp_stride, long long n, long long n_blocks,
                     long long planes, const float* l_max, float step,
                     void* codes, int code_bytes, uint32_t* signs, int* flags,
                     long long tile_elems, long long n_tiles, void* stream) {
  if (bad_batch(planes, n) || n_blocks <= 0 ||
      (flags && (tile_elems <= 0 || tile_elems % 32 != 0 ||
                 n_tiles * tile_elems < n)))
    return (int)cudaErrorInvalidValue;
  const Stack geo{row_stride, comp_stride, n, n_blocks};
  const dim3 grid = grid_for(flags ? n_tiles * tile_elems : n, planes);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (code_bytes == 2)
    encode_kernel<uint16_t><<<grid, kThreads, 0, s>>>(
        x, geo, l_max, step, static_cast<uint16_t*>(codes), signs, flags,
        tile_elems, n_tiles);
  else if (code_bytes == 4)
    encode_kernel<int32_t><<<grid, kThreads, 0, s>>>(
        x, geo, l_max, step, static_cast<int32_t*>(codes), signs, flags,
        tile_elems, n_tiles);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// Returns the cudaError_t of the launch (0 = launched).  plane_map is null
// (wire plane j is stack plane j) or an int32 array of `planes` entries in
// [0, stack_planes), the planes of the (R, 2, N) stack `out`.
int codec_decode_f32(const void* codes, int code_bytes,
                     const uint32_t* signs, const float* l_max, float step,
                     const int* plane_map, long long planes,
                     long long stack_planes, float* out,
                     long long row_stride, long long comp_stride, long long n,
                     long long n_blocks, void* stream) {
  if (bad_batch(planes, n) || n_blocks <= 0 ||
      (!plane_map && planes > stack_planes))
    return (int)cudaErrorInvalidValue;
  const Stack geo{row_stride, comp_stride, n, n_blocks};
  const dim3 grid = grid_for(n, planes);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (code_bytes == 2)
    decode_kernel<uint16_t><<<grid, kThreads, 0, s>>>(
        static_cast<const uint16_t*>(codes), signs, l_max, step, plane_map,
        stack_planes, geo, out);
  else if (code_bytes == 4)
    decode_kernel<int32_t><<<grid, kThreads, 0, s>>>(
        static_cast<const int32_t*>(codes), signs, l_max, step, plane_map,
        stack_planes, geo, out);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

const char* codec_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
