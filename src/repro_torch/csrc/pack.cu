// Standalone code and sign-bit packing of (rows, 128) int32 tiles, for
// Hopper (sm_90a).
//
// Replaces four TPU kernels of repro/kernels/pack.py:
//   pack_codes_tiles    (_pack_codes_kernel, pl.pallas_call at :61) —
//     two u16 codes per int32 word, element 2j in the low half and 2j+1 in
//     the high half: (rows, 128) -> (rows, 64);
//   unpack_codes_tiles  (_unpack_codes_kernel, :85) — its inverse;
//   pack_bitmap_tiles   (_pack_bitmap_kernel, :109) — 32 bits -> one int32
//     word, bit i of word w = lane 32w + i (LSB first): (rows, 128) ->
//     (rows, 4);
//   unpack_bitmap_tiles (_unpack_bitmap_kernel, :132) — its inverse, bits
//     as int32 in {0, 1}.
//
// The device codec's main path does not launch the first two: its fused
// encode and decode kernels (codec.cu) store and read the u16 code stream
// directly.  These are the kernels of the TPU-layout wrappers and of
// kernels/ops.py (pack_codes, unpack_codes, pack_sign_bitmap,
// unpack_sign_bitmap).
//
// What bounds them: HBM bytes.  None does more than a shift and an or per
// element.  Code packing moves 4 B in and 2 B out per code (unpacking the
// reverse); bitmap packing 4 B (int32 bits, or 1 B for bool) in and 1/8 B
// out per element (unpacking the reverse).  The design keeps each byte to
// one coalesced access: a warp covers 32 neighbouring words or elements,
// each thread loads kPer items before it computes (the loads are in flight
// together), and a sign word is one __ballot_sync of the warp whose 32
// lanes hold its 32 elements.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 8;                   // items per thread per chunk
constexpr int kChunk = kThreads * kPer;   // items per block per chunk
constexpr unsigned kFull = 0xffffffffu;

unsigned grid_for(long long items) {
  const long long chunks = (items + kChunk - 1) / kChunk;
  const long long cap = 4096;
  return (unsigned)(chunks < cap ? chunks : cap);
}

__global__ void __launch_bounds__(kThreads)
pack_codes_kernel(const uint32_t* __restrict__ codes,
                  uint32_t* __restrict__ words, long long n_words) {
  for (long long base = (long long)blockIdx.x * kChunk; base < n_words;
       base += (long long)gridDim.x * kChunk) {
    uint32_t lo[kPer], hi[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const long long w = base + k * kThreads + threadIdx.x;
      lo[k] = w < n_words ? codes[2 * w] : 0u;
      hi[k] = w < n_words ? codes[2 * w + 1] : 0u;
    }
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const long long w = base + k * kThreads + threadIdx.x;
      if (w < n_words) words[w] = lo[k] | (hi[k] << 16);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
unpack_codes_kernel(const uint32_t* __restrict__ words,
                    uint32_t* __restrict__ codes, long long n_words) {
  for (long long base = (long long)blockIdx.x * kChunk; base < n_words;
       base += (long long)gridDim.x * kChunk) {
    uint32_t v[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const long long w = base + k * kThreads + threadIdx.x;
      v[k] = w < n_words ? words[w] : 0u;
    }
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const long long w = base + k * kThreads + threadIdx.x;
      if (w < n_words) {
        codes[2 * w] = v[k] & 0xFFFFu;
        codes[2 * w + 1] = v[k] >> 16;
      }
    }
  }
}

// n is a multiple of 32 (whole 128-lane rows), and so is every warp's first
// element: a warp is either wholly inside the array or wholly outside it.
template <typename BitT>
__global__ void __launch_bounds__(kThreads)
pack_bitmap_kernel(const BitT* __restrict__ bits,
                   uint32_t* __restrict__ words, long long n) {
  const int lane = threadIdx.x & 31;
  for (long long base = (long long)blockIdx.x * kChunk; base < n;
       base += (long long)gridDim.x * kChunk) {
    bool b[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const long long e = base + k * kThreads + threadIdx.x;
      b[k] = e < n && bits[e] != 0;
    }
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const long long e = base + k * kThreads + threadIdx.x;
      if (e - lane >= n) break;                  // warp-uniform
      const unsigned s = __ballot_sync(kFull, b[k]);
      if (lane == 0) words[e >> 5] = s;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
unpack_bitmap_kernel(const uint32_t* __restrict__ words,
                     int32_t* __restrict__ bits, long long n) {
  for (long long base = (long long)blockIdx.x * kChunk; base < n;
       base += (long long)gridDim.x * kChunk) {
    uint32_t w[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const long long e = base + k * kThreads + threadIdx.x;
      w[k] = e < n ? words[e >> 5] : 0u;
    }
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const long long e = base + k * kThreads + threadIdx.x;
      if (e < n) bits[e] = (int32_t)((w[k] >> (e & 31)) & 1u);
    }
  }
}

}  // namespace

extern "C" {

// Each entry returns the cudaError_t of its launch (0 = launched).  All
// arrays are contiguous.

// codes (2 * n_words) int32 -> words (n_words) int32.
int pack_codes_i32(const void* codes, void* words, long long n_words,
                   void* stream) {
  if (n_words <= 0) return (int)cudaErrorInvalidValue;
  pack_codes_kernel<<<grid_for(n_words), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(codes), static_cast<uint32_t*>(words),
      n_words);
  return (int)cudaGetLastError();
}

// words (n_words) int32 -> codes (2 * n_words) int32 in [0, 65535].
int unpack_codes_i32(const void* words, void* codes, long long n_words,
                     void* stream) {
  if (n_words <= 0) return (int)cudaErrorInvalidValue;
  unpack_codes_kernel<<<grid_for(n_words), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), static_cast<uint32_t*>(codes),
      n_words);
  return (int)cudaGetLastError();
}

// bits (n) of bit_bytes 1 (bool) or 4 (int32), nonzero = set ->
// words (n / 32) int32; n a positive multiple of 32.
int pack_bitmap_i32(const void* bits, int bit_bytes, void* words,
                    long long n, void* stream) {
  if (n <= 0 || n % 32 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint32_t* out = static_cast<uint32_t*>(words);
  if (bit_bytes == 1)
    pack_bitmap_kernel<uint8_t><<<grid_for(n), kThreads, 0, s>>>(
        static_cast<const uint8_t*>(bits), out, n);
  else if (bit_bytes == 4)
    pack_bitmap_kernel<int32_t><<<grid_for(n), kThreads, 0, s>>>(
        static_cast<const int32_t*>(bits), out, n);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// words (n / 32) int32 -> bits (n) int32 in {0, 1}; n a positive multiple
// of 32.
int unpack_bitmap_i32(const void* words, void* bits, long long n,
                      void* stream) {
  if (n <= 0 || n % 32 != 0) return (int)cudaErrorInvalidValue;
  unpack_bitmap_kernel<<<grid_for(n), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), static_cast<int32_t*>(bits), n);
  return (int)cudaGetLastError();
}

const char* pack_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
