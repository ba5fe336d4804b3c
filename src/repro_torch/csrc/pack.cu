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
// out per element (unpacking the reverse).  The code kernels and the
// bitmap unpacker keep each byte to one coalesced access: a warp covers 32
// neighbouring words or elements, each thread loads kPer items before it
// computes (the loads are in flight together).
//
// The bitmap packer (pack_bitmap_kernel) works a warp "round" of 1,024
// elements, 32 output words, at a time.  Consecutive lanes read
// consecutive 16-byte chunks through the read-only path, so one warp load
// brings 512 B: 4 words' worth of int32 bits, 16 of bool.  A lane turns its
// chunk into a nibble (int32) or half a word (bool); the 8 or 2 lanes of one
// word OR their pieces with shuffles, and one more shuffle hands word L of
// the round to lane L, so the round leaves as one 128-byte store.  Every
// load of a round is issued before any is used, and the grid is sized from
// the SM count and the occupancy the build reports, each warp looping over
// rounds.  An input not on a 16-byte boundary takes the same kernel with
// the chunk read 4 bytes (int32) or a byte (bool) at a time.
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

// The bitmap packer's constants: threads a block, rounds a warp loads before
// it packs any, most blocks an SM (0: as many as the occupancy allows).
// chip_tiles.py builds copies with other values.
#ifndef PACK_TILING
#define PACK_TILING 256, 1, 0
#endif
constexpr int kBitTiling[] = {PACK_TILING};
constexpr int kBitThreads = kBitTiling[0];
constexpr int kBitRounds = kBitTiling[1];
constexpr int kBitPerSM = kBitTiling[2];
constexpr int kRound = 1024;              // elements a warp round: 32 words

// The 16-byte chunk of bits at element e, zeros past n (n and e are
// multiples of the chunk's elements, so a chunk is wholly in or out).
template <typename BitT, bool kVec>
__device__ __forceinline__ uint4 load_chunk(const BitT* __restrict__ bits,
                                            long long e, long long n) {
  if (e >= n) return make_uint4(0u, 0u, 0u, 0u);
  if constexpr (kVec) {
    return __ldg(reinterpret_cast<const uint4*>(bits + e));
  }
  uint32_t w[4] = {0u, 0u, 0u, 0u};
  if constexpr (sizeof(BitT) == 4) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      w[j] = (uint32_t)__ldg(reinterpret_cast<const int32_t*>(bits) + e + j);
  } else {
    const uint8_t* p = reinterpret_cast<const uint8_t*>(bits) + e;
#pragma unroll
    for (int j = 0; j < 16; ++j)
      w[j / 4] |= (uint32_t)__ldg(p + j) << (8 * (j % 4));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Bit i of a 4-byte word's nibble = its byte i is nonzero: the bytes' low
// bits (0, 8, 16, 24) times 1 + 2^7 + 2^14 + 2^21 land at 21 ... 24, with
// no two partial products on one bit.
__device__ __forceinline__ uint32_t byte_nibble(uint32_t x) {
  const uint32_t m = __vcmpne4(x, 0u) & 0x01010101u;
  return ((m * 0x00204081u) >> 21) & 0xFu;
}

// A chunk's set bits, element 0 lowest: 4 (int32) or 16 (bool) of them.
template <typename BitT>
__device__ __forceinline__ uint32_t chunk_bits(uint4 c) {
  if constexpr (sizeof(BitT) == 4)
    return (uint32_t)(c.x != 0u) | (uint32_t)(c.y != 0u) << 1 |
           (uint32_t)(c.z != 0u) << 2 | (uint32_t)(c.w != 0u) << 3;
  return byte_nibble(c.x) | byte_nibble(c.y) << 4 | byte_nibble(c.z) << 8 |
         byte_nibble(c.w) << 12;
}

// n is a multiple of 32: whole words.  The loop bound is warp-uniform, so
// every shuffle has all 32 lanes.
template <typename BitT, bool kVec>
__global__ void __launch_bounds__(kBitThreads)
pack_bitmap_kernel(const BitT* __restrict__ bits,
                   uint32_t* __restrict__ words, long long n) {
  constexpr int kEl = 16 / (int)sizeof(BitT);      // elements a chunk
  constexpr int kLoads = kRound / (32 * kEl);      // loads a lane a round
  constexpr int kLanesWord = 32 / kEl;             // lanes a word
  constexpr int kWordsLoad = 32 / kLanesWord;      // words a warp load
  const int lane = threadIdx.x & 31;
  const long long warp =
      ((long long)blockIdx.x * kBitThreads + threadIdx.x) >> 5;
  const long long warps = ((long long)gridDim.x * kBitThreads) >> 5;
  const long long rounds = (n + kRound - 1) / kRound;
  const long long n_words = n >> 5;
  for (long long r0 = warp * kBitRounds; r0 < rounds;
       r0 += warps * kBitRounds) {
    uint4 chunk[kBitRounds][kLoads];
#pragma unroll
    for (int r = 0; r < kBitRounds; ++r)
#pragma unroll
      for (int k = 0; k < kLoads; ++k)
        chunk[r][k] = load_chunk<BitT, kVec>(
            bits, (r0 + r) * kRound + (long long)(k * 32 + lane) * kEl, n);
#pragma unroll
    for (int r = 0; r < kBitRounds; ++r) {
      uint32_t word = 0u;
#pragma unroll
      for (int k = 0; k < kLoads; ++k) {
        uint32_t part = chunk_bits<BitT>(chunk[r][k])
                        << (kEl * (lane % kLanesWord));
#pragma unroll
        for (int o = 1; o < kLanesWord; o <<= 1)
          part |= __shfl_xor_sync(kFull, part, o);
        // load k holds words kWordsLoad*k ... of the round; word j of it
        // sits in every lane of group j; lane L keeps word L
        const uint32_t got =
            __shfl_sync(kFull, part, (lane % kWordsLoad) * kLanesWord);
        if (lane / kWordsLoad == k) word = got;
      }
      const long long w = (r0 + r) * 32 + lane;
      if (w < n_words) words[w] = word;
    }
  }
}

// Blocks for n elements: no more than the card holds at once (SMs times the
// occupancy of this instantiation, cached by device), nor than n needs.
template <typename BitT, bool kVec>
unsigned bitmap_grid(long long n) {
  constexpr int kDevices = 64;
  static int resident[kDevices] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  int cap = 1;
  if (dev >= 0 && dev < kDevices) {
    if (resident[dev] == 0) {
      int sms = 0, per_sm = 0;
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, pack_bitmap_kernel<BitT, kVec>, kBitThreads, 0);
      if (kBitPerSM > 0 && per_sm > kBitPerSM) per_sm = kBitPerSM;
      resident[dev] = (sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
    }
    cap = resident[dev];
  }
  const long long per_block = (long long)(kBitThreads / 32) * kBitRounds *
                              kRound;
  const long long need = (n + per_block - 1) / per_block;
  return (unsigned)(need < cap ? need : cap);
}

template <typename BitT, bool kVec>
void launch_pack_bitmap(const void* bits, uint32_t* words, long long n,
                        cudaStream_t s) {
  pack_bitmap_kernel<BitT, kVec><<<bitmap_grid<BitT, kVec>(n), kBitThreads,
                                   0, s>>>(static_cast<const BitT*>(bits),
                                           words, n);
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
  const bool vec = reinterpret_cast<uintptr_t>(bits) % 16 == 0;
  if (bit_bytes == 1)
    (vec ? launch_pack_bitmap<uint8_t, true>
         : launch_pack_bitmap<uint8_t, false>)(bits, out, n, s);
  else if (bit_bytes == 4)
    (vec ? launch_pack_bitmap<int32_t, true>
         : launch_pack_bitmap<int32_t, false>)(bits, out, n, s);
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
