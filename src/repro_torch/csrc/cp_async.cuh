// cp.async copies from global to shared memory and the stage rotation of a
// ring of them, shared by the kernels that stream their operands through
// shared memory (gate_apply.cu: the ring bodies of B1/B6 and B7;
// attention.cu: B10's K/V tiles and B11's ring of cache tiles).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes from global to shared; only the first `bytes` are read, the
// rest zero-filled (0 zero-fills all 16)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n"
               :: "r"(smem_u32(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(smem_u32(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// The ring's stage rotation over a block's units 0 .. mine - 1: copy(i)
// issues unit i's cp.async copies into stage i % S (it commits nothing),
// compute(i, v) reads them.  One block barrier a unit, sync(i), both
// publishes the arrived unit and frees the stage that the next copy
// reuses, so unit i + S - 1 is in flight during unit i's compute; sync may
// also reduce a value over the block (__syncthreads_and), which compute
// gets as v.  Every thread commits one group a unit (empty past the last),
// so that every wait counts the same groups.
template <int S, typename Copy, typename Sync, typename Compute>
__device__ __forceinline__ void ring_walk(int mine, Copy&& copy, Sync&& sync,
                                          Compute&& compute) {
#pragma unroll
  for (int i = 0; i < S - 1; ++i) {
    if (i < mine) copy(i);
    cp_async_commit();
  }
  for (int i = 0; i < mine; ++i) {
    cp_async_wait<S - 2>();  // this thread's copies of unit i have landed
    const int v = sync(i);   // everyone's have; stage (i - 1) % S is free
    if (i + S - 1 < mine) copy(i + S - 1);
    cp_async_commit();
    compute(i, v);
  }
}

// ring_walk with a plain block barrier; compute(i) reads unit i
template <int S, typename Copy, typename Compute>
__device__ __forceinline__ void ring_walk(int mine, Copy&& copy,
                                          Compute&& compute) {
  ring_walk<S>(
      mine, copy, [](int) { __syncthreads(); return 0; },
      [&](int i, int) { compute(i); });
}

}  // namespace
