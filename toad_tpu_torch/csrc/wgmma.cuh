// Hopper's warpgroup products (wgmma) as the pooling kernels issue them:
// the fence, commit and wait around an asynchronous product, the proxy fence
// that lets the tensor cores read what threads wrote to shared memory, and
// the descriptors of K-major operands in the 64-byte and 128-byte swizzles.
// Shared by csrc/pool.cu (K1's bf16 and f32 instances) and csrc/pool_int8.cu
// (K2). Everything sits in an anonymous namespace, as in pool_common.cuh.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// a swizzled operand's region starts on a 1024-byte boundary: the swizzles are functions of the address
__host__ __device__ inline size_t align1024(size_t v) { return (v + 1023) & ~size_t(1023); }

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() { asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory"); }
// this thread's shared-memory writes (its landed cp.async copies too), seen by the tensor cores' reads
__device__ __forceinline__ void fence_async_smem() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }
// the 128 threads of warpgroup wg (barrier 0 is __syncthreads)
__device__ __forceinline__ void bar_wg(int wg) { asm volatile("bar.sync %0, 128;\n" ::"r"(wg + 1) : "memory"); }

// threadIdx.x, opaque to the compiler: the epilogues compute their
// addresses where they run, instead of keeping them in registers through the
// products (which need all but a few of the 255)
__device__ __forceinline__ int fresh_tid() {
  int t = threadIdx.x;
  asm volatile("" : "+r"(t));
  return t;
}

// The descriptor of a K-major operand of 64-byte rows (16 tf32, 32 bf16 or
// 64 int8 values) in the 64-byte swizzle: row n at byte 64n, its 16-byte
// chunk c at (c ^ bits 1-2 of n) * 16, 8-row groups 512 bytes apart (the
// leading offset is unused). A wgmma's K step of 32 bytes (k8 tf32, k16
// bf16, k32 int8) kk starts 32 kk bytes in; the swizzle is applied to the
// address, so the same descriptor plus 2 reads it. Its high word is the same
// for every operand, its low word the start address (and the unused leading
// offset): offsets within shared memory never carry past it.
constexpr uint32_t kDescHi = (512 >> 4) | (2u << 30);
__device__ __forceinline__ uint32_t sw64_desc_lo(const void* p) {
  return ((static_cast<uint32_t>(__cvta_generic_to_shared(p)) & 0x3FFFF) >> 4) | (1u << 16);
}
constexpr uint32_t kHalfDesc = 32 / 16;  // a descriptor's step to a slice's second 32 bytes
// The high word of an operand of 128-byte rows in the 128-byte swizzle (row
// n at byte 128n, its chunk c at (c ^ n mod 8) * 16, 8-row groups 1024 bytes
// apart): its low word is sw64_desc_lo's, and the K steps of 32 bytes within
// a row add 2 each, as above.
constexpr uint32_t kDescHi128 = (1024 >> 4) | (1u << 30);

__device__ __forceinline__ uint64_t wgmma_desc(uint32_t lo, uint32_t hi) { return (uint64_t)hi << 32 | lo; }

}  // namespace
