// Device helpers of the recurrence scans (wkv6_scan.cu, ssd_scan.cu):
// the chunk and block shape they share, asynchronous copies into shared
// memory, and sums over lanes.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace repro {
namespace scan {

constexpr int kChunk = 8;        // tokens a stage = the checkpoint interval
constexpr int kOwners = 64;      // rows or columns of a state a block holds
constexpr int kParts = 4;        // adjacent lanes sharing one row or column
constexpr int kThreads = kOwners * kParts;   // 256

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most kPending of this thread's copy groups are in flight
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// the sum over the four lanes of a row or column (lanes 4m .. 4m+3)
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int m = 16; m >= 1; m >>= 1) x += __shfl_xor_sync(0xffffffffu, x, m);
  return x;
}

}  // namespace scan
}  // namespace repro
