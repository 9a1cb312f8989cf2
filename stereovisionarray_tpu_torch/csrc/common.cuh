// Shared declarations of the port's CUDA kernels. Every entry point has a
// plain C interface (loaded with ctypes by _native.py), launches on the
// stream it is given, allocates nothing, and returns cudaGetLastError().
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#define SVT_API extern "C" __attribute__((visibility("default")))

namespace svt {

// int16 border sentinel of the reference's integer SGM and extraction
// (sgm_pallas.py / extract_pallas.py _BIG_INT): survives +P1/+P2.
constexpr int kBigInt = 16000;
// out-of-image marker of the float maps (extract_pallas.py _BIG)
constexpr float kBigFloat = 1e9f;

// Asynchronous copies from global to shared memory (cp.async): BYTES of 4, 8
// or 16, each aligned to its size; 16-byte copies go through L2 only.
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(smem_addr(dst)), "l"(src),
                 "n"(BYTES)
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// waits until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace svt
