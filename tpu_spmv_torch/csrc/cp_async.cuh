// Asynchronous copies from device to shared memory (cp.async, sm_80 and
// later), shared by the kernels that stage windows in shared memory: K3a
// and K3b (dia_stream.cu) and K8b (dist_stream.cu).

#pragma once

#include <stdint.h>

namespace {

// the most dynamic shared memory a block may ask for on sm_90
constexpr int kSmemMax = 232448;

__device__ __forceinline__ unsigned smem_address(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// an asynchronous copy of BYTES from device to shared memory: 16-byte
// copies bypass L1 (.cg); 4- and 8-byte copies must go through it (.ca)
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     smem_address(dst)),
                 "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                     smem_address(dst)),
                 "l"(src), "n"(BYTES)
                 : "memory");
}

// an L2 policy under which the lines a copy brings in are the first to be
// evicted: for data that nothing reads twice
__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t pol;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(pol));
  return pol;
}

// cp_async under the L2 policy `pol`
template <int BYTES>
__device__ __forceinline__ void cp_async_hint(void* dst, const void* src,
                                              uint64_t pol) {
  if constexpr (BYTES == 16)
    asm volatile(
        "cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2;\n" ::"r"(
            smem_address(dst)),
        "l"(src), "l"(pol)
        : "memory");
  else
    asm volatile(
        "cp.async.ca.shared.global.L2::cache_hint [%0], [%1], %2, %3;\n" ::"r"(
            smem_address(dst)),
        "l"(src), "n"(BYTES), "l"(pol)
        : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace
