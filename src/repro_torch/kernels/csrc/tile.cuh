// Shared helpers of the port's kernels: type conversion (all of them) and the
// global -> shared tile copy with 16-byte vector loads (the attention kernels).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

constexpr float NEG_INF = -1e30f;  // the mask value of the reference (kernels/ref.py)

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to(bfloat16)
}

// Copies `rows` rows of a row-major [*, D] array into shared memory as fp32,
// row stride `ld` floats.  Rows at or past `valid` are written as zeros, so the
// ragged edge needs no padded copy on the host.  `src` must be 16-byte aligned
// (the wrappers check it); D * sizeof(T) is a multiple of 16 for every D used.
template <typename T, int D, int NTHREADS>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* __restrict__ src,
                                          int rows, int valid) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int VPR = D / VEC;  // vectors per row
  for (int i = threadIdx.x; i < rows * VPR; i += NTHREADS) {
    const int r = i / VPR, c = (i % VPR) * VEC;
    float* out = dst + r * ld + c;
    if (r < valid) {
      const uint4 raw = *reinterpret_cast<const uint4*>(src + (size_t)r * D + c);
      const T* vals = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int e = 0; e < VEC; ++e) out[e] = to_float(vals[e]);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) out[e] = 0.f;
    }
  }
}

// cp.async: 16 bytes from global to shared memory without passing through
// registers (L2 only).  `bytes` 0 writes 16 zero bytes and reads nothing, so a
// ragged edge is zero-filled; `src` must still be a valid address.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(bytes)
               : "memory");
}
// The same for 4 or 8 bytes (through L1: cp.async.cg takes 16 bytes only).
template <int BYTES>
__device__ __forceinline__ void cp_async_ca(void* dst, const void* src, bool ok) {
  static_assert(BYTES == 4 || BYTES == 8, "cp.async.ca copies 4, 8 or 16 bytes");
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d), "l"(src), "n"(BYTES),
               "r"(ok ? BYTES : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Waits until at most `N` of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace repro
