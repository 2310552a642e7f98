// Helpers shared by the FLARE kernels (flare.cu: forward, flare_bwd.cu:
// backward, flare_causal.cu: causal): dtype conversion, strides and the
// padded head widths. Header-only; each translation unit gets its own copy.
// The tensor-core helpers of the first two are in flare_mma.cuh.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace flare {

constexpr float NEG_INF = -1e30f;

// dtype codes shared with the Python wrappers
enum { F32 = 0, BF16 = 1 };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct Strides {  // element strides of a [B, H, N, D] operand; the D stride is 1
  long long b, h, n;
};

// max and sum over the four lanes of a quad (the lanes holding one row of
// an MMA accumulator)
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes from device memory to shared memory without the registers; the
// first `bytes` of them copied, the rest zero (cp.async)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes = 16) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(smem_addr(dst)), "l"(src),
               "r"(bytes));
}

inline int cdiv(long long a, long long b) { return (int)((a + b - 1) / b); }

// The padded head widths the FLARE kernels are built for. Any D from 1 to 64
// runs at the next of them (the tensor-core kernels at 8 at least,
// flare_mma.cuh::at_mma_width): the lanes D <= d < width are zero where q,
// k, v, Z, y and dy are loaded or staged, so they add exactly 0 to every
// score and dot product, and nothing is written to them. Returns 0 above 64.
inline int padded_width(int D) {
  return D < 1 ? 0 : D <= 4 ? 4 : D <= 8 ? 8 : D <= 16 ? 16 : D <= 32 ? 32 : D <= 64 ? 64 : 0;
}

}  // namespace flare
