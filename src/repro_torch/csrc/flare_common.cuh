// Helpers shared by the FLARE kernels (flare.cu: forward, flare_bwd.cu:
// backward): dtype conversion, strides, shared-memory staging and the tile
// constants. Header-only; each translation unit gets its own copy.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flare {

constexpr float NEG_INF = -1e30f;
constexpr int TILE_FLOATS = 2048; // floats per shared tile buffer (8 KB)
constexpr int ENC_THREADS = 128;  // per-latent kernels: latent rows per block
constexpr int DEC_THREADS = 256;  // per-token kernels: tokens per block

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

// Stage rows [r0, r0 + rows) of a strided [*, D] operand into shared memory
// as fp32, zero-filling up to `cap` rows so that masked lanes read zeros.
template <typename T, int D>
__device__ __forceinline__ void stage(float* dst, const T* src, long long row_stride,
                                      int r0, int rows, int cap) {
  for (int i = threadIdx.x; i < cap * D; i += blockDim.x) {
    const int r = i / D, c = i % D;
    dst[i] = r < rows ? to_f(src[(long long)(r0 + r) * row_stride + c]) : 0.f;
  }
}

template <int D>
__device__ __forceinline__ float dot(const float (&x)[D], const float* y) {
  float a = 0.f;
#pragma unroll
  for (int d = 0; d < D; ++d) a = fmaf(x[d], y[d], a);
  return a;
}

inline int cdiv(long long a, long long b) { return (int)((a + b - 1) / b); }

}  // namespace flare
