// Helpers shared by the FLARE kernels (flare.cu: forward, flare_bwd.cu:
// backward): dtype conversion, strides, shared-memory staging and the tile
// constants. Header-only; each translation unit gets its own copy.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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

// Stage rows [r0, r0 + rows) of a strided [*, dr] operand into shared memory
// as fp32 rows of the padded width D, zero-filling up to `cap` rows and the
// lanes dr <= c < D, so that masked rows and padded lanes read zeros.
template <typename T, int D>
__device__ __forceinline__ void stage(float* dst, const T* src, long long row_stride,
                                      int r0, int rows, int cap, int dr = D) {
  for (int i = threadIdx.x; i < cap * D; i += blockDim.x) {
    const int r = i / D, c = i % D;
    dst[i] = (r < rows && c < dr) ? to_f(src[(long long)(r0 + r) * row_stride + c]) : 0.f;
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

// The padded head widths the FLARE kernels are built for. Any D from 1 to 64
// runs at the next of them: the lanes D <= d < width are zero where q, k, v,
// Z, y and dy are loaded or staged, so they add exactly 0 to every score and
// dot product, and nothing is written to them. Returns 0 above 64.
inline int padded_width(int D) {
  return D < 1 ? 0 : D <= 4 ? 4 : D <= 8 ? 8 : D <= 16 ? 16 : D <= 32 ? 32 : D <= 64 ? 64 : 0;
}

// f(width, exact) at D's padded width, or cudaErrorInvalidValue where D has
// none. width is a std::integral_constant<int, ...>; exact a std::bool_constant:
// the paper's head dims 4 and 8 run on instances of their own (exact = true)
// whose row stride is the compile-time D, so their lane bounds d < D fold
// away as they did before the other widths were built; every other D runs
// at its padded width with the head dim read at run time (exact = false).
// A kernel takes the head dim in memory as Dr = exact ? width : its argument.
template <typename F>
cudaError_t at_width(int D, F&& f) {
  using std::integral_constant;
  constexpr std::true_type exact{};
  constexpr std::false_type padded{};
  if (D == 4) return f(integral_constant<int, 4>{}, exact);
  if (D == 8) return f(integral_constant<int, 8>{}, exact);
  switch (padded_width(D)) {
    case 4: return f(integral_constant<int, 4>{}, padded);
    case 8: return f(integral_constant<int, 8>{}, padded);
    case 16: return f(integral_constant<int, 16>{}, padded);
    case 32: return f(integral_constant<int, 32>{}, padded);
    case 64: return f(integral_constant<int, 64>{}, padded);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace flare
