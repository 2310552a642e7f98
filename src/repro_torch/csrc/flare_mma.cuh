// TF32 tensor-core helpers shared by the FLARE forward (flare.cu) and
// backward (flare_bwd.cu): mma.sync m16n8k8 with each fp32 operand split in
// two TF32 parts, fragments loaded or staged in the order each lane takes
// them, and the MMA widths of the head dims. Header-only; each translation
// unit gets its own copy.
//
// Precision. One TF32 rounding (2^-11) of an operand misses the kernels'
// fp32 checks (1e-5 of max |out| against fp64). Each fp32 operand is split
// into hi = tf32(x) and lo = tf32(x - hi), both rounded to nearest as
// cvt.rna.tf32.f32 does (by two integer operations), and a product is three
// MMAs, lo.hi + hi.lo + hi.hi (small terms first), leaving about 2^-21. A
// bf16 operand is exact in TF32 (lo = 0), and its MMAs with lo are skipped.
// The tensor core truncates its fp32 additions, so a kernel takes each
// 8-wide step's product out of it (the MMAs start from zero) and adds it to
// fp32 sums in registers.
//
// Fragments (g = lane / 4, t = lane % 4): A (16 x 8) a0 (g, t), a1 (g + 8, t),
// a2 (g, t + 4), a3 (g + 8, t + 4); B (8 x 8) b0 (k = t, n = g), b1 (t + 4, g);
// C (16 x 8) c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1).
// A score accumulator becomes the next product's A fragment with no data
// movement: its columns (2t, 2t + 1) are taken as the k indices (t, t + 4),
// and that product's B fragment is staged with its rows in the same order.
#pragma once

#include "flare_common.cuh"

namespace flare {

constexpr int MMA_WARPS = 4;
constexpr int MMA_THREADS = MMA_WARPS * 32;

__device__ __forceinline__ float inf() { return __int_as_float(0x7f800000); }

// x rounded to TF32 (10 mantissa bits) to nearest, ties away from zero, as
// cvt.rna.tf32.f32 rounds: half of the dropped bits' unit added to the
// magnitude, then the 13 bits cleared (two integer operations;
// kernels/ref.py::tf32 rounds finite values the same way, and the CPU tests
// hold that rounding, split in two, to fp32 accuracy).
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// An A fragment (16 x 8) split: a0 (g, t), a1 (g + 8, t), a2 (g, t + 4),
// a3 (g + 8, t + 4), g = lane / 4, t = lane % 4.
struct FragA {
  uint32_t hi[4], lo[4];
};

__device__ __forceinline__ void split_a(FragA& f, float x0, float x1, float x2, float x3) {
  const float x[4] = {x0, x1, x2, x3};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f.hi[i] = tf32(x[i]);
    f.lo[i] = tf32(x[i] - __uint_as_float(f.hi[i]));
  }
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b in three TF32 products, small terms first; b is a staged B
// fragment (b0 hi, b1 hi, b0 lo, b1 lo). An operand exact in TF32 (bf16
// values) has lo = 0, and its MMA is skipped.
template <bool A_EXACT, bool B_EXACT>
__device__ __forceinline__ void mma3(float (&c)[4], const FragA& a, const uint4& b) {
  if (!A_EXACT) mma(c, a.lo, b.x, b.y);
  if (!B_EXACT) mma(c, a.hi, b.z, b.w);
  mma(c, a.hi, b.x, b.y);
}

// The A fragment of rows [r0, r0 + 16) and columns [8 kk, 8 kk + 8) of X
// (row stride rs; rows past `rows` and columns past Dr zero), split.
template <typename T>
__device__ __forceinline__ void load_a(FragA& f, const T* X, long long rs, int r0, int rows,
                                       int kk, int Dr) {
  const int lane = threadIdx.x & 31, ra = r0 + (lane >> 2), rb = ra + 8;
  const int ca = 8 * kk + (lane & 3), cb = ca + 4;
  auto at = [&](int r, int c) { return r < rows && c < Dr ? to_f(X[r * rs + c]) : 0.f; };
  split_a(f, at(ra, ca), at(rb, ca), at(ra, cb), at(rb, cb));
}

// Stage B fragments of rows [r0, r0 + 8 * steps) of a streamed X (row
// stride rs, `rows` of them from r0 valid, Dr columns), split, into
// dst[(s * KS + kk) * 32 + lane] as (b0 hi, b1 hi, b0 lo, b1 lo), by a
// block of NT threads:
//   KDIM (the head dim is the MMA's k): b0 = X[8s + g][8kk + t],
//        b1 = X[8s + g][8kk + t + 4];
//   !KDIM (the rows are the MMA's k, in the order an accumulator turned A
//        fragment takes them): b0 = X[8s + 2t][8kk + g], b1 = X[8s + 2t + 1][8kk + g].
template <typename T, int KS, bool KDIM, int NT = MMA_THREADS>
__device__ __forceinline__ void stage_b(uint4* dst, const T* X, long long rs, int r0, int rows,
                                        int steps, int Dr) {
  for (int i = threadIdx.x; i < steps * KS * 32; i += NT) {
    const int lane = i & 31, kk = (i >> 5) % KS, s = (i >> 5) / KS;
    const int g = lane >> 2, t = lane & 3;
    const int ra = KDIM ? 8 * s + g : 8 * s + 2 * t, rb = KDIM ? ra : ra + 1;
    const int ca = KDIM ? 8 * kk + t : 8 * kk + g, cb = KDIM ? ca + 4 : ca;
    const float x0 = ra < rows && ca < Dr ? to_f(X[(long long)(r0 + ra) * rs + ca]) : 0.f;
    const float x1 = rb < rows && cb < Dr ? to_f(X[(long long)(r0 + rb) * rs + cb]) : 0.f;
    const uint32_t h0 = tf32(x0), h1 = tf32(x1);
    dst[i] = make_uint4(h0, h1, tf32(x0 - __uint_as_float(h0)), tf32(x1 - __uint_as_float(h1)));
  }
}

// f(width, exact) at the MMA width of D: 8 (D = 8 exact; below 8 padded),
// 16, 32 or 64; cudaErrorInvalidValue above 64. width is a
// std::integral_constant<int, ...>; exact a std::bool_constant: the paper's
// head dim 8 runs an instance of its own whose row stride is the
// compile-time D, so its lane bounds fold away; every other D runs at its
// width with the head dim read at run time. A kernel takes the head dim in
// memory as Dr = exact ? width : its argument.
template <typename F>
cudaError_t at_mma_width(int D, F&& f) {
  using std::integral_constant;
  constexpr std::true_type exact{};
  constexpr std::false_type padded{};
  if (D == 8) return f(integral_constant<int, 8>{}, exact);
  switch (D < 1 ? 0 : D <= 8 ? 8 : padded_width(D)) {
    case 8: return f(integral_constant<int, 8>{}, padded);
    case 16: return f(integral_constant<int, 16>{}, padded);
    case 32: return f(integral_constant<int, 32>{}, padded);
    case 64: return f(integral_constant<int, 64>{}, padded);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace flare
