// Tensor-core helpers shared by the port's mma.sync kernels. TF32: the FLARE
// forward (flare.cu), backward (flare_bwd.cu), the causal kernel's fp32
// route (flare_causal.cu) and the flash kernel's fp32 route
// (flash_attention.cu): mma.sync m16n8k8 with each fp32 operand split in
// two TF32 parts, fragments loaded or staged in the order each lane takes
// them, and the MMA widths of the head dims. bf16 (at the end): ldmatrix,
// mma.sync m16n8k16 and the two-part bf16 split, for the causal kernel's
// bf16 route, MLA's paged read (paged_attention.cu) and the flash kernel's
// bf16 route off TMA. Header-only; each translation unit gets its own copy.
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

// d = a b from zero (C = 0): no accumulator to wait on; a kernel adds d to
// fp32 sums where the tensor core's truncated additions would be too many
__device__ __forceinline__ void mma_z(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                      uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f));
}

// A B fragment's two fp32 values (b0, b1) split: (b0 hi, b1 hi, b0 lo, b1 lo)
__device__ __forceinline__ uint4 split_b(float x0, float x1) {
  const uint32_t h0 = tf32(x0), h1 = tf32(x1);
  return make_uint4(h0, h1, tf32(x0 - __uint_as_float(h0)), tf32(x1 - __uint_as_float(h1)));
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

// c += a b in three TF32 products where the sum is long: the main one
// (hi.hi) from zero into the fp32 sums `s`, the small ones (2^-11 of it)
// summed in the tensor core's `c` (fp32 result: s + c)
__device__ __forceinline__ void mma3_out(float (&s)[4], float (&c)[4], const FragA& a,
                                         const uint4& b) {
  mma(c, a.lo, b.x, b.y);
  mma(c, a.hi, b.z, b.w);
  float z[4];
  mma_z(z, a.hi, b.x, b.y);
#pragma unroll
  for (int e = 0; e < 4; ++e) s[e] += z[e];
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
    dst[i] = split_b(x0, x1);
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

// ---- bf16: mma.sync m16n8k16, bf16 in, fp32 accumulate. Fragments
// (g = lane / 4, t = lane % 4): A 16 x 16 a0 (g, 2t..2t+1), a1 (g+8, ..),
// a2 (g, 2t+8..), a3 (g+8, 2t+8..); B 16 x 8 b0 (k 2t..2t+1, n g), b1
// (k 2t+8.., n g); C as the TF32 MMA's: c0, c1 (g, 2t..2t+1), c2, c3
// (g+8, 2t..2t+1). Each register holds two bf16 values, the lower k (or
// column) in the low half.

// four 8 x 8 b16 matrices; lane l gives the address of row l % 8 of matrix
// l / 8 (.trans: each matrix transposed)
__device__ __forceinline__ void ldsm(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}

// c += a b
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d = a b from zero (C = 0): no accumulator to wait on
__device__ __forceinline__ void mma_bf16z(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f));
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// (a, b) as two bf16 parts each, packed in pairs (a in the low half):
// hi = bf16(x), lo = bf16(x - hi), hi + lo within about 2^-17 |x|
// (kernels/ref.py::bf16_split rounds the same way)
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(a - hf.x, b - hf.y));
}

}  // namespace flare
