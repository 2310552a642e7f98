// Flash attention for Hopper (sm_90a), CUDA C++: the fp32 route on the TF32
// tensor cores, and the bf16 calls the wgmma kernel does not take on the
// CUDA cores.
//
// Replaces the TPU kernel of the JAX package:
//   flash_tf32_kernel, flash_kernel
//       <- repro/kernels/attention.py::_flash_kernel (flash_attention_pallas)
// beside flash_attention_sm90.cu (flash_tc_kernel), which runs every bf16
// call whose D is a multiple of 8 and whose strides TMA can address.
// kernels/attention.py::flash_route picks from dtype, D and strides alone:
// fp32 runs flash_tf32_kernel; bf16 at D % 8 != 0 or unaligned strides runs
// flash_kernel (bf16 only).
//
// What both compute. For group g = (b, h) and query row i,
//   o[i, :] = sum_j softmax_j(scale * q_i . k_j) v_j
// over the keys j the masks keep: causal (j <= i, top-left aligned when
// Sq != Skv), a sliding window (j > i - window) and the key count (j < Skv,
// the TPU wrapper's kv_valid). k and v have Hkv heads, Hkv | H (GQA): query
// head h reads KV head h / (H / Hkv), so K and V go in unexpanded. The score
// is the fp32 dot product, then * scale, then -1e30 where masked; the
// weights of masked keys are zeroed explicitly (the TPU kernel's :69-72), so
// a row with no key left ends with den = 0, clamped at 1e-30 (:84): its
// output is exactly 0, the plain version's NaN -> 0. o is stored in v's
// dtype. Tiles the masks leave empty are skipped with the TPU kernel's test
// (:41-45) solved for the tile index: a causal block stops at its last live
// tile, a windowed block starts at its first.
//
// ---- flash_tf32_kernel: fp32 operands on the tensor cores ----------------
//
// What bounds it. Two products of 2 * D FLOP for each (query, key) pair the
// masks keep: at qwen2-1.5b's prefill_32k, layer 0 (H = 12 heads over 2 KV
// heads, D = 128, S = 32,768, causal), 3.30 TFLOP: 49.2 ms at the H100's
// fp32 CUDA-core rate (67 TFLOP/s), the bound of any fp32 implementation,
// against 0.23 GB of q, unexpanded k, v and o (0.07 ms at 3.35 TB/s). The
// CUDA-core kernel before this one took 133 ms (PERF.md). One TF32 rounding
// (2^-11) misses the fp32 check (1e-5 of max |o| against fp64), so each
// product is three TF32 MMAs on operands split hi + lo (flare_mma.cuh:
// lo.hi + hi.lo + hi.hi, about 2^-21 left): 9.9 TFLOP at 495 TFLOP/s, a
// floor of 20.0 ms, and one exp a kept pair (6.4e9, ~1.5 ms at the MUFU
// rate). The design feeds the tensor cores:
//   * Products. mma.sync m16n8k8 TF32, three MMAs a product. The tensor
//     core truncates its additions (flare_mma.cuh), so where a sum is long
//     or large the products are taken out into fp32 registers: S's main
//     hi.hi term each 8-wide step; its small lo.hi + hi.lo terms (2^-11 of
//     it) and a tile's P V (32 keys, folded into O once a tile) sum in the
//     tensor core. Fewer fp32 additions matter: the kernel is near its
//     issue limit, and taking every product out was slower on the H100.
//     S = Q K^T takes Q as the A operand and the split K as B; P V takes P
//     as A straight from S's accumulator (its columns (2t, 2t + 1) read as
//     k indices (t, t + 4), the staged V's rows in the same order: no
//     shuffle, no shared-memory pass), split again into hi + lo.
//   * Blocks. A block of 8 warps takes one (b, h) and BQ = 128 query rows,
//     16 a warp, so each staged K/V element serves 8 warps; one block an SM
//     (224 KB of shared memory at D 128). A warp keeps its 16 rows of q as
//     raw fp32 A fragments in shared memory (one 16-byte read a lane a
//     k-step) and splits them a tile: in registers, q and its hoisted parts
//     took 1.5 D a thread and spilled. Query
//     tiles run longest first (the causal tail): grid (B * H, Sq / 128),
//     block y takes query tile n - 1 - y. A warp all of whose rows a tile
//     masks skips its products (the diagonal's upper half, a window's lower
//     edge); only tiles a mask crosses test pairs.
//   * Staging, split once a tile. K and V tiles of BK = 32 keys come in raw
//     by cp.async; each thread splits the 16-byte chunks it copied itself
//     (no barrier between its copy and its split) into B fragments in the
//     order each lane reads them, (b0 hi, b1 hi, b0 lo, b1 lo), one 16-byte
//     read a lane an MMA triple, and at once refills its raw chunks with the
//     tile after next. So while tile i is computed, tile i + 1 waits split
//     and tile i + 2 is in flight; the split tiles are double-buffered and a
//     tile takes one barrier. Tiles of 64 keys would need 256 KB for two
//     split stages at D 128, hence 32.
//   * Softmax. Scores stay in registers, a row's max and sum over the 4
//     lanes that hold it; the TPU kernel's online softmax in fp32, in base 2
//     on scale * log2(e) scores (exp2f: one MUFU op an exp; the kernel is
//     near its issue limit), masked weights zeroed, den clamped at 1e-30.
//   * Precision: sums run in two levels. A tile's P V goes into a fresh
//     accumulator (32 columns at a time, so it takes 16 registers, not 64)
//     folded into the carried O once a tile, and each thread's den part
//     likewise: at S = 32,768 a carried sum takes 1,024 additions.
//   * wgmma in TF32 was not taken: it wants both operands K-major, so V
//     would be staged transposed, and taking its accumulator out after each
//     8-wide step, as the fp32 check needs (above), would wait on every one.
//   * D up to 128 at the widths DP in {16, 32, 64, 96, 128}, zero-filled
//     past D when staged; rows past Skv zero-filled; strides as given, 4-byte
//     copies where rows are no whole 16-byte units (D % 4, unaligned views).
//
// ---- flash_kernel: bf16 on the CUDA cores --------------------------------
//
// The bf16 calls flash_tc_kernel does not take (D % 8 != 0 or strides TMA
// cannot address), in fp32 arithmetic on the CUDA cores (its own floor at
// qwen2's layer 0 would be the 49 ms above). Each operand is staged once a
// tile in shared memory as fp32 and each value read serves 4 products:
//   * A block of 256 threads takes one group and BQ = 64 query rows, and a
//     loop inside it walks the BK = 64-key tiles in order; the running max,
//     den and acc stay in registers. Blocks are independent: grid
//     (Sq / 64, B * H).
//   * Per tile, the keys (transposed) and values are staged as fp32 in
//     shared memory, zero-filled past Skv and past D. Thread (ty, tx) of the
//     16 x 16 holds the scores of rows 4ty..4ty+3 against keys 4tx..4tx+3: one
//     broadcast float4 of q and one float4 of k per 16 FMAs. The row max is
//     reduced by shuffles across the row's 16 threads (one half warp), the
//     weights are written transposed over the keys' buffer, and each thread
//     accumulates its 4 rows times D / 16 dims of p v, one read of a value
//     serving 4 rows.
//   * Precision: two-level sums, as above (512 additions at S = 32,768).
//   * Registers: two blocks an SM (96 KB of shared memory each at DP = 128)
//     cap a thread at 128 registers; unrolled 4 and 2 the staging and value
//     loops spill nothing (ptxas -v).
//   * A deliberate difference: the TPU kernel rounds p to v's dtype before
//     the value product (:75); this kernel keeps p in fp32. Only the loads
//     of q, k, v and the store of o are bf16.
//   * D is a run-time value up to 128 at the padded widths DP in {16, 32,
//     64, 96, 128}, zero-filled past D in shared memory. q, k, v and o go
//     by strides ([B, H, S, D] views of [B, S, H, D] activations), so the
//     model's head split and merge cost no copy.
//
// The entry points launch on the given stream, allocate nothing, and
// return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flare_mma.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int BQ = 64;         // query rows a block
constexpr int BK = 64;         // keys a tile
constexpr int THREADS = 256;   // 16 x 16: a 4 x 4 tile of scores each
constexpr int LDP = BQ + 4;    // row of the transposed weights (float4-aligned, fewer conflicts)

struct Args {
  const void* q;   // [B, H, Sq, D] by strides, unit D stride (fp32 or bf16 by kernel)
  const void* k;   // [B, H, Skv, D]
  const void* v;
  void* o;         // [B, H, Sq, D], v's dtype
  int B, H, group, Sq, Skv, D;   // group = H / Hkv: query heads a KV head
  long long q_b, q_h, q_s, k_b, k_h, k_s, v_b, v_h, v_s, o_b, o_h, o_s;
  float scale;
  int causal, window;   // window < 0: no window
  int vec;              // 1: rows load as 4-element vectors (D % 4 == 0, aligned)
};

__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T narrow(float x);
template <> __device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// Elements [d0, d0 + 4) of a row p[0, D) as fp32, zero past D (d0 < D).
template <typename T>
__device__ __forceinline__ float4 row4(const T* p, int d0, int D, bool vec) {
  if (vec) return load4(p + d0);
  float x[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) x[e] = d0 + e < D ? widen(p[d0 + e]) : 0.f;
  return make_float4(x[0], x[1], x[2], x[3]);
}

// Rows [0, rows) of a strided [*, D] operand into shared memory transposed,
// dst[d * 64 + r], zero for r >= rows or d >= D. Neighbouring threads take
// neighbouring rows, so the transposed stores hit distinct banks.
template <typename T, int DP>
__device__ __forceinline__ void stage_t(float* dst, const T* src, long long stride, int rows,
                                        int D, bool vec) {
#pragma unroll 4
  for (int i = 0; i < DP / 16; ++i) {   // 64 rows x DP / 4 quads over 256 threads
    const int u = threadIdx.x + i * THREADS;
    const int r = u % 64, d0 = (u / 64) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < rows && d0 < D) x = row4(src + r * stride, d0, D, vec);
    dst[(d0 + 0) * 64 + r] = x.x;
    dst[(d0 + 1) * 64 + r] = x.y;
    dst[(d0 + 2) * 64 + r] = x.z;
    dst[(d0 + 3) * 64 + r] = x.w;
  }
}

// The same, row-major: dst[r * DP + d].
template <typename T, int DP>
__device__ __forceinline__ void stage(float* dst, const T* src, long long stride, int rows,
                                      int D, bool vec) {
  constexpr int QUADS = DP / 4;
#pragma unroll 4
  for (int i = 0; i < DP / 16; ++i) {
    const int u = threadIdx.x + i * THREADS;
    const int r = u / QUADS, d0 = (u % QUADS) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < rows && d0 < D) x = row4(src + r * stride, d0, D, vec);
    *reinterpret_cast<float4*>(dst + r * DP + d0) = x;
  }
}

// NV consecutive floats of shared memory, in the widest aligned loads.
template <int NV>
__device__ __forceinline__ void read_row(float (&x)[NV], const float* p) {
  if constexpr (NV % 4 == 0) {
#pragma unroll
    for (int i = 0; i < NV / 4; ++i) {
      const float4 t = reinterpret_cast<const float4*>(p)[i];
      x[4 * i] = t.x, x[4 * i + 1] = t.y, x[4 * i + 2] = t.z, x[4 * i + 3] = t.w;
    }
  } else if constexpr (NV % 2 == 0) {
#pragma unroll
    for (int i = 0; i < NV / 2; ++i) {
      const float2 t = reinterpret_cast<const float2*>(p)[i];
      x[2 * i] = t.x, x[2 * i + 1] = t.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < NV; ++i) x[i] = p[i];
  }
}

template <int DP>
struct Layout {   // shared memory, in floats; every offset a multiple of 4
  static constexpr int Q = 0;                                  // q [DP][BQ]
  static constexpr int KP = Q + DP * BQ;                       // k [DP][BK], then p [BK][LDP]
  static constexpr int V = KP + BK * (DP > LDP ? DP : LDP);    // v [BK][DP]
  static constexpr int BYTES = (V + BK * DP) * 4;
};

// Grid (Sq / BQ, B * H). Block = group g, query rows [q0, q0 + BQ).
template <typename T, int DP>
__global__ void __launch_bounds__(THREADS, 2) flash_kernel(Args a) {
  using L = Layout<DP>;
  constexpr int NV = DP / 16;   // output dims a thread accumulates
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float *q_s = smem + L::Q, *kp_s = smem + L::KP, *v_s = smem + L::V;

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int g = blockIdx.y, b = g / a.H, h = g % a.H;
  const int q0 = blockIdx.x * BQ;
  const T* q = static_cast<const T*>(a.q) + b * a.q_b + h * a.q_h + q0 * a.q_s;
  const T* k = static_cast<const T*>(a.k) + b * a.k_b + (h / a.group) * a.k_h;
  const T* v = static_cast<const T*>(a.v) + b * a.v_b + (h / a.group) * a.v_h;
  const bool vec = a.vec;
  stage_t<T, DP>(q_s, q, a.q_s, min(BQ, a.Sq - q0), a.D, vec);

  // the live tiles: the TPU kernel's skip test solved for the tile index
  int t_end = (a.Skv + BK - 1) / BK;
  if (a.causal) t_end = min(t_end, (q0 + BQ - 1) / BK + 1);
  int t_begin = 0;
  if (a.window >= 0) {
    const long long lo = (long long)q0 - a.window - BK + 2;   // the least live k_start
    if (lo > 0) t_begin = (int)((lo + BK - 1) / BK);
  }

  const int r0 = q0 + ty * 4;   // this thread's rows r0..r0+3
  float m[4], l[4], acc[4][NV];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int n = 0; n < NV; ++n) acc[i][n] = 0.f;
  }

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * BK, kn = min(BK, a.Skv - k0);
    __syncthreads();   // the previous tile's weights and values are read
    stage_t<T, DP>(kp_s, k + k0 * a.k_s, a.k_s, kn, a.D, vec);
    stage<T, DP>(v_s, v + k0 * a.v_s, a.v_s, kn, a.D, vec);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DP; ++d) {
      const float4 qa = *reinterpret_cast<const float4*>(q_s + d * BQ + ty * 4);
      const float4 kb = *reinterpret_cast<const float4*>(kp_s + d * BK + tx * 4);
      const float qv[4] = {qa.x, qa.y, qa.z, qa.w}, kv[4] = {kb.x, kb.y, kb.z, kb.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // scale, then mask (:58-67); the row max over the row's 16 threads; the
    // online softmax update with masked weights zeroed
    float alpha[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + i;
      bool ok[4];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = k0 + tx * 4 + j;
        ok[j] = c < a.Skv && (!a.causal || c <= r) && (a.window < 0 || c > r - a.window);
        s[i][j] = ok[j] ? s[i][j] * a.scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      alpha[i] = expf(m[i] - m_new);
      m[i] = m_new;
      float tl = 0.f;   // this tile's part of the den: a fresh partial
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        tl += s[i][j];
      }
      l[i] = fmaf(l[i], alpha[i], tl);
    }

    __syncthreads();   // every thread has read the keys: their buffer takes the weights
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(kp_s + (tx * 4 + j) * LDP + ty * 4) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

    // p v over the tile (keys past Skv have p = 0 and zero-filled v)
    float tacc[4][NV];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int n = 0; n < NV; ++n) tacc[i][n] = 0.f;
#pragma unroll 2
    for (int c = 0; c < BK; ++c) {
      const float4 pc = *reinterpret_cast<const float4*>(kp_s + c * LDP + ty * 4);
      const float pr[4] = {pc.x, pc.y, pc.z, pc.w};
      float vv[NV];
      read_row<NV>(vv, v_s + c * DP + tx * NV);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int n = 0; n < NV; ++n) tacc[i][n] = fmaf(pr[i], vv[n], tacc[i][n]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int n = 0; n < NV; ++n) acc[i][n] = fmaf(acc[i][n], alpha[i], tacc[i][n]);
  }

  // each row's den is the sum of its 16 threads' partials, clamped (:84)
  T* o = static_cast<T*>(a.o) + b * a.o_b + h * a.o_h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float den = l[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) den += __shfl_xor_sync(0xffffffffu, den, off);
    den = fmaxf(den, 1e-30f);
    const int r = r0 + i;
    if (r >= a.Sq) continue;
#pragma unroll
    for (int n = 0; n < NV; ++n) {
      const int d = tx * NV + n;
      if (d < a.D) o[r * a.o_s + d] = narrow<T>(acc[i][n] / den);
    }
  }
}

template <typename T, int DP>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  constexpr int bytes = Layout<DP>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(flash_kernel<T, DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Sq + BQ - 1) / BQ, a.B * a.H);
  flash_kernel<T, DP><<<grid, THREADS, bytes, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const Args& a, cudaStream_t stream) {
  if (a.D <= 16) return launch<T, 16>(a, stream);
  if (a.D <= 32) return launch<T, 32>(a, stream);
  if (a.D <= 64) return launch<T, 64>(a, stream);
  if (a.D <= 96) return launch<T, 96>(a, stream);
  return launch<T, 128>(a, stream);
}

// ---------------------------------------------------------------------------
// flash_tf32_kernel: fp32 on the TF32 tensor cores (the head comment).

constexpr float LOG2E = 1.4426950408889634f;
constexpr int TBQ = 128;              // query rows a block: 8 warps of 16
constexpr int TBK = 32;               // keys a tile
constexpr int T_THREADS = 256;
constexpr int T_NT = TBK / 8;         // 8-key n-tiles of S (and k-steps of P V) a tile

template <int DP>
struct TfTiling {
  static constexpr int KS = DP / 8;   // 8-wide column blocks of D
  static constexpr int CH = KS < 4 ? KS : 4;   // column blocks of a fresh P V accumulator
  // a K unit is (key, column block): 32 raw bytes, 4 split B entries; a V
  // unit (two keys 8s + 2t and + 1, column block): 64 raw bytes, 8 entries
  static constexpr int UK = TBK * KS, UV = TBK / 2 * KS;
  static constexpr int NKU = (UK + T_THREADS - 1) / T_THREADS;   // units a thread
  static constexpr int NVU = (UV + T_THREADS - 1) / T_THREADS;
  static constexpr int CHUNKS = 2 * NKU + 4 * NVU;                // its 16-byte chunks
  static constexpr int RAW = CHUNKS * T_THREADS * 16;             // the raw tile, bytes
  static constexpr int SPLIT = T_NT * KS * 32;                     // uint4 entries of K (V)
  static constexpr int Q = TBQ / 16 * KS * 32;                     // float4 fragments of q
  // the raw tile, the split K/V tiles twice, q: 224 KB at DP 128
  static constexpr int BYTES = RAW + 2 * 2 * SPLIT * 16 + Q * 16;
};

// The 16-byte chunk `c` of this thread in a raw stage (chunk-major, so a
// warp's chunks are contiguous).
__device__ __forceinline__ float4* raw_chunk(unsigned char* raw, int c) {
  return reinterpret_cast<float4*>(raw) + c * T_THREADS + threadIdx.x;
}

// Four fp32 elements of row `r` from column `c0` into a raw chunk by
// cp.async: one 16-byte copy where rows are whole 16-byte units (vec), else
// four 4-byte copies; elements past D and rows past `rows` are zero-filled
// and nothing is read for them.
__device__ __forceinline__ void copy4(float4* dst, const float* src, long long stride, int r,
                                      int rows, int c0, int D, bool vec) {
  const bool row_on = r < rows;
  if (vec) {
    const bool on = row_on && c0 < D;
    flare::cp_async16(dst, on ? src + r * stride + c0 : src, on ? 16 : 0);
    return;
  }
  float* d = reinterpret_cast<float*>(dst);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const bool on = row_on && c0 + e < D;
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(flare::smem_addr(d + e)),
                 "l"(on ? src + r * stride + c0 + e : src), "r"(on ? 4 : 0));
  }
}

// Issue the copies of this thread's chunks of the K and V tile at key k0
// (kn keys valid) into a raw stage.
template <int DP>
__device__ __forceinline__ void tf_issue(unsigned char* raw, const float* k, const float* v,
                                         long long ks, long long vs, int k0, int kn, int D,
                                         bool vec) {
  using L = TfTiling<DP>;
  const float* kt = k + k0 * ks;
  const float* vt = v + k0 * vs;
#pragma unroll
  for (int i = 0; i < L::NKU; ++i) {
    const int u = threadIdx.x + i * T_THREADS;
    if (u >= L::UK) break;
    const int key = u % TBK, c0 = u / TBK * 8;
    copy4(raw_chunk(raw, 2 * i), kt, ks, key, kn, c0, D, vec);
    copy4(raw_chunk(raw, 2 * i + 1), kt, ks, key, kn, c0 + 4, D, vec);
  }
#pragma unroll
  for (int j = 0; j < L::NVU; ++j) {
    const int u = threadIdx.x + j * T_THREADS;
    if (u >= L::UV) break;
    const int t = u % 4, c0 = (u / 4) % L::KS * 8, r = u / (4 * L::KS) * 8 + 2 * t;
    const int c = 2 * L::NKU + 4 * j;
    copy4(raw_chunk(raw, c), vt, vs, r, kn, c0, D, vec);
    copy4(raw_chunk(raw, c + 1), vt, vs, r, kn, c0 + 4, D, vec);
    copy4(raw_chunk(raw, c + 2), vt, vs, r + 1, kn, c0, D, vec);
    copy4(raw_chunk(raw, c + 3), vt, vs, r + 1, kn, c0 + 4, D, vec);
  }
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// This thread's copies of all but the newest N groups have landed (and are
// visible to it).
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// d = a b, m16n8k8 TF32 from zero (C = 0): no accumulator to wait on
__device__ __forceinline__ void mma_z(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                      uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f));
}

__device__ __forceinline__ uint4 split2(float x0, float x1) {
  const uint32_t h0 = flare::tf32(x0), h1 = flare::tf32(x1);
  return make_uint4(h0, h1, flare::tf32(x0 - __uint_as_float(h0)),
                    flare::tf32(x1 - __uint_as_float(h1)));
}

// Split this thread's chunks of a raw stage into the B fragments of the
// split tiles (flare_mma.cuh's stage_b orders): K's entry (n, kk, lane
// 4g + t) = K[8n + g][8kk + t], K[8n + g][8kk + t + 4]; V's entry (s, kk,
// 4g + t) = V[8s + 2t][8kk + g], V[8s + 2t + 1][8kk + g].
template <int DP>
__device__ __forceinline__ void tf_split(uint4* sk, uint4* sv, unsigned char* raw) {
  using L = TfTiling<DP>;
#pragma unroll
  for (int i = 0; i < L::NKU; ++i) {
    const int u = threadIdx.x + i * T_THREADS;
    if (u >= L::UK) break;
    const int key = u % TBK, kk = u / TBK, n = key / 8, g = key % 8;
    const float4 a = *raw_chunk(raw, 2 * i), b = *raw_chunk(raw, 2 * i + 1);
    const float x[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
    uint4* dst = sk + (n * L::KS + kk) * 32 + 4 * g;
#pragma unroll
    for (int j = 0; j < 4; ++j) {   // rotated by g: fewer lanes of a store on one bank
      const int t = (j + g) & 3;
      dst[t] = split2(x[t], x[t + 4]);
    }
  }
#pragma unroll
  for (int jv = 0; jv < L::NVU; ++jv) {
    const int u = threadIdx.x + jv * T_THREADS;
    if (u >= L::UV) break;
    const int t = u % 4, kk = (u / 4) % L::KS, s = u / (4 * L::KS);
    const int c = 2 * L::NKU + 4 * jv;
    const float4 a0 = *raw_chunk(raw, c), a1 = *raw_chunk(raw, c + 1);
    const float4 b0 = *raw_chunk(raw, c + 2), b1 = *raw_chunk(raw, c + 3);
    const float ra[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float rb[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
    uint4* dst = sv + (s * L::KS + kk) * 32 + t;
#pragma unroll
    for (int g = 0; g < 8; ++g) dst[4 * g] = split2(ra[g], rb[g]);
  }
}

// Grid (B * H, ceil(Sq / TBQ)). Block: group (b, h), query tile n - 1 - y;
// warp w its rows q0 + 16 w + [0, 16).
template <int DP>
__global__ void __launch_bounds__(T_THREADS, 1) flash_tf32_kernel(Args a) {
  using L = TfTiling<DP>;
  constexpr int KS = L::KS, CH = L::CH;
  extern __shared__ float4 smem4[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem4);
  unsigned char* raw = smem;
  uint4* split = reinterpret_cast<uint4*>(smem + L::RAW);   // K0, V0, K1, V1
  float4* qs = reinterpret_cast<float4*>(smem + L::RAW + 4 * L::SPLIT * 16);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int grp = blockIdx.x, b = grp / a.H, h = grp % a.H, hkv = h / a.group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * TBQ;
  const int R0 = q0 + 16 * warp;   // the warp's first row
  const float* q = static_cast<const float*>(a.q) + b * a.q_b + h * a.q_h;
  const float* k = static_cast<const float*>(a.k) + b * a.k_b + hkv * a.k_h;
  const float* v = static_cast<const float*>(a.v) + b * a.v_b + hkv * a.v_h;
  const bool vec = a.vec;
  const float scale2 = a.scale * LOG2E;   // the softmax in base 2: one MUFU op an exp

  // the live tiles: the TPU kernel's skip test for the block's rows
  int t_end = (a.Skv + TBK - 1) / TBK;
  if (a.causal) t_end = min(t_end, (q0 + TBQ - 1) / TBK + 1);
  int t_begin = 0;
  if (a.window >= 0) {
    const long long lo = (long long)q0 - a.window - TBK + 2;   // the least live k_start
    if (lo > 0) t_begin = (int)min((long long)t_end, (lo + TBK - 1) / TBK);
  }
  const int ntiles = t_end - t_begin;
  auto issue = [&](int tile) {
    tf_issue<DP>(raw, k, v, a.k_s, a.v_s, tile * TBK, min(TBK, a.Skv - tile * TBK), a.D, vec);
  };
  if (ntiles > 0) issue(t_begin);
  cp_commit();

  // the warp's rows of q as raw A fragments in shared memory, (g, 8kk + t),
  // (g + 8, ..), (g, 8kk + t + 4), (g + 8, ..) a lane, zero past Sq and D;
  // each lane reads back only what it wrote. Split once a tile: in
  // registers, q and its two parts would take 1.5 D a thread and spill.
  // The loads are unconditional (clamped in range, then selected), so all of
  // them are in flight at once rather than one round trip at a time.
  {
    const int ra = R0 + g, rb = ra + 8;
    const float* qa = q + min(ra, a.Sq - 1) * a.q_s;
    const float* qb = q + min(rb, a.Sq - 1) * a.q_s;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const int ca = 8 * kk + t, cb = ca + 4;
      const float x0 = qa[min(ca, a.D - 1)], x1 = qb[min(ca, a.D - 1)];
      const float x2 = qa[min(cb, a.D - 1)], x3 = qb[min(cb, a.D - 1)];
      qs[(warp * KS + kk) * 32 + lane] =
          make_float4(ra < a.Sq && ca < a.D ? x0 : 0.f, rb < a.Sq && ca < a.D ? x1 : 0.f,
                      ra < a.Sq && cb < a.D ? x2 : 0.f, rb < a.Sq && cb < a.D ? x3 : 0.f);
    }
  }
  const float4* qw = qs + warp * KS * 32 + lane;
  float o[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[kk][e] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;
  const int r0 = R0 + g, r1 = r0 + 8;   // this thread's rows

  if (ntiles > 0) {
    cp_wait<0>();   // this thread's chunks of the first tile
    tf_split<DP>(split, split + L::SPLIT, raw);
    if (ntiles > 1) issue(t_begin + 1);
    cp_commit();
  }
  __syncthreads();

  for (int i = 0; i < ntiles; ++i) {
    const int tile = t_begin + i, k0 = tile * TBK;
    // the next tile: its raw chunks (this thread's own) split into the other
    // buffer, then the raw tile refilled with the one after. Warps 0-3 do it
    // before their scores, warps 4-7 after their values: each scheduler
    // holds warps w and w + 4, so while one splits or runs its softmax (ALU,
    // shared memory) the other runs MMAs (faster on the H100 than all warps
    // splitting first)
    auto next = [&]() {
      if (i + 1 < ntiles) {
        cp_wait<0>();
        const int nb = (i + 1) & 1;
        tf_split<DP>(split + 2 * nb * L::SPLIT, split + (2 * nb + 1) * L::SPLIT, raw);
        if (i + 2 < ntiles) issue(tile + 2);
        cp_commit();
      }
    };
    if (warp < 4) next();
    const uint4* sk = split + 2 * (i & 1) * L::SPLIT;
    const uint4* sv = sk + L::SPLIT;

    // a warp all of whose pairs the masks drop computes nothing
    const bool dead = R0 >= a.Sq || (a.causal && k0 > R0 + 15) ||
                      (a.window >= 0 && (long long)k0 + TBK - 1 <= (long long)R0 - a.window);
    float s[T_NT][4];
    if (!dead) {
      // S = Q K^T: each 8-wide step's hi.hi product from zero into fp32 sums;
      // the small lo.hi + hi.lo terms (2^-11 of it) summed over D in the
      // tensor core, where its truncation costs ~2^-30 of a score
      float cs[T_NT][4];
#pragma unroll
      for (int n = 0; n < T_NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = cs[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const float4 x = qw[kk * 32];
        flare::FragA qf;
        flare::split_a(qf, x.x, x.y, x.z, x.w);
#pragma unroll
        for (int n = 0; n < T_NT; ++n) {
          const uint4 b = sk[(n * KS + kk) * 32 + lane];
          flare::mma(cs[n], qf.lo, b.x, b.y);
          flare::mma(cs[n], qf.hi, b.z, b.w);
          float z[4];
          mma_z(z, qf.hi, b.x, b.y);
#pragma unroll
          for (int e = 0; e < 4; ++e) s[n][e] += z[e];
        }
      }
#pragma unroll
      for (int n = 0; n < T_NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] += cs[n][e];
    }
    if (!dead) {

      // scale, mask (-1e30), the rows' max over the quad; element e of
      // n-tile n is row e < 2 ? r0 : r1, key k0 + 8n + 2t + (e & 1)
      const bool whole = k0 + TBK <= a.Skv && (!a.causal || k0 + TBK - 1 <= R0) &&
                         (a.window < 0 || (long long)k0 > (long long)R0 + 15 - a.window);
      uint32_t keep = 0xffffu;
      float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
      for (int n = 0; n < T_NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[n][e] * scale2;
          if (!whole) {
            const int key = k0 + 8 * n + 2 * t + (e & 1), row = e < 2 ? r0 : r1;
            if (!(key < a.Skv && (!a.causal || key <= row) &&
                  (a.window < 0 || key > row - a.window))) {
              x = NEG_INF;
              keep &= ~(1u << (4 * n + e));
            }
          }
          s[n][e] = x;
          if (e < 2)
            mx0 = fmaxf(mx0, x);
          else
            mx1 = fmaxf(mx1, x);
        }
      mx0 = flare::quad_max(mx0);
      mx1 = flare::quad_max(mx1);
      const float n0 = fmaxf(m0, mx0), n1 = fmaxf(m1, mx1);
      const float al0 = exp2f(m0 - n0), al1 = exp2f(m1 - n1);
      m0 = n0;
      m1 = n1;
      // the weights (masked ones exactly 0) and this tile's den parts
      float ts0 = 0.f, ts1 = 0.f;
#pragma unroll
      for (int n = 0; n < T_NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = (keep >> (4 * n + e)) & 1u ? exp2f(s[n][e] - (e < 2 ? n0 : n1)) : 0.f;
          s[n][e] = p;
          if (e < 2)
            ts0 += p;
          else
            ts1 += p;
        }
      l0 = fmaf(l0, al0, ts0);
      l1 = fmaf(l1, al1, ts1);
      // P as the A operand of key step n: S's columns (2t, 2t + 1) as k (t, t + 4)
      flare::FragA pf[T_NT];
#pragma unroll
      for (int n = 0; n < T_NT; ++n) flare::split_a(pf[n], s[n][0], s[n][2], s[n][1], s[n][3]);

      // O = O * alpha + P V, CH column blocks at a time through a fresh
      // accumulator: the tile's three products a step summed in the tensor
      // core over its 32 keys (12 additions into the tile's part alone)
#pragma unroll
      for (int c0 = 0; c0 < KS; c0 += CH) {
        float f[CH][4];
#pragma unroll
        for (int nn = 0; nn < CH; ++nn)
#pragma unroll
          for (int e = 0; e < 4; ++e) f[nn][e] = 0.f;
#pragma unroll
        for (int n = 0; n < T_NT; ++n)
#pragma unroll
          for (int nn = 0; nn < CH; ++nn)
            flare::mma3<false, false>(f[nn], pf[n], sv[(n * KS + c0 + nn) * 32 + lane]);
#pragma unroll
        for (int nn = 0; nn < CH; ++nn) {
          float* oc = o[c0 + nn];
          oc[0] = fmaf(oc[0], al0, f[nn][0]);
          oc[1] = fmaf(oc[1], al0, f[nn][1]);
          oc[2] = fmaf(oc[2], al1, f[nn][2]);
          oc[3] = fmaf(oc[3], al1, f[nn][3]);
        }
      }
    }
    if (warp >= 4) next();
    __syncthreads();   // the next split tile is whole; this one may be rewritten
  }
  cp_wait<0>();

  // each row's den is the sum of its 4 threads' parts, clamped (:84)
  const float d0 = fmaxf(flare::quad_sum(l0), 1e-30f), d1 = fmaxf(flare::quad_sum(l1), 1e-30f);
  float* og = static_cast<float*>(a.o) + b * a.o_b + h * a.o_h;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const int col = 8 * kk + 2 * t;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      if (col + c >= a.D) continue;
      if (r0 < a.Sq) og[r0 * a.o_s + col + c] = o[kk][c] / d0;
      if (r1 < a.Sq) og[r1 * a.o_s + col + c] = o[kk][2 + c] / d1;
    }
  }
}

template <int DP>
cudaError_t launch_tf32(const Args& a, cudaStream_t stream) {
  constexpr int bytes = TfTiling<DP>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(flash_tf32_kernel<DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.B * a.H, (a.Sq + TBQ - 1) / TBQ);
  flash_tf32_kernel<DP><<<grid, T_THREADS, bytes, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// bf16 q [B, H, Sq, D], k, v [B, Hkv, Skv, D] (Hkv | H) by element strides
// (b, h, s; the D stride is 1), o [B, H, Sq, D] bf16: the CUDA-core kernel.
// 1 <= D <= 128, B * H <= 65535. window < 0: no window. vec = 1 only when
// D % 4 == 0 and every stride and base pointer is a multiple of 4 elements.
int flash_attention(const void* q, const void* k, const void* v, void* o, int B, int H,
                    int Hkv, int Sq, int Skv, int D, long long q_b, long long q_h,
                    long long q_s, long long k_b, long long k_h, long long k_s,
                    long long v_b, long long v_h, long long v_s, long long o_b,
                    long long o_h, long long o_s, float scale, int causal, int window,
                    int vec, void* stream) {
  if (D < 1 || D > 128 || Sq < 1 || Skv < 1 || B * H < 1 || B * H > 65535 || Hkv < 1 ||
      H % Hkv)
    return cudaErrorInvalidValue;
  Args a{q, k, v, o, B, H, H / Hkv, Sq, Skv, D, q_b, q_h, q_s, k_b, k_h, k_s, v_b, v_h, v_s,
         o_b, o_h, o_s, scale, causal, window, vec};
  return launch_d<__nv_bfloat16>(a, (cudaStream_t)stream);
}

// fp32 q, k, v, o as above: the TF32 tensor-core kernel. B * H < 2^31,
// ceil(Sq / 128) <= 65535. vec = 1 only when D % 4 == 0 and every stride
// and base pointer is a multiple of 4 elements (16-byte copies).
int flash_attention_tf32(const void* q, const void* k, const void* v, void* o, int B, int H,
                         int Hkv, int Sq, int Skv, int D, long long q_b, long long q_h,
                         long long q_s, long long k_b, long long k_h, long long k_s,
                         long long v_b, long long v_h, long long v_s, long long o_b,
                         long long o_h, long long o_s, float scale, int causal, int window,
                         int vec, void* stream) {
  if (D < 1 || D > 128 || Sq < 1 || Skv < 1 || B < 1 || Hkv < 1 || H % Hkv ||
      (long long)B * H > 2147483647LL || (Sq + TBQ - 1) / TBQ > 65535)
    return cudaErrorInvalidValue;
  Args a{q, k, v, o, B, H, H / Hkv, Sq, Skv, D, q_b, q_h, q_s, k_b, k_h, k_s, v_b, v_h, v_s,
         o_b, o_h, o_s, scale, causal, window, vec};
  cudaStream_t s = (cudaStream_t)stream;
  if (D <= 16) return launch_tf32<16>(a, s);
  if (D <= 32) return launch_tf32<32>(a, s);
  if (D <= 64) return launch_tf32<64>(a, s);
  if (D <= 96) return launch_tf32<96>(a, s);
  return launch_tf32<128>(a, s);
}

}  // extern "C"
