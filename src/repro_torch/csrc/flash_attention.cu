// Flash attention for Hopper (sm_90a) on the CUDA cores, CUDA C++: the fp32
// route, and the bf16 calls the tensor-core kernel does not take.
//
// Replaces the TPU kernel of the JAX package:
//   flash_kernel <- repro/kernels/attention.py::_flash_kernel (flash_attention_pallas)
// beside flash_attention_sm90.cu (flash_tc_kernel), which runs every bf16
// call whose D is a multiple of 8 and whose strides TMA can address
// (kernels/attention.py::flash_route). This kernel takes the rest: fp32
// (whose fp64 check, 1e-5 of max |o|, TF32 would fail) and bf16 at D % 8 != 0
// or unaligned strides.
//
// What it computes. For group g = (b, h) and query row i,
//   o[i, :] = sum_j softmax_j(scale * q_i . k_j) v_j
// over the keys j the masks keep: causal (j <= i, top-left aligned when
// Sq != Skv), a sliding window (j > i - window) and the key count (j < Skv,
// the TPU wrapper's kv_valid). k and v have Hkv heads, Hkv | H (GQA): query
// head h reads KV head h / (H / Hkv), so K and V go in unexpanded. The score
// is the fp32 dot product (bf16 operands are widened on load), then * scale,
// then -1e30 where masked; the weights of masked keys are zeroed explicitly
// (the TPU kernel's :69-72), so a row with no key left ends with den = 0,
// clamped at 1e-30 (:84): its output is exactly 0, the plain version's NaN
// -> 0. o is stored in v's dtype.
//
// What bounds it. Two products of 2 * D FLOP for each (query, key) pair the
// masks keep. At qwen2-1.5b's prefill_32k, layer 0 (H = 12 heads, D = 128,
// S = 32,768, causal), that is 4 * H * D * S^2 / 2 = 3.30 TFLOP: 49 ms at the
// H100's fp32 CUDA-core rate (67 TFLOP/s), against 0.23 GB of q, unexpanded
// k, v and o, 0.07 ms at 3.35 TB/s. It is bound by arithmetic, and on the
// CUDA cores in fp32 its own floor is the 49 ms. The design keeps the CUDA
// cores fed: every operand is staged once a tile in shared memory and each
// value read from it serves 4 products.
//
// What does not carry over from the TPU, and the design:
//   * The TPU grid (G, Sq / 256, Skv / 512) walks the KV blocks of a query
//     block in order, carrying (max, den, acc) in VMEM scratch from one grid
//     step to the next. Here a block of 256 threads takes one group and
//     BQ = 64 query rows, and a loop inside it walks the BK = 64-key tiles in
//     order; the running max, den and acc stay in registers. Blocks are
//     independent: grid (Sq / 64, B * H).
//   * The tile skip is the TPU kernel's test (:41-45), k_start <= q_start +
//     BQ - 1 (causal) and k_start + BK - 1 > q_start - window, solved for the
//     tile index: a causal block stops at its last live tile, a windowed
//     block starts at its first. Only the diagonal tiles compute masked
//     pairs.
//   * Per tile, the keys (transposed) and values are staged as fp32 in
//     shared memory, zero-filled past Skv and past D. Thread (ty, tx) of the
//     16 x 16 holds the scores of rows 4ty..4ty+3 against keys 4tx..4tx+3: one
//     broadcast float4 of q and one float4 of k per 16 FMAs. The row max is
//     reduced by shuffles across the row's 16 threads (one half warp), the
//     weights are written transposed over the keys' buffer, and each thread
//     accumulates its 4 rows times D / 16 dims of p v, one read of a value
//     serving 4 rows.
//   * Precision: sums run in two levels. A tile's p v and its weights' sum go
//     into fresh fp32 partials and are folded into the carried accumulator
//     and den once a tile: at S = 32,768 a carried sum takes 512 additions,
//     not 32,768 (one running fp32 sum over 40,000 tokens was 7.8e-4 of
//     max |Z| off fp64 in flare.cu's encode; two levels 7.2e-6).
//   * Registers: two blocks an SM (96 KB of shared memory each at DP = 128)
//     cap a thread at 128 registers, and at DP = 128 it holds 64 fp32
//     accumulators. Fully unrolled, the staging loops and the value loop
//     spilled 120-416 B a thread at DP = 96 / 128 (ptxas -v); unrolled 4 and
//     2 they spill nothing, and the kernel is faster (PERF.md).
//   * bf16 (a deliberate difference): the TPU kernel rounds p to v's dtype
//     before the value product (:75); this kernel keeps p in fp32. Only the
//     loads of q, k, v and the store of o are bf16.
//   * GQA: a block reads its KV head's rows; the query heads of one KV head
//     read the same K and V (from L2), never an expanded copy.
//   * No padding in device memory. D is a run-time value up to 128: the
//     kernel is built for padded widths DP in {16, 32, 64, 96, 128} and
//     zero-fills d >= D in shared memory, so phi3's D = 96 runs at DP = 96.
//     Ragged Sq and Skv are loop bounds and masks. q, k, v and o go by
//     strides ([B, H, S, D] views of [B, S, H, D] activations), so the
//     model's head split and merge cost no copy.
//
// The entry point launches on the given stream, allocates nothing, and
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int BQ = 64;         // query rows a block
constexpr int BK = 64;         // keys a tile
constexpr int THREADS = 256;   // 16 x 16: a 4 x 4 tile of scores each
constexpr int LDP = BQ + 4;    // row of the transposed weights (float4-aligned, fewer conflicts)

// dtype codes shared with the Python wrapper
enum { F32 = 0, BF16 = 1 };

struct Args {
  const void* q;   // [B, H, Sq, D] by strides, unit D stride
  const void* k;   // [B, H, Skv, D]
  const void* v;
  void* o;         // [B, H, Sq, D], v's dtype
  int B, H, group, Sq, Skv, D;   // group = H / Hkv: query heads a KV head
  long long q_b, q_h, q_s, k_b, k_h, k_s, v_b, v_h, v_s, o_b, o_h, o_s;
  float scale;
  int causal, window;   // window < 0: no window
  int vec;              // 1: rows load as 4-element vectors (D % 4 == 0, aligned)
};

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T narrow(float x);
template <> __device__ __forceinline__ float narrow<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
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

}  // namespace

extern "C" {

// q [B, H, Sq, D], k, v [B, Hkv, Skv, D] (Hkv | H) of one dtype (fp32 /
// bf16) by element strides (b, h, s; the D stride is 1), o [B, H, Sq, D] in
// that dtype. 1 <= D <= 128, B * H <= 65535. window < 0: no window. vec = 1
// only when D % 4 == 0 and every stride and base pointer is a multiple of 4
// elements (16 / 8 bytes).
int flash_attention(const void* q, const void* k, const void* v, void* o, int B, int H,
                    int Hkv, int Sq, int Skv, int D, long long q_b, long long q_h,
                    long long q_s, long long k_b, long long k_h, long long k_s,
                    long long v_b, long long v_h, long long v_s, long long o_b,
                    long long o_h, long long o_s, float scale, int causal, int window,
                    int vec, int dtype, void* stream) {
  if (D < 1 || D > 128 || Sq < 1 || Skv < 1 || B * H < 1 || B * H > 65535 || Hkv < 1 ||
      H % Hkv)
    return cudaErrorInvalidValue;
  Args a{q, k, v, o, B, H, H / Hkv, Sq, Skv, D, q_b, q_h, q_s, k_b, k_h, k_s, v_b, v_h, v_s,
         o_b, o_h, o_s, scale, causal, window, vec};
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case F32: return launch_d<float>(a, s);
    case BF16: return launch_d<__nv_bfloat16>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"
