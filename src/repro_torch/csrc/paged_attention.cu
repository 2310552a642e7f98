// Paged attention for Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernel of the JAX package:
//   paged_kernel + paged_combine_kernel
//       <- repro/kernels/paged_attention.py::_paged_kernel (paged_attention_pallas)
//
// What it computes. For lane b, KV head h and query row g,
//   o[b, h, g, :] = sum_t softmax_t(scale * s[g, t]) v[t, :]
// over the tokens t < lengths[b] of the lane's pages page_table[b, :], read
// from block storage k/v [NB, block, H, D]. The score is s = q . k in fp32,
// times k_scale[t] when given, plus (q2 . k2) * k2_scale[t] when q2 is given
// (MLA's absorbed decode), then times scale, then masked (-1e30). The fp32
// softmax weights are multiplied by v_scale[t] when given (after the
// denominator takes them), and on the plain path (no scales, no q2, q of the
// pages' dtype) rounded to the pages' dtype before the value product, as the
// TPU kernel does. A lane of length 0 returns exact zeros. Two consumers:
// the gqa decode read of the serving pool (G = query heads per KV head, q
// fp32 over bf16 / int8 / fp8 pages) and FLARE's encode off pages (G = M
// latents, the `paged` backend).
//
// What bounds it. Bytes: each valid token's K and V rows (and scales) once,
// plus q and o. At qwen2-1.5b's decode (8 slots, 2 KV heads, D = 128, bf16
// pages, ~2,000 tokens a lane) that is ~16 MB a layer, 4.9 us at 3.35 TB/s,
// against 2 * G * D FLOP a token row (12 FLOP a byte at G = 6). The FLARE
// encode at G = 2,048 and D = 8 is bound by fp32 operations instead.
//
// What does not carry over from the TPU, and the design:
//   * The TPU grid (B, H, P) walks the pages of a lane in order, carrying
//     the softmax (max, den, acc) in VMEM. At 8 slots that is B*H = 16
//     programs: 16 blocks would leave 116 of 132 SMs idle. Here a block
//     takes (one lane and head, a tile of GT = 1024 / DP query rows, a slice
//     of the lane's pages) and walks its pages with a running fp32 (max, den,
//     acc); a second kernel merges the slices in a fixed order (no atomics,
//     deterministic), the shape of flare.cu's encode + combine N-split. The
//     host picks the slice count from the shapes alone (B, H, G, D, P), never
//     from lengths: nothing is read back to the host, so a decode step keeps
//     its one device-to-host copy. With one slice the block writes o itself.
//   * The page table and lengths are read by each block from device memory
//     (the TPU kernel has them in scalar-prefetch memory). Pages at or past
//     ceil(lengths[b] / block) are skipped, and rows past lengths[b] inside
//     the last page are never loaded (zero-filled): masked rows had weight 0
//     anyway, so skipping changes no bit, and garbage in them (even NaN) is
//     invisible.
//   * Each page's K and V rows of one head are strided by H*D elements; a
//     row (256 B at D = 128 in bf16) is loaded as 16-byte vectors (8-byte
//     where D * sizeof(T) % 16 != 0, single elements where it is not a
//     multiple of 8 either) and widened to fp32 in registers on the way to
//     shared memory. Scales multiply the scores and weights,
//     never the payload, so int8 / fp8 pages are never written out wide.
//   * A block stages a tile of 64 tokens (4 pages of 16) at a time: the
//     pages' loads are all in flight together, and the tile pays 4
//     barriers. Shared memory bandwidth, not the card's, bounds the compute
//     phases, so each reads a value once for several products: the scores
//     take a pair of threads per token, and each float4 of the token's K
//     row serves 8 query rows (the q reads are warp-wide broadcasts); the
//     online softmax takes 128 / GT lanes a row, reduced by warp shuffles;
//     the value product keeps 8 accumulators a thread (GT * DP = 1024 = 128
//     threads x 8, all of one dim), so one v value serves 8 rows, with the
//     weights read as float4s of 4 tokens. Rows are padded to DP + 8 floats
//     (16-byte aligned; a quarter warp's float4 reads hit distinct banks).
//     Blocks hold a multiple of 4 tokens a page. A first version walked one
//     page at a time, a (row, token) dot product a thread and one thread a
//     row for the softmax, and took about twice as long (PERF.md).
//   * Head dims. The shared-memory tiles run at a padded width DP, the next
//     power of two from 8 to 128 at or above D (phi3's 96 at 128), so that
//     GT = 1024 / DP is a whole multiple of RC and THREADS a multiple of DP.
//     Lanes D <= d < DP of q, K and V are zero-filled where they are staged,
//     so they add exactly 0 to every score, and nothing is written to them.
//     Pages, q and o keep their real D in device memory. D == DP runs an
//     instance of its own without the lane guards: with them qwen2's read
//     at D=128 took 0.0448 ms against 0.0426 (PERF.md).
//
// The entry points launch on the given stream, allocate nothing (the caller
// gives the fp32 partials) and return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int THREADS = 128;
constexpr int ROW_ELEMS = 1024;   // GT * DP: query rows a block takes, times D's padded width
constexpr int ACC = ROW_ELEMS / THREADS;
constexpr int TILE_TOKENS = 64;          // tokens a block stages at a time (whole pages)
constexpr int RC = 8;                    // q rows a thread scores against a token at a time
constexpr int TARGET_BLOCKS = 4 * 132;   // about four blocks a streaming multiprocessor
constexpr int MIN_PAGES = 4;             // pages a slice walks at least

// dtype codes shared with the Python wrapper
enum { F32 = 0, BF16 = 1, I8 = 2, FP8 = 3 };

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float widen(int8_t x) { return (float)x; }
__device__ __forceinline__ float widen(__nv_fp8_e4m3 x) { return static_cast<float>(x); }

struct Args {
  const void* q;          // [B, H, G, D] fp32 or bf16
  const void* q2;         // [B, H, G, D2] or null
  const void* k;          // [NB, block, H, D] pages
  const void* v;
  const void* k2;         // [NB, block, H, D2] or null
  const int* pt;          // [B, P]
  const int* lengths;     // [B]
  const float* ks;        // [NB, block, H] or null
  const float* vs;
  const float* k2s;
  void* out;              // [B, H, G, D] fp32 or bf16
  float* part_acc;        // [splits, B*H, G, D]
  float* part_ml;         // [splits, B*H, G, 2]: (max, den)
  int B, H, G, D, DP, D2, block, P, splits, pages_per_split;   // DP: D's padded width
  float scale;
  int q_dtype, out_dtype, fused;
};

__device__ __forceinline__ float load_q(const void* q, int dtype, long long i) {
  return dtype == F32 ? static_cast<const float*>(q)[i]
                      : __bfloat162float(static_cast<const __nv_bfloat16*>(q)[i]);
}

// Rows [0, rows) of one head of page `pg` (D elements a row in memory) into
// shared memory as fp32 rows of DP lanes at row stride `stride`; rows
// [rows, blk) and, where PAD, lanes [D, DP) are zero-filled. VB bytes a
// vector (D * sizeof(T) a multiple of VB).
template <typename T, int VB, bool PAD>
__device__ __forceinline__ void load_page(float* dst, int stride, const T* src, int pg, int h,
                                          int H, int D, int DP, int blk, int rows) {
  constexpr int EPV = VB / sizeof(T);
  const int vpr = DP / EPV;   // vectors a padded row
  for (int i = threadIdx.x; i < blk * vpr; i += THREADS) {
    const int t = i / vpr, c = i % vpr;
    float* d = dst + t * stride + c * EPV;
    if (t < rows && (!PAD || c * EPV < D)) {
      const T* s = src + (((long long)pg * blk + t) * H + h) * D + c * EPV;
      T e[EPV];
      if constexpr (VB == 16) {
        const uint4 raw = *reinterpret_cast<const uint4*>(s);
        memcpy(e, &raw, VB);
      } else if constexpr (VB == 8) {
        const uint2 raw = *reinterpret_cast<const uint2*>(s);
        memcpy(e, &raw, VB);
      } else {
        e[0] = s[0];
      }
#pragma unroll
      for (int j = 0; j < EPV; ++j) d[j] = widen(e[j]);
    } else {
#pragma unroll
      for (int j = 0; j < EPV; ++j) d[j] = 0.f;
    }
  }
}

// An exact row (PAD false: D == DP, a power of two from 8) is a multiple of
// 8 bytes; a padded one may need single-element loads.
template <typename T, bool PAD>
__device__ __forceinline__ void load_rows(float* dst, int stride, const T* src, int pg, int h,
                                          int H, int D, int DP, int blk, int rows) {
  const int bytes = D * (int)sizeof(T);
  if (bytes % 16 == 0)
    load_page<T, 16, PAD>(dst, stride, src, pg, h, H, D, DP, blk, rows);
  else if (!PAD || bytes % 8 == 0)
    load_page<T, 8, PAD>(dst, stride, src, pg, h, H, D, DP, blk, rows);
  else
    load_page<T, sizeof(T), PAD>(dst, stride, src, pg, h, H, D, DP, blk, rows);
}

__device__ __forceinline__ void load_scales(float* dst, const float* src, int pg, int h, int H,
                                            int blk, int rows) {
  for (int t = threadIdx.x; t < blk; t += THREADS)
    dst[t] = t < rows ? src[((long long)pg * blk + t) * H + h] : 0.f;
}

// Pages a tile takes: TILE_TOKENS tokens, or one page where a page is longer.
__host__ __device__ __forceinline__ int pages_per_tile(int block) {
  return block < TILE_TOKENS ? TILE_TOKENS / block : 1;
}

// s[r] += q[r] . k over the float4 chunks c = half, half + 2, ... of n
// (n a multiple of 8), for RC rows of q at stride qs: each chunk of k is read
// once for the RC rows.
__device__ __forceinline__ void rows_dot(float (&s)[RC], const float* q, int qs, const float* k,
                                         int n, int half) {
  for (int c = 4 * half; c < n; c += 8) {
    const float4 kk = *reinterpret_cast<const float4*>(k + c);
#pragma unroll
    for (int r = 0; r < RC; ++r) {
      const float4 qq = *reinterpret_cast<const float4*>(q + r * qs + c);
      s[r] = fmaf(qq.x, kk.x, fmaf(qq.y, kk.y, fmaf(qq.z, kk.z, fmaf(qq.w, kk.w, s[r]))));
    }
  }
}

__device__ __forceinline__ void store_out(void* out, int dtype, long long i, float x) {
  if (dtype == F32)
    static_cast<float*>(out)[i] = x;
  else
    static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16(x);
}

// Grid (splits, B*H, G tiles). Block = lane b, head h, rows [g0, g0 + GT),
// pages [split * pages_per_split, +pages_per_split) of the lane's valid ones,
// walked a tile of `ppt` pages (TT = ppt * block tokens) at a time. PAD:
// D < DP (lanes to zero-fill); the exact instance (D == DP) has no lane
// guards.
template <typename T, bool PAD>
__global__ void __launch_bounds__(THREADS) paged_kernel(Args a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int D = a.D, DP = PAD ? a.DP : a.D, D2 = a.D2, blk = a.block;
  const int GT = ROW_ELEMS / DP, ppt = pages_per_tile(blk), TT = ppt * blk;
  const int split = blockIdx.x, bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int g0 = blockIdx.z * GT, gn = min(GT, a.G - g0);
  const int tid = threadIdx.x;
  // rows of DP + 8 floats: 16-byte aligned, and a quarter warp's float4 reads
  // of 4 tokens x 2 halves land in 8 distinct bank quads
  const int KS = DP + 8, K2S = D2 ? D2 + 8 : 0, PS = TT + 4;
  float* q_s = smem;                       // [GT][KS]
  float* q2_s = q_s + GT * KS;             // [GT][K2S]
  float* k_s = q2_s + GT * K2S;            // [TT][KS]
  float* k2_s = k_s + TT * KS;             // [TT][K2S]
  float* v_s = k2_s + TT * K2S;            // [TT][DP]
  float* p_s = v_s + TT * DP;              // [GT][PS]: scores, then weights
  float* ks_s = p_s + GT * PS;             // [TT] each
  float* vs_s = ks_s + TT;
  float* k2s_s = vs_s + TT;
  float* alpha_s = k2s_s + TT;             // [GT]

  const long long qrow = ((long long)b * a.H + h) * a.G + g0;
  for (int i = tid; i < gn * DP; i += THREADS) {
    const int r = i / DP, c = i % DP;
    q_s[r * KS + c] = !PAD || c < D ? load_q(a.q, a.q_dtype, (qrow + r) * D + c) : 0.f;
  }
  for (int i = tid; i < gn * D2; i += THREADS)
    q2_s[(i / D2) * K2S + i % D2] = load_q(a.q2, a.q_dtype, qrow * D2 + i);

  const int len = a.lengths[b];
  const int valid_pages = min(a.P, (len + blk - 1) / blk);
  const int p0 = split * a.pages_per_split;
  const int p1 = min(valid_pages, p0 + a.pages_per_split);
  const bool round_p = !a.fused && sizeof(T) == 2;
  // the scores: two threads a token (`half` takes every other float4 of D)
  const int half = tid & 1, tok = tid >> 1;
  // the softmax: R threads a row (a power of two up to 16, lanes of one warp)
  const int R = THREADS / GT, srow = tid / R, slane = tid % R;
  float m = NEG_INF, l = 0.f;              // row srow's state, the same in its R lanes
  // accumulators: element tid + THREADS * i is (row er + i * estep, dim ed);
  // THREADS is a multiple of DP, so every one of a thread's elements has dim ed
  const int ed = tid % DP, er = tid / DP, estep = THREADS / DP;
  float acc[ACC];
#pragma unroll
  for (int i = 0; i < ACC; ++i) acc[i] = 0.f;

  for (int p = p0; p < p1; p += ppt) {
    const int np = min(ppt, p1 - p);
    const int tt = np * blk;                       // tokens of this tile, masked ones included
    const int valid = min(tt, len - p * blk);      // tokens [0, valid) of the tile are real
    __syncthreads();   // the previous tile's reads are done
    for (int j = 0; j < np; ++j) {
      const int pg = a.pt[(long long)b * a.P + p + j];
      const int rows = max(0, min(blk, valid - j * blk));
      load_rows<T, PAD>(k_s + j * blk * KS, KS, static_cast<const T*>(a.k), pg, h, a.H, D, DP,
                        blk, rows);
      load_rows<T, PAD>(v_s + j * blk * DP, DP, static_cast<const T*>(a.v), pg, h, a.H, D, DP,
                        blk, rows);
      if (D2)   // a multiple of 8: exact
        load_rows<T, false>(k2_s + j * blk * K2S, K2S, static_cast<const T*>(a.k2), pg, h, a.H,
                            D2, D2, blk, rows);
      if (a.ks) load_scales(ks_s + j * blk, a.ks, pg, h, a.H, blk, rows);
      if (a.vs) load_scales(vs_s + j * blk, a.vs, pg, h, a.H, blk, rows);
      if (a.k2s) load_scales(k2s_s + j * blk, a.k2s, pg, h, a.H, blk, rows);
    }
    __syncthreads();

    // scores: a thread pair per token, RC rows at a time; each float4 of the
    // token's K row is read once for RC rows of q (read by the whole warp)
    for (int t0 = 0; t0 < tt; t0 += THREADS / 2) {
      const int t = t0 + tok;
      const bool on = t < tt;   // every lane reaches the shuffles below
      for (int r0 = 0; r0 < gn; r0 += RC) {
        float s1[RC], s2[RC];
#pragma unroll
        for (int r = 0; r < RC; ++r) s1[r] = s2[r] = 0.f;
        if (on) {
          rows_dot(s1, q_s + r0 * KS, KS, k_s + t * KS, DP, half);
          if (D2) rows_dot(s2, q2_s + r0 * K2S, K2S, k2_s + t * K2S, D2, half);
        }
#pragma unroll
        for (int r = 0; r < RC; ++r) {
          s1[r] += __shfl_xor_sync(0xffffffffu, s1[r], 1);
          s2[r] += __shfl_xor_sync(0xffffffffu, s2[r], 1);
        }
        if (on && half == 0) {
#pragma unroll
          for (int r = 0; r < RC; ++r) {
            if (r0 + r >= gn) break;
            float s = a.ks ? s1[r] * ks_s[t] : s1[r];
            if (D2) s += a.k2s ? s2[r] * k2s_s[t] : s2[r];
            if (a.scale != 1.f) s *= a.scale;
            p_s[(r0 + r) * PS + t] = t < valid ? s : NEG_INF;
          }
        }
      }
    }
    __syncthreads();

    // online softmax: R lanes a row, reduced by shuffles. Every lane takes
    // part (rows past gn hold junk that is never stored), so each shuffle
    // sees its whole warp.
    {
      float* pr = p_s + srow * PS;
      float mx = m;
      for (int t = slane; t < tt; t += R) mx = fmaxf(mx, pr[t]);
      for (int o = R / 2; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o, R));
      float sum = 0.f;
      for (int t = slane; t < tt; t += R) {
        float e = t < valid ? expf(pr[t] - mx) : 0.f;
        sum += e;
        if (a.vs) e *= vs_s[t];
        if (round_p) e = __bfloat162float(__float2bfloat16(e));
        pr[t] = e;
      }
      for (int o = R / 2; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o, R);
      const float alpha = expf(m - mx);
      l = l * alpha + sum;
      m = mx;
      if (slane == 0) alpha_s[srow] = alpha;
    }
    __syncthreads();

    // acc = acc * alpha + p v, 4 tokens a step: one v value a token serves
    // the thread's ACC rows, whose weights come as float4s. The weights of
    // masked tokens are 0 and their v rows zero-filled (tt is a multiple of 4).
    float x[ACC];
#pragma unroll
    for (int i = 0; i < ACC; ++i) x[i] = 0.f;
    for (int t = 0; t < valid; t += 4) {
      const float v0 = v_s[t * DP + ed], v1 = v_s[(t + 1) * DP + ed];
      const float v2 = v_s[(t + 2) * DP + ed], v3 = v_s[(t + 3) * DP + ed];
#pragma unroll
      for (int i = 0; i < ACC; ++i) {
        const float4 w = *reinterpret_cast<const float4*>(p_s + (er + i * estep) * PS + t);
        x[i] = fmaf(w.x, v0, fmaf(w.y, v1, fmaf(w.z, v2, fmaf(w.w, v3, x[i]))));
      }
    }
#pragma unroll
    for (int i = 0; i < ACC; ++i)
      if (er + i * estep < gn) acc[i] = fmaf(acc[i], alpha_s[er + i * estep], x[i]);
  }

  if (a.splits == 1) {   // the whole lane in this block: normalise and store
    __syncthreads();
    if (srow < gn && slane == 0) alpha_s[srow] = fmaxf(l, 1e-30f);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < ACC; ++i) {
      const int g = er + i * estep;
      if (g < gn && (!PAD || ed < D))
        store_out(a.out, a.out_dtype, (qrow + g) * D + ed, acc[i] / alpha_s[g]);
    }
    return;
  }
  const long long prow = ((long long)split * a.B * a.H + bh) * a.G + g0;
  if (srow < gn && slane == 0) {
    a.part_ml[(prow + srow) * 2] = m;
    a.part_ml[(prow + srow) * 2 + 1] = l;
  }
#pragma unroll
  for (int i = 0; i < ACC; ++i) {
    const int g = er + i * estep;
    if (g < gn && (!PAD || ed < D)) a.part_acc[(prow + g) * D + ed] = acc[i];
  }
}

// One thread an output element (b, h, g, d): merge the slices in order.
__global__ void paged_combine_kernel(Args a) {
  const long long n = (long long)a.B * a.H * a.G * a.D;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long row = i / a.D, stride = (long long)a.B * a.H * a.G;
  float mx = NEG_INF;
  for (int s = 0; s < a.splits; ++s) mx = fmaxf(mx, a.part_ml[(s * stride + row) * 2]);
  float den = 0.f, num = 0.f;
  for (int s = 0; s < a.splits; ++s) {
    const long long r = s * stride + row;
    const float w = expf(a.part_ml[r * 2] - mx);
    den = fmaf(w, a.part_ml[r * 2 + 1], den);
    num = fmaf(w, a.part_acc[r * a.D + i % a.D], num);
  }
  store_out(a.out, a.out_dtype, i, num / fmaxf(den, 1e-30f));
}

// D's padded width: the next power of two from 8 to 128 (0 above 128).
__host__ __device__ __forceinline__ int padded_width(int D) {
  int dp = 8;
  while (dp < D) dp *= 2;
  return D <= 128 ? dp : 0;
}

int smem_bytes(const Args& a) {
  const int GT = ROW_ELEMS / a.DP, TT = pages_per_tile(a.block) * a.block;
  const int KS = a.DP + 8, K2S = a.D2 ? a.D2 + 8 : 0;
  // GT is a multiple of RC (DP <= 128), so the scores' RC-row groups stay in q_s
  const int floats = GT * KS + GT * K2S + TT * KS + TT * K2S + TT * a.DP + GT * (TT + 4) +
                     3 * TT + GT;
  return floats * 4;
}

template <typename T, bool PAD>
cudaError_t launch_at(const Args& a, cudaStream_t stream) {
  const int bytes = smem_bytes(a);
  cudaError_t err = cudaFuncSetAttribute(paged_kernel<T, PAD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const int gtiles = (a.G + ROW_ELEMS / a.DP - 1) / (ROW_ELEMS / a.DP);
  paged_kernel<T, PAD><<<dim3(a.splits, a.B * a.H, gtiles), THREADS, bytes, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.splits == 1) return err;
  const long long n = (long long)a.B * a.H * a.G * a.D;
  paged_combine_kernel<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  return a.D == a.DP ? launch_at<T, false>(a, stream) : launch_at<T, true>(a, stream);
}

}  // namespace

extern "C" {

// Page slices of a call: the caller sizes the fp32 partials, part_acc
// [splits, B*H, G, D] and part_ml [splits, B*H, G, 2], from it. From the
// shapes only: about TARGET_BLOCKS blocks, at least MIN_PAGES pages a slice.
int paged_attention_splits(int B, int H, int G, int D, int P) {
  if (D < 1 || D > 128) return 1;
  const int GT = ROW_ELEMS / padded_width(D);
  const long long tiles = (long long)B * H * ((G + GT - 1) / GT);
  long long want = (TARGET_BLOCKS + tiles - 1) / tiles;
  long long most = P / MIN_PAGES > 1 ? P / MIN_PAGES : 1;
  if (want > most) want = most;
  if (want > 65535) want = 65535;
  return (int)(want < 1 ? 1 : want);
}

// q [B, H, G, D] (fp32 / bf16, q2 likewise with D2, or null and D2 = 0);
// pages [NB, block, H, D] of page_dtype (k2 with D2); scales [NB, block, H]
// fp32 or null; out [B, H, G, D] of out_dtype. All contiguous; 1 <= D <= 128,
// D2 a multiple of 8 up to 128.
int paged_attention(const void* q, const void* q2, const void* k, const void* v, const void* k2,
                    const int* page_table, const int* lengths, const float* k_scale,
                    const float* v_scale, const float* k2_scale, void* out, float* part_acc,
                    float* part_ml, int B, int H, int G, int D, int D2, int block, int P,
                    int splits, float scale, int q_dtype, int page_dtype, int out_dtype,
                    int fused, void* stream) {
  if (D < 1 || D > 128) return cudaErrorInvalidValue;
  const int ppt = pages_per_tile(block);
  const int per_split = ((P + splits - 1) / splits + ppt - 1) / ppt * ppt;   // whole tiles
  Args a{q, q2, k, v, k2, page_table, lengths, k_scale, v_scale, k2_scale, out, part_acc,
         part_ml, B, H, G, D, padded_width(D), D2, block, P, splits, per_split, scale, q_dtype,
         out_dtype, fused};
  cudaStream_t s = (cudaStream_t)stream;
  switch (page_dtype) {
    case F32: return launch<float>(a, s);
    case BF16: return launch<__nv_bfloat16>(a, s);
    case I8: return launch<int8_t>(a, s);
    case FP8: return launch<__nv_fp8_e4m3>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"
