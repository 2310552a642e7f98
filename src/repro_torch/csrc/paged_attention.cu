// Paged attention for Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernel of the JAX package:
//   paged_decode_kernel / paged_mla_tc_kernel / paged_mla_tf32_kernel / paged_encode_kernel
//       + paged_combine_kernel
//       <- repro/kernels/paged_attention.py::_paged_kernel (paged_attention_pallas)
//
// What it computes. For lane b, KV head h and query row g,
//   o[b, h, g, :] = sum_t softmax_t(scale * s[g, t]) v[t, :]
// over the tokens t < lengths[b] of the lane's pages page_table[b, :], read
// from block storage k/v [NB, block, H, D]. The score is s = q . k in fp32,
// times k_scale[t] when given, plus (q2 . k2) * k2_scale[t] when q2 is given
// (MLA's absorbed decode), then times scale, then masked. The fp32 softmax
// weights are multiplied by v_scale[t] when given (after the denominator
// takes them), and on the plain path (no scales, no q2, q of the pages'
// dtype) rounded to the pages' dtype before the value product, as the TPU
// kernel does. A lane of length 0 returns exact zeros. Three consumers: the
// gqa decode read of the serving pool (G = query heads per KV head: qwen2's
// 6, phi3's 1; q fp32 over bf16 / fp32 / int8 / fp8 pages), MLA's absorbed
// decode read (one page head of compressed latents, both K and V, with the
// rotary key as q2's k2: G = 16, D = 512, D2 = 64 for DeepSeek-V2-Lite, G =
// 40, D = 256, D2 = 32 for MiniCPM3) and FLARE's encode off pages (G = M =
// 2048 latents, D = 8, the `paged` backend).
//
// What bounds it. The decode read: bytes, each valid token's K and V rows
// (and scales) once, plus q and o: qwen2-1.5b's layer at 8 slots of ~2,000
// tokens is ~12 MB, 3.64 us at 3.35 TB/s, at 2 * G * D FLOP a token row.
// The FLARE encode: fp32 operations, 2 * 2 * G * D FLOP and one exp a token
// and latent (0.313 ms at pde_40k, B = 1).
//
// The previous version had one design for both: a block took GT = 1024 / DP
// query rows, padded, and staged 64 tokens of K and V widened to fp32 in
// shared memory behind four barriers; every score went through shared
// memory. At phi3's G = 1 seven of a block's eight rows were idle, and the
// FLARE encode wrote and reread each of its 2048 x N scores. On an NVIDIA
// H100 80GB HBM3 at 700 W (PERF.md section 6, row 6): qwen2's read 0.0428
// ms (SDPA over the gathered view 0.091), phi3's 0.0749 ms (SDPA 0.0296),
// the encode at pde_40k, B = 1, 5.784 ms (SDPA 5.657). So the
// host picks an instance from the shapes (and, for MLA, the page dtype):
//
//   * paged_decode_kernel (G <= 32, or any G with q2 or D > 32): a block
//     takes one (lane, KV head), a slice of its pages and up to ROWS_MAX
//     query rows: all G of them where G <= ROWS_MAX, else a tile of G split
//     evenly (ceil(G / ceil(G / ROWS_MAX)) rows). The rows a block takes
//     are a compile-time count GTM (1, 2, 4, 6, 8), so at qwen2's G = 6 and
//     phi3's G = 1 no row is padded (a G of 3, 5 or 7 computes one idle
//     row); every row is computed without a branch, so that the rows'
//     chains interleave. The slice's K and V rows go through a ring of
//     STAGES tiles in shared memory, in their stored dtype, by cp.async
//     (STAGES - 1 tiles in flight ahead of the compute; the slice's page ids
//     are staged first, so no address waits on a load). A token group of TG
//     lanes takes one token: each lane reads EPL consecutive elements of D
//     (TG = DP / EPL) as 16-byte vectors (8-byte for one-byte pages where
//     the rows are many) and widens them in registers; the group's dot
//     products are summed by shuffles within the group. A group keeps an
//     online (max, den, acc) per row in registers with one rescale every U
//     tokens; at the end the groups of a warp merge by shuffles and the
//     warps through shared memory, in a fixed order. No score is kept
//     anywhere but registers. A first version with register loads and no
//     ring, a page id read before every row, took 0.0638 ms at qwen2's read
//     on the same card (NVIDIA H100 80GB HBM3, 700 W): latency, not bytes,
//     bounds this read.
//   * paged_mla_tc_kernel (D > 128, to 512; D2 to 64; bf16, int8 and fp8
//     pages): MLA's read, where the G heads share every latent row: 2 * G
//     * (D + D2 + D) FLOP a row of (D + D2) * bytes. DeepSeek-V2-Lite's
//     read (G 16, D 512, D2 64) at 8 lanes of ~1,500 tokens: 13.9 MB, 4.2
//     us at 3.35 TB/s; 0.42 GFLOP, 1.1 us for the split products below at
//     989 TFLOP/s. This instance, FlashMLA's layout for mma.sync: a block
//     of 8 warps takes
//     one lane, one m16 tile of G (DeepSeek's 16 heads;
//     MiniCPM3's 40 in three row tiles, each reading the lane's latents:
//     faster on the H100 than one block of three m16 tiles, as the rows'
//     latency, not the bytes, sets the pace) and a slice of the lane's
//     pages; each tile of 32 tokens [c | k_rope] comes in through a ring of
//     up to four stages by cp.async in the stored dtype (one-byte rows then
//     widened to bf16, exactly: |int8| <= 127, e4m3's 3 mantissa bits), eight
//     threads a row, and both products read it on the tensor cores
//     (m16n8k16, bf16 in, fp32 out). S = q [c | k_rope]^T is split over the
//     reduction: warp w takes columns [w D / 8, +D / 8) of c and k_rope's
//     16-wide step w, with q's fragments of them in registers, fp32 q in
//     three bf16 parts (which give it back exactly; the two lower ones
//     skipped by a block whose q is bf16-valued, as in bf16 serving); the
//     partial scores meet in shared memory, summed in a fixed order; the
//     softmax (warp w rows w and w + 8; lane t token t) keeps the online
//     (max, den) in registers, with the scales where the plain version puts
//     them (k_scale on the dot, k2_scale on the rope term, v_scale folded
//     into p), and hands P on through shared memory in two bf16 parts
//     (hi + lo: ~2^-18 of p). O = P c is split over the columns: warp w
//     holds the fp32 accumulators of the rows for its D / 8 columns. Each
//     16-wide step's products are independent MMAs from zero summed into
//     fp32 registers (the tensor core truncates its additions, and a chain
//     would wait on MMA latency), and a tile's P V goes into a fresh sum
//     folded in once a tile. q's loads are unconditional (clamped, then
//     selected) and in flight with the first tiles': behind a branch each,
//     they went one DRAM round trip at a time.
//     At D 256 registers are capped at 128 a thread, so two blocks fit an
//     SM (MiniCPM3; its int8 instance held one block an SM by its
//     registers alone); at D 512 the cap spilled and shared memory holds
//     one block an SM anyway. The ring takes as many stages as fit.
//     The slices are one wave of blocks (16 at DeepSeek's 8 lanes, 11 at
//     MiniCPM3's 24 lane row tiles), each walking a few tiles. V may be K (the MLA call, staged once) or its
//     own pages (two stages at D 512).
//   * paged_mla_tf32_kernel (the same shapes, fp32 pages: a direct call;
//     the MLA pool keeps bf16 latents in any compute dtype): the same
//     blocks and phases on the TF32 tensor cores (mma.sync m16n8k8). One
//     TF32 rounding of an operand misses the fp32 check (1e-5 of max |o|
//     against fp64), so q, the pages and P enter in two TF32 parts each,
//     three MMAs a product; the staged rows are fp32 (twice the bytes of
//     bf16: two stages of 32 tokens at D 512, 74 KB each; two blocks an SM
//     of two stages at D 256) and split as each fragment is read.
//   * paged_encode_kernel (G > 32, D <= 32, no q2): flare.cu's encode_kernel
//     read through the page table: a thread per query row (latent) with its
//     query, state and sums in registers; the tokens staged in shared memory
//     as fp32 rows that every thread reads as broadcasts; scores in chunks of
//     CH with one rescale a chunk and two-level sums (per staged tile, then
//     across tiles). No score goes through shared memory.
//
// The instances split each lane's valid pages into slices over blockIdx.x
// where the grid would underfill the card, and paged_combine_kernel merges
// the slices' fp32 (max, den, acc) in a fixed order (no atomics,
// deterministic). The host picks the slice count from the shapes and the
// card alone (the decode and MLA instances: one wave of blocks, from the
// occupancy API), never from lengths: nothing is read back to the host, so
// a decode step keeps its one device-to-host copy. Each block cuts its slice from its
// lane's own length on the card, so a short lane's slices are short and no
// block idles. With one slice the block writes o itself. The page table and lengths are read by each block from device
// memory; pages at or past ceil(lengths[b] / block) are never touched, and
// rows past lengths[b] are never loaded, so garbage there (even NaN) is
// invisible. Scales multiply the scores and weights, never the payload, so
// int8 / fp8 pages are never written out wide. Head dims: lanes D <= d < DP
// (DP the next power of two from 8) hold zeros, and nothing is written to
// them; pages, q and o keep their real D in device memory.
//
// The entry points launch on the given stream, allocate nothing (the caller
// gives the fp32 partials) and return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "flare_mma.cuh"

#include <mutex>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int ROWS_MAX = 8;              // query rows a decode block takes at most
constexpr int ENC_MIN_G = 33;            // the encode instance from this many query rows
constexpr int ENC_MAX_D = 32;            // ... up to this head dim
constexpr int TARGET_BLOCKS = 4 * 132;   // decode: about four blocks a streaming multiprocessor
constexpr int MIN_PAGES = 4;             // decode: pages a slice walks at least
constexpr int ENC_WAVE = 132 * 1024 / THREADS;   // encode: about 1024 threads an SM
constexpr int ENC_MIN_TOKENS = 1024;     // encode: tokens a slice walks at least
constexpr int TILE_FLOATS = 2048;        // encode: floats a staged K or V tile (8 KB)
constexpr int CH = 16;                   // encode: scores a chunk (one rescale a chunk)

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
  int rows;               // decode: query rows a block (G's tile)
  float scale;
  int q_dtype, page_dtype, out_dtype, fused;
  int stages;             // MLA's tensor-core instance: its ring's stages (2 to 4)
};

__device__ __forceinline__ float load_q(const void* q, int dtype, long long i) {
  return dtype == F32 ? static_cast<const float*>(q)[i]
                      : __bfloat162float(static_cast<const __nv_bfloat16*>(q)[i]);
}

__device__ __forceinline__ void store_out(void* out, int dtype, long long i, float x) {
  if (dtype == F32)
    static_cast<float*>(out)[i] = x;
  else
    static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16(x);
}

// Token t's row of one head, as an element offset into [NB, block, H, *]:
// (page_table[b, t / block] * block + t % block) * H + h, with the page ids
// pages[i] = page_table[b, p0 + i] (staged in shared memory, so that no
// address waits on a load from device memory).
__device__ __forceinline__ long long token_row(const int* pages, int p0, int t, int blk, int H,
                                               int h) {
  const int p = t / blk;
  return ((long long)pages[p - p0] * blk + (t - p * blk)) * H + h;
}

// The tokens [t_lo, t_hi) of page slice `split` of a lane of `len` tokens:
// the lane's valid pages, ceil(len / block) of at most P, cut in `splits`
// slices of whole pages. From the lane's own length (read on the card), so
// the slices of a short lane are short and none of them idles while another
// walks the lane; each is at most ceil(P / splits) pages.
__device__ __forceinline__ int2 lane_slice(const Args& a, int len, int split) {
  const int valid = min(a.P, (len + a.block - 1) / a.block);
  const int per = (valid + a.splits - 1) / a.splits;
  const int t_lo = min(len, split * per * a.block);
  return make_int2(t_lo, min(len, (split + 1) * per * a.block));
}

// pages[i] = ptb[p0 + i] for the pages [p0, p1) of a slice or tile.
__device__ __forceinline__ void stage_pages(int* pages, const int* ptb, int p0, int p1) {
  for (int i = threadIdx.x; i < p1 - p0; i += THREADS) pages[i] = ptb[p0 + i];
}

// ---------------------------------------------------------------------------
// The decode instance.

constexpr int STAGES = 3;                // the decode instance's ring of staged token tiles
constexpr int STAGE_TARGET = 16384;      // ... and the K + V bytes a stage aims at

// Elements of D a lane holds: 16 bytes of the page's dtype, 32 for fp32
// where the rows are few, 8 for the one-byte dtypes where they are many
// (query and sums take 2 * GTM * EPL registers).
template <typename T, int GTM>
__host__ __device__ constexpr int lane_elems() {
  return sizeof(T) == 4 ? (GTM <= 2 ? 8 : 4) : sizeof(T) == 2 ? 8 : (GTM <= 4 ? 16 : 8);
}

// Tokens a token group computes between two rescales (registers: 2 * U *
// EPL * sizeof(T) / 4 of raw K and V, GTM * U scores).
template <typename T, int GTM>
__host__ __device__ constexpr int group_tokens() {
  return GTM >= 6 || sizeof(T) == 4 ? 2 : 4;
}

// The decode instance's tiling of the tokens, the same on host and device:
// TG lanes a token, rows of `srb` bytes in shared memory (D rounded up to
// whole lanes, then to 16 bytes), `tt` tokens a staged tile (each warp takes
// `chunks` chunks of TPW * U tokens of it), copies of `cb` bytes.
struct DecodeTiling {
  int tg, tpw, srb, tt, chunks, cb;
};

template <typename T, int GTM>
__host__ __device__ inline DecodeTiling decode_tiling(int D, int DP) {
  constexpr int EPL = lane_elems<T, GTM>(), U = group_tokens<T, GTM>();
  DecodeTiling t;
  t.tg = DP >= EPL ? DP / EPL : 1;
  t.tpw = 32 / t.tg;
  t.srb = ((((D + EPL - 1) / EPL) * EPL * (int)sizeof(T)) + 15) / 16 * 16;
  const int per = WARPS * t.tpw * U;   // tokens of one chunk for every warp
  const int want = STAGE_TARGET / (2 * per * t.srb);
  t.chunks = want < 1 ? 1 : want;
  t.tt = per * t.chunks;
  const int rb = D * (int)sizeof(T);
  t.cb = rb % 16 == 0 ? 16 : rb % 8 == 0 ? 8 : rb % 4 == 0 ? 4 : (int)sizeof(T);
  return t;
}

// The ring's stages, then the page ids of the block's slice.
template <typename T, int GTM>
int decode_smem_bytes(int D, int DP, int pages_per_split) {
  const DecodeTiling t = decode_tiling<T, GTM>(D, DP);
  return STAGES * t.tt * (2 * t.srb + 2 * (int)sizeof(float)) +
         pages_per_split * (int)sizeof(int);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// cp.async of N bytes, zero-filled where `on` is false (nothing is read).
template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool on) {
  if constexpr (N == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "r"(on ? 16 : 0));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "n"(N), "r"(on ? N : 0));
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

template <typename T> __device__ __forceinline__ T zero_of();
template <> __device__ __forceinline__ float zero_of<float>() { return 0.f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero_of<__nv_bfloat16>() {
  return __ushort_as_bfloat16((unsigned short)0);
}
template <> __device__ __forceinline__ int8_t zero_of<int8_t>() { return 0; }
template <> __device__ __forceinline__ __nv_fp8_e4m3 zero_of<__nv_fp8_e4m3>() {
  __nv_fp8_e4m3 z;
  z.__x = 0;
  return z;
}

// Stage the K and V rows of tokens [t0, t0 + tt) (those at or past t_hi
// zero-filled, never read) and their scales into one stage of the ring:
// K rows, then V rows, srb bytes apart, then k_scale and v_scale.
template <typename T>
__device__ __forceinline__ void issue_tile(unsigned char* st, const Args& a, const int* pages,
                                           int p0, int t0, int t_hi, int h,
                                           const DecodeTiling& ti) {
  const int rb = a.D * (int)sizeof(T), cpr = rb / ti.cb;
  unsigned char* kst = st;
  unsigned char* vst = st + ti.tt * ti.srb;
  float* ks = reinterpret_cast<float*>(st + 2 * ti.tt * ti.srb);
  float* vs = ks + ti.tt;
  const unsigned char* kp = static_cast<const unsigned char*>(a.k);
  const unsigned char* vp = static_cast<const unsigned char*>(a.v);
  for (int i = threadIdx.x; i < ti.tt * cpr; i += THREADS) {
    const int r = i / cpr, c = (i - r * cpr) * ti.cb, t = t0 + r;
    const bool on = t < t_hi;
    const long long off = (on ? token_row(pages, p0, t, a.block, a.H, h) : 0) * rb + c;
    unsigned char* kd = kst + r * ti.srb + c;
    unsigned char* vd = vst + r * ti.srb + c;
    switch (ti.cb) {
      case 16: cp_async<16>(kd, kp + off, on), cp_async<16>(vd, vp + off, on); break;
      case 8: cp_async<8>(kd, kp + off, on), cp_async<8>(vd, vp + off, on); break;
      case 4: cp_async<4>(kd, kp + off, on), cp_async<4>(vd, vp + off, on); break;
      default:   // rows of no whole 4 bytes: one element a copy, synchronous
        *reinterpret_cast<T*>(kd) = on ? *reinterpret_cast<const T*>(kp + off) : zero_of<T>();
        *reinterpret_cast<T*>(vd) = on ? *reinterpret_cast<const T*>(vp + off) : zero_of<T>();
    }
  }
  if (a.ks || a.vs) {
    for (int r = threadIdx.x; r < ti.tt; r += THREADS) {
      const int t = t0 + r;
      const bool on = t < t_hi;
      const long long row = on ? token_row(pages, p0, t, a.block, a.H, h) : 0;
      if (a.ks) cp_async<4>(ks + r, a.ks + row, on);
      if (a.vs) cp_async<4>(vs + r, a.vs + row, on);
    }
  }
}

// EPL elements of a staged row from byte `src` (aligned to EPL * sizeof(T),
// or 16) into raw words.
template <typename T, int EPL>
__device__ __forceinline__ void lds_lane(uint32_t (&raw)[EPL * sizeof(T) / 4],
                                         const unsigned char* src) {
  constexpr int BYTES = EPL * sizeof(T);
  if constexpr (BYTES % 16 == 0) {
#pragma unroll
    for (int i = 0; i < BYTES / 16; ++i) {
      const uint4 x = reinterpret_cast<const uint4*>(src)[i];
      raw[4 * i] = x.x, raw[4 * i + 1] = x.y, raw[4 * i + 2] = x.z, raw[4 * i + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < BYTES / 8; ++i) {
      const uint2 x = reinterpret_cast<const uint2*>(src)[i];
      raw[2 * i] = x.x, raw[2 * i + 1] = x.y;
    }
  }
}

// Widened to fp32, the elements at or past `lim` (D - e0) zero.
template <typename T, int EPL>
__device__ __forceinline__ void widen_lane(float (&x)[EPL],
                                           const uint32_t (&raw)[EPL * sizeof(T) / 4], int lim) {
  T e[EPL];
  memcpy(e, raw, sizeof(e));
#pragma unroll
  for (int j = 0; j < EPL; ++j) x[j] = j < lim ? widen(e[j]) : 0.f;
}

// Grid (splits, B*H, row tiles). Block = lane b, KV head h, query rows
// [g0, g0 + gt) (gt <= GTM), the pages of slice `split` of the lane
// (lane_slice), whose tokens pass through a ring of STAGES staged tiles of
// `tt` tokens (cp.async, STAGES - 1 tiles in flight ahead of the compute).
// In a tile, warp w takes `chunks` chunks of TPW * U tokens; token group
// `grp` of the warp takes tokens u * TPW + grp, u < U, of a chunk.
template <typename T, int GTM>
__global__ void __launch_bounds__(THREADS) paged_decode_kernel(Args a) {
  constexpr int EPL = lane_elems<T, GTM>();
  constexpr int WORDS = EPL * (int)sizeof(T) / 4;
  constexpr int U = group_tokens<T, GTM>();
  extern __shared__ uint4 ring4[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(ring4);
  __shared__ float ws_acc[WARPS][GTM][128];   // the warps' sums, merged in order
  __shared__ float ws_ml[WARPS][GTM][2];
  __shared__ float q2_s[GTM][128];

  const int D = a.D, D2 = a.D2, blk = a.block, H = a.H;
  const DecodeTiling ti = decode_tiling<T, GTM>(D, a.DP);
  const int TG = ti.tg, TPW = ti.tpw;
  const int stage_bytes = ti.tt * (2 * ti.srb + 2 * (int)sizeof(float));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int grp = lane / TG, gl = lane % TG, e0 = gl * EPL, lim = D - e0;
  const int eoff = (lim > 0 ? e0 : 0) * (int)sizeof(T);   // a lane past D reads lane 0's, zeroed
  const int split = blockIdx.x, bh = blockIdx.y, b = bh / H, h = bh % H;
  const int g0 = blockIdx.z * a.rows, gt = min(a.rows, a.G - g0);
  const long long qrow = ((long long)b * H + h) * a.G + g0;
  const int* ptb = a.pt + (long long)b * a.P;
  const int len = a.lengths[b];
  const int2 sl = lane_slice(a, len, split);
  const int t_lo = sl.x, t_hi = sl.y;
  const int ntiles = t_hi > t_lo ? (t_hi - t_lo + ti.tt - 1) / ti.tt : 0;
  const int p0 = t_lo / blk;
  int* pages = reinterpret_cast<int*>(ring + STAGES * stage_bytes);
  stage_pages(pages, ptb, p0, t_hi > t_lo ? (t_hi + blk - 1) / blk : p0);
  __syncthreads();

  // the first tiles' copies go out before anything else waits on memory
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ntiles)
      issue_tile<T>(ring + s * stage_bytes, a, pages, p0, t_lo + s * ti.tt, t_hi, h, ti);
    cp_commit();
  }

  float qv[GTM][EPL];
#pragma unroll
  for (int g = 0; g < GTM; ++g)
#pragma unroll
    for (int j = 0; j < EPL; ++j)
      qv[g][j] = g < gt && j < lim ? load_q(a.q, a.q_dtype, (qrow + g) * D + e0 + j) : 0.f;
  for (int i = threadIdx.x; i < gt * D2; i += THREADS)
    q2_s[i / D2][i % D2] = load_q(a.q2, a.q_dtype, qrow * D2 + i);

  const bool round_p = !a.fused && sizeof(T) == 2;
  float m[GTM], l[GTM], acc[GTM][EPL];
#pragma unroll
  for (int g = 0; g < GTM; ++g) {
    m[g] = NEG_INF, l[g] = 0.f;
#pragma unroll
    for (int j = 0; j < EPL; ++j) acc[g][j] = 0.f;
  }

  for (int it = 0; it < ntiles; ++it) {
    const int nx = it + STAGES - 1;
    if (nx < ntiles)
      issue_tile<T>(ring + (nx % STAGES) * stage_bytes, a, pages, p0, t_lo + nx * ti.tt, t_hi,
                    h, ti);
    cp_commit();
    cp_wait<STAGES - 1>();   // this thread's copies of tile `it` have landed
    __syncthreads();         // ... and everyone's
    const unsigned char* kst = ring + (it % STAGES) * stage_bytes;
    const unsigned char* vst = kst + ti.tt * ti.srb;
    const float* ks_st = reinterpret_cast<const float*>(kst + 2 * ti.tt * ti.srb);
    const float* vs_st = ks_st + ti.tt;
    const int t0 = t_lo + it * ti.tt;

    for (int ch = 0; ch < ti.chunks; ++ch) {
      // No branch on the rows in here: every row of the instance is computed
      // (rows past gt have q = 0 and are never stored), so that the rows'
      // chains interleave; x 1 stands for an absent scale, exactly.
      const int c0 = (ch * WARPS + warp) * TPW * U;   // the chunk's first token in the tile
      uint32_t kr[U][WORDS];
      bool on[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int r = c0 + u * TPW + grp;
        on[u] = t0 + r < t_hi;
        lds_lane<T, EPL>(kr[u], kst + r * ti.srb + eoff);
      }
      float s[GTM][U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float kf[EPL];
        widen_lane<T, EPL>(kf, kr[u], lim);
#pragma unroll
        for (int g = 0; g < GTM; ++g) {
          float x = 0.f;
#pragma unroll
          for (int j = 0; j < EPL; ++j) x = fmaf(qv[g][j], kf[j], x);
          s[g][u] = x;
        }
      }
      for (int off = TG / 2; off > 0; off >>= 1) {   // sums over the token group's lanes
#pragma unroll
        for (int g = 0; g < GTM; ++g)
#pragma unroll
          for (int u = 0; u < U; ++u) s[g][u] += __shfl_xor_sync(0xffffffffu, s[g][u], off);
      }
      // the score order of the plain version: dot, x k_scale, + q2.k2 x
      // k2_scale, x scale, mask
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float sc = a.ks ? ks_st[c0 + u * TPW + grp] : 1.f;
#pragma unroll
        for (int g = 0; g < GTM; ++g) s[g][u] *= sc;
      }
      if (D2) {   // the group's lanes take every TG-th element of k2
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int t = t0 + c0 + u * TPW + grp;
          const long long row = on[u] ? token_row(pages, p0, t, blk, H, h) : 0;
          const T* k2row = static_cast<const T*>(a.k2) + row * D2;
          const float k2sc = a.k2s && on[u] ? a.k2s[row] : 1.f;
#pragma unroll
          for (int g = 0; g < GTM; ++g) {
            float x = 0.f;
            if (on[u]) {
              for (int d = gl; d < D2; d += TG) x = fmaf(q2_s[g][d], widen(k2row[d]), x);
            }
            for (int off = TG / 2; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
            s[g][u] += x * k2sc;
          }
        }
      }
#pragma unroll
      for (int g = 0; g < GTM; ++g) {
        float cmax = NEG_INF;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          s[g][u] = on[u] ? s[g][u] * a.scale : NEG_INF;
          cmax = fmaxf(cmax, s[g][u]);
        }
        const float mnew = fmaxf(m[g], cmax);
        const float alpha = __expf(m[g] - mnew);
        l[g] *= alpha;
#pragma unroll
        for (int j = 0; j < EPL; ++j) acc[g][j] *= alpha;
        m[g] = mnew;
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int r = c0 + u * TPW + grp;
        float vf[EPL];
        {
          uint32_t vr[WORDS];
          lds_lane<T, EPL>(vr, vst + r * ti.srb + eoff);
          widen_lane<T, EPL>(vf, vr, lim);
        }
        const float vsc = a.vs ? vs_st[r] : 1.f;
#pragma unroll
        for (int g = 0; g < GTM; ++g) {
          float p = on[u] ? __expf(s[g][u] - m[g]) : 0.f;
          l[g] += p;
          p *= vsc;
          p = round_p ? __bfloat162float(__float2bfloat16(p)) : p;
#pragma unroll
          for (int j = 0; j < EPL; ++j) acc[g][j] = fmaf(p, vf[j], acc[g][j]);
        }
      }
    }
    __syncthreads();   // the tile's stage is refilled by the next iteration
  }
  cp_wait<0>();

  // merge the warp's token groups (lanes TG apart hold the same elements)
  for (int off = TG; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < GTM; ++g) {
      if (g >= gt) continue;
      const float om = __shfl_xor_sync(0xffffffffu, m[g], off);
      const float ol = __shfl_xor_sync(0xffffffffu, l[g], off);
      const float mx = fmaxf(m[g], om);
      const float sa = expf(m[g] - mx), sb = expf(om - mx);
      l[g] = fmaf(l[g], sa, ol * sb);
#pragma unroll
      for (int j = 0; j < EPL; ++j) {
        const float oa = __shfl_xor_sync(0xffffffffu, acc[g][j], off);
        acc[g][j] = fmaf(acc[g][j], sa, oa * sb);
      }
      m[g] = mx;
    }
  }
  if (grp == 0) {
#pragma unroll
    for (int g = 0; g < GTM; ++g) {
      if (g >= gt) continue;
#pragma unroll
      for (int j = 0; j < EPL; ++j)
        if (j < lim) ws_acc[warp][g][e0 + j] = acc[g][j];
      if (gl == 0) ws_ml[warp][g][0] = m[g], ws_ml[warp][g][1] = l[g];
    }
  }
  __syncthreads();
  // merge the warps in order, one thread an output element
  const long long prow = ((long long)split * a.B * H + bh) * a.G + g0;
  for (int i = threadIdx.x; i < gt * D; i += THREADS) {
    const int g = i / D, d = i % D;
    float mx = NEG_INF;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, ws_ml[w][g][0]);
    float den = 0.f, num = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float sc = expf(ws_ml[w][g][0] - mx);
      den = fmaf(sc, ws_ml[w][g][1], den);
      num = fmaf(sc, ws_acc[w][g][d], num);
    }
    if (a.splits == 1) {
      store_out(a.out, a.out_dtype, (qrow + g) * D + d, num / fmaxf(den, 1e-30f));
    } else {
      a.part_acc[(prow + g) * D + d] = num;
      if (d == 0) a.part_ml[(prow + g) * 2] = mx, a.part_ml[(prow + g) * 2 + 1] = den;
    }
  }
}

// ---------------------------------------------------------------------------
// The encode instance.

// Tokens [t0, t0 + tn) of the lane's head into fp32 rows of DP lanes (dst
// [TN][DP]), rows [tn, TN) and lanes [D, DP) zero: 16-byte loads where a row
// is a whole number of them and D == DP, else one element a load.
template <typename T, int DP>
__device__ __forceinline__ void stage_rows(float* dst, const T* src, const int* pages, int p0,
                                           int t0, int tn, int blk, int H, int h, int D) {
  constexpr int TN = TILE_FLOATS / DP;
  constexpr int VE = 16 / sizeof(T) < DP ? 16 / sizeof(T) : DP;   // elements a vector
  if (D == DP && (DP * sizeof(T)) % 16 == 0) {
    constexpr int NV = TN * (DP / VE), ITEMS = (NV + THREADS - 1) / THREADS;
    uint4 raw[ITEMS];   // every load of the tile in flight before the first store
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const int i = threadIdx.x + j * THREADS, r = i / (DP / VE), c = (i % (DP / VE)) * VE;
      raw[j] = i < NV && r < tn ? *reinterpret_cast<const uint4*>(
                                      src + token_row(pages, p0, t0 + r, blk, H, h) * D + c)
                                : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const int i = threadIdx.x + j * THREADS;
      if (i >= NV) break;
      T e[VE];
      memcpy(e, &raw[j], sizeof(e));
#pragma unroll
      for (int k = 0; k < VE; ++k) dst[i * VE + k] = widen(e[k]);
    }
  } else {
    for (int i = threadIdx.x; i < TN * DP; i += THREADS) {
      const int r = i / DP, c = i % DP;
      dst[i] = r < tn && c < D ? widen(src[token_row(pages, p0, t0 + r, blk, H, h) * D + c])
                                : 0.f;
    }
  }
}

template <int DP>
__device__ __forceinline__ void stage_tile(float* k_s, float* v_s, const Args& a,
                                           const int* pages, int p0, int t0, int tn, int h) {
  const int blk = a.block, H = a.H, D = a.D;
  switch (a.page_dtype) {
    case F32:
      stage_rows<float, DP>(k_s, (const float*)a.k, pages, p0, t0, tn, blk, H, h, D);
      stage_rows<float, DP>(v_s, (const float*)a.v, pages, p0, t0, tn, blk, H, h, D);
      break;
    case BF16:
      stage_rows<__nv_bfloat16, DP>(k_s, (const __nv_bfloat16*)a.k, pages, p0, t0, tn, blk, H,
                                    h, D);
      stage_rows<__nv_bfloat16, DP>(v_s, (const __nv_bfloat16*)a.v, pages, p0, t0, tn, blk, H,
                                    h, D);
      break;
    case I8:
      stage_rows<int8_t, DP>(k_s, (const int8_t*)a.k, pages, p0, t0, tn, blk, H, h, D);
      stage_rows<int8_t, DP>(v_s, (const int8_t*)a.v, pages, p0, t0, tn, blk, H, h, D);
      break;
    default:
      stage_rows<__nv_fp8_e4m3, DP>(k_s, (const __nv_fp8_e4m3*)a.k, pages, p0, t0, tn, blk, H,
                                    h, D);
      stage_rows<__nv_fp8_e4m3, DP>(v_s, (const __nv_fp8_e4m3*)a.v, pages, p0, t0, tn, blk, H,
                                    h, D);
  }
}

// Grid (splits, B*H, ceil(G / THREADS)); thread = query row g of (b, h) over
// the tokens of the block's page slice. PLAIN: no scales, scale 1 and no
// rounding of the weights (the FLARE encode); else each is applied in the
// score order above.
template <int DP, bool PLAIN>
__global__ void __launch_bounds__(THREADS) paged_encode_kernel(Args a) {
  constexpr int TN = TILE_FLOATS / DP;   // tokens a staged tile
  __shared__ float k_s[TILE_FLOATS];
  __shared__ float v_s[TILE_FLOATS];
  __shared__ float ks_s[PLAIN ? 1 : TN];
  __shared__ float vs_s[PLAIN ? 1 : TN];
  __shared__ int pg_s[TN / 4 + 2];   // the tile's page ids (pages of at least 4 tokens)
  const int D = a.D, blk = a.block, H = a.H;
  const int split = blockIdx.x, bh = blockIdx.y, b = bh / H, h = bh % H;
  const int g = blockIdx.z * THREADS + threadIdx.x;
  const bool live = g < a.G;
  const long long qrow = ((long long)b * H + h) * a.G + (live ? g : 0);
  const int* ptb = a.pt + (long long)b * a.P;
  const bool round_p = !a.fused && a.page_dtype == BF16;

  float x[DP];
#pragma unroll
  for (int d = 0; d < DP; ++d) x[d] = live && d < D ? load_q(a.q, a.q_dtype, qrow * D + d) : 0.f;
  float mx = NEG_INF, den = 0.f, acc[DP];           // this tile, against mx
  float tot_mx = NEG_INF, tot_den = 0.f, tot[DP];   // finished tiles, against tot_mx
#pragma unroll
  for (int d = 0; d < DP; ++d) acc[d] = tot[d] = 0.f;

  const int len = a.lengths[b];
  const int2 sl = lane_slice(a, len, split);
  const int t_lo = sl.x, t_hi = sl.y;
  for (int t0 = t_lo; t0 < t_hi; t0 += TN) {
    const int tn = min(TN, t_hi - t0);
    __syncthreads();   // the previous tile's reads are done
    const int pa = t0 / blk;
    stage_pages(pg_s, ptb, pa, (t0 + tn - 1) / blk + 1);
    __syncthreads();
    stage_tile<DP>(k_s, v_s, a, pg_s, pa, t0, tn, h);
    if (!PLAIN) {
      for (int i = threadIdx.x; i < tn; i += THREADS) {
        const long long r = token_row(pg_s, pa, t0 + i, blk, H, h);
        ks_s[i] = a.ks ? a.ks[r] : 1.f;
        vs_s[i] = a.vs ? a.vs[r] : 1.f;
      }
    }
    __syncthreads();
    for (int c0 = 0; c0 < tn; c0 += CH) {
      const int cnt = min(CH, tn - c0);
      const float* key = k_s + c0 * DP;
      const float* val = v_s + c0 * DP;
      float s[CH];
      float cmax = NEG_INF;
#pragma unroll
      for (int j = 0; j < CH; ++j) {
        float e = 0.f;
#pragma unroll
        for (int d = 0; d < DP; ++d) e = fmaf(x[d], key[j * DP + d], e);
        if (!PLAIN) {
          if (a.ks) e *= ks_s[c0 + j < tn ? c0 + j : 0];
          if (a.scale != 1.f) e *= a.scale;
        }
        s[j] = j < cnt ? e : NEG_INF;
        cmax = fmaxf(cmax, s[j]);
      }
      const float mnew = fmaxf(mx, cmax);
      const float alpha = __expf(mx - mnew);
      den *= alpha;
#pragma unroll
      for (int d = 0; d < DP; ++d) acc[d] *= alpha;
#pragma unroll
      for (int j = 0; j < CH; ++j) {
        float p = j < cnt ? __expf(s[j] - mnew) : 0.f;
        den += p;
        if (!PLAIN) {
          if (a.vs) p *= vs_s[c0 + j < tn ? c0 + j : 0];
          if (round_p) p = __bfloat162float(__float2bfloat16(p));
        }
#pragma unroll
        for (int d = 0; d < DP; ++d) acc[d] = fmaf(p, val[j * DP + d], acc[d]);
      }
      mx = mnew;
    }
    // fold the tile into the totals (mx >= tot_mx)
    const float alpha = __expf(tot_mx - mx);
    tot_den = fmaf(tot_den, alpha, den);
#pragma unroll
    for (int d = 0; d < DP; ++d) {
      tot[d] = fmaf(tot[d], alpha, acc[d]);
      acc[d] = 0.f;
    }
    tot_mx = mx;
    den = 0.f;
  }
  if (!live) return;
  if (a.splits == 1) {
    const float inv = 1.f / fmaxf(tot_den, 1e-30f);
#pragma unroll
    for (int d = 0; d < DP; ++d)
      if (d < D) store_out(a.out, a.out_dtype, qrow * D + d, tot[d] * inv);
    return;
  }
  const long long prow = ((long long)split * a.B * H + bh) * a.G + g;
  a.part_ml[prow * 2] = tot_mx;
  a.part_ml[prow * 2 + 1] = tot_den;
#pragma unroll
  for (int d = 0; d < DP; ++d)
    if (d < D) a.part_acc[prow * D + d] = tot[d];
}

// ---------------------------------------------------------------------------
// The MLA instances.

constexpr int MLA_THREADS = 256;
constexpr int MLA_WARPS = MLA_THREADS / 32;
constexpr int MLA_TT = 32;    // tokens a staged tile: one a lane of each warp in the softmax
constexpr int MLA_MAX_D2 = 64;

// ---------------------------------------------------------------------------
// The MLA instance on the tensor cores (bf16, int8 and fp8 pages).

constexpr int MLA_TC_ROWS = 16;      // query rows a block: one m16 tile (G past 16: row tiles)
constexpr int MLA_PS = MLA_TT + 8;   // row stride of the partial scores (floats) and of P (bf16)
constexpr int SMEM_MAX = 232448;     // dynamic shared memory a block may take on the H100
constexpr int MLA_TC_STAGES = 4;     // the ring's stages at most: three tiles in flight

using bf16 = __nv_bfloat16;

// The block's shared memory, in bytes from its start: a ring of `stages`
// tiles of MLA_TT tokens in the stored dtype (each row [c | k_rope], the
// latents' DP columns then k_rope's D2P, then V's rows where V is not K,
// then k_scale, v_scale and k2_scale), for one-byte pages the current tile
// widened to bf16, each warp's partial scores over its columns of c [rows]
// [MLA_PS] and over its step of k_rope, P in two bf16 parts [rows][MLA_PS],
// each row's rescale, max and den, the slice's page ids. bf16 row strides are an
// odd number of 16-byte units, so ldmatrix's eight rows hit eight bank groups.
// row and vrow, the strides of a staged row, are bytes in mla_tc_layout and
// floats in mla_tf32_layout; every other offset is bytes from the start.
struct MlaTcLayout {
  int d2p, kr, row, vrow, raw_row, raw_vrow, stage, stages, conv, part, rpart, ph, pl, alpha, m,
      l, pages, total;
};

__host__ __device__ inline MlaTcLayout mla_tc_layout(int esize, int DP, int D2, bool sep_v,
                                                     int pages_per_split, int stages) {
  MlaTcLayout L;
  constexpr int rows = MLA_TC_ROWS;
  L.d2p = (D2 + 15) / 16 * 16;
  L.kr = L.d2p / 16;                          // k_rope's 16-wide steps: warps 0 .. kr - 1
  L.row = (DP + L.d2p) * 2 + 16;               // a bf16 row of the tile
  L.vrow = DP * 2 + 16;                        // a bf16 row of a separate V
  L.raw_row = esize == 2 ? L.row : DP + L.d2p; // the stored rows (one-byte: widened later)
  L.raw_vrow = esize == 2 ? L.vrow : DP;
  L.stage = MLA_TT * (L.raw_row + (sep_v ? L.raw_vrow : 0)) + 3 * MLA_TT * (int)sizeof(float);
  L.stages = stages;
  L.conv = stages * L.stage;
  L.part = L.conv + (esize == 2 ? 0 : MLA_TT * (L.row + (sep_v ? L.vrow : 0)));
  L.rpart = L.part + MLA_WARPS * rows * MLA_PS * (int)sizeof(float);
  L.ph = L.rpart + L.kr * rows * MLA_PS * (int)sizeof(float);
  L.pl = L.ph + rows * MLA_PS * 2;
  L.alpha = L.pl + rows * MLA_PS * 2;
  L.m = L.alpha + rows * (int)sizeof(float);
  L.l = L.m + rows * (int)sizeof(float);
  L.pages = L.l + rows * (int)sizeof(float);
  L.total = L.pages + (pages_per_split + 3) / 4 * 16;
  return L;
}

// As many stages as fit in shared memory, up to MLA_TC_STAGES (two with a
// separate V at D 512).
inline MlaTcLayout mla_tc_fit(int esize, int DP, int D2, bool sep_v, int pps) {
  MlaTcLayout L = mla_tc_layout(esize, DP, D2, sep_v, pps, MLA_TC_STAGES);
  for (int st = MLA_TC_STAGES - 1; L.total > SMEM_MAX && st >= 2; --st)
    L = mla_tc_layout(esize, DP, D2, sep_v, pps, st);
  return L;
}

// Stage the rows of tokens [t0, t0 + MLA_TT) (those at or past t_hi
// zero-filled, never read) in the stored dtype into one stage: c at column
// 0 and k_rope at column DP of each row, V's rows after K's where V is its
// own, then the three scales. Eight threads take a row, so each finds its
// row in the page table once a tile (the page ids of the slice are in
// shared memory) and issues its copies at fixed offsets from it.
template <typename T>
__device__ __forceinline__ void issue_mla_tc_tile(unsigned char* st, const Args& a,
                                                  const int* pages, int p0, int t0, int t_hi,
                                                  int h, const MlaTcLayout& L, bool sep_v) {
  static_assert(MLA_THREADS == 8 * MLA_TT, "eight threads a staged row");
  const int r = threadIdx.x >> 3, j0 = threadIdx.x & 7, t = t0 + r;
  const bool on = t < t_hi;
  const long long row = on ? token_row(pages, p0, t, a.block, a.H, h) : 0;
  const int rb = a.D * (int)sizeof(T);
  const int cb = rb % 16 == 0 ? 16 : rb % 8 == 0 ? 8 : rb % 4 == 0 ? 4 : (int)sizeof(T);
  for (int which = 0; which < (sep_v ? 2 : 1); ++which) {
    const unsigned char* src = static_cast<const unsigned char*>(which ? a.v : a.k) + row * rb;
    unsigned char* dst = st + (which ? MLA_TT * L.raw_row + r * L.raw_vrow : r * L.raw_row);
    for (int c = j0 * cb; c < rb; c += 8 * cb) {
      switch (cb) {
        case 16: cp_async<16>(dst + c, src + c, on); break;
        case 8: cp_async<8>(dst + c, src + c, on); break;
        case 4: cp_async<4>(dst + c, src + c, on); break;
        default:
          *reinterpret_cast<T*>(dst + c) = on ? *reinterpret_cast<const T*>(src + c) : zero_of<T>();
      }
    }
  }
  if (a.D2) {   // D2 a multiple of 8: rows of 8, 16, 32 or 64 bytes
    const int rb2 = a.D2 * (int)sizeof(T), cb2 = rb2 % 16 == 0 ? 16 : 8;
    const unsigned char* src = static_cast<const unsigned char*>(a.k2) + row * rb2;
    unsigned char* dst = st + r * L.raw_row + a.DP * (int)sizeof(T);
    for (int c = j0 * cb2; c < rb2; c += 8 * cb2) {
      if (cb2 == 16)
        cp_async<16>(dst + c, src + c, on);
      else
        cp_async<8>(dst + c, src + c, on);
    }
  }
  if (a.ks || a.vs || a.k2s) {
    float* scales = reinterpret_cast<float*>(st + MLA_TT * (L.raw_row + (sep_v ? L.raw_vrow : 0)));
    const float* sc = j0 == 0 ? a.ks : j0 == 1 ? a.vs : j0 == 2 ? a.k2s : nullptr;
    if (sc) cp_async<4>(scales + j0 * MLA_TT + r, sc + row, on);
  }
}

// One-byte rows widened to bf16 (exact: |int8| <= 127 and e4m3's 3 mantissa
// bits fit bf16's 8): `rows` rows of `cols` elements (a multiple of 16).
template <typename T>
__device__ __forceinline__ void widen_rows(unsigned char* dst, int drow, const unsigned char* src,
                                           int srow, int cols) {
  const int per = cols / 16;
  for (int i = threadIdx.x; i < MLA_TT * per; i += MLA_THREADS) {
    const int r = i / per, c = (i - r * per) * 16;
    const uint4 raw = *reinterpret_cast<const uint4*>(src + r * srow + c);
    T e[16];
    memcpy(e, &raw, sizeof(e));
    uint32_t w[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const __nv_bfloat162 pair = __floats2bfloat162_rn(widen(e[2 * j]), widen(e[2 * j + 1]));
      memcpy(&w[j], &pair, 4);
    }
    uint4* d = reinterpret_cast<uint4*>(dst + r * drow + 2 * c);
    d[0] = make_uint4(w[0], w[1], w[2], w[3]);
    d[1] = make_uint4(w[4], w[5], w[6], w[7]);
  }
}

// ldmatrix and the m16n8k16 MMA (bf16 in, fp32 out; the fragments are
// flare_mma.cuh's)
using flare::ldsm;
using flare::ldsm_t;
using flare::mma_bf16z;

// x = p0 + p1 + p2 exactly, each part bf16 (8 significant bits each, rounded
// to nearest: together the 24 of fp32)
__device__ __forceinline__ void split3(float x, bf16& p0, bf16& p1, bf16& p2) {
  p0 = __float2bfloat16_rn(x);
  const float r = x - __bfloat162float(p0);
  p1 = __float2bfloat16_rn(r);
  p2 = __float2bfloat16_rn(r - __bfloat162float(p1));
}

__device__ __forceinline__ uint32_t pack(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// The A fragments, in three bf16 parts, of rows [r0, r0 + 16) and columns
// [c0, c0 + 16) of a query operand x [rows, D] of type Q (zero past `rows`
// and D); returns whether the two lower parts are all zero (x bf16-valued).
// The loads are unconditional (clamped in range, then selected), so all of
// them are in flight at once: behind a branch each, a block's 32 loads went
// one DRAM round trip at a time.
template <typename Q>
__device__ __forceinline__ bool q_frags(uint32_t (&f)[3][4], const Q* x, long long base, int ld,
                                        int r0, int rows, int c0, int D) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float v[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r = r0 + g + 8 * (i & 1), c = c0 + 2 * t + 8 * (i >> 1) + e;
      const float y = widen(x[base + (long long)min(r, rows - 1) * ld + min(c, D - 1)]);
      v[i][e] = r < rows && c < D ? y : 0.f;
    }
  bool exact = true;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    bf16 p[2][3];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      split3(v[i][e], p[e][0], p[e][1], p[e][2]);
      exact &= __bfloat162float(p[e][1]) == 0.f;
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) f[k][i] = pack(p[0][k], p[1][k]);
  }
  return exact;
}

// s += q b with q in its parts (the lower two skipped where q is
// bf16-valued): independent MMAs from zero, summed small terms first in fp32
__device__ __forceinline__ void mma_q(float (&s)[4], const uint32_t (&f)[3][4], bool exact,
                                      uint32_t b0, uint32_t b1) {
  float x[4], y[4], z[4];
  mma_bf16z(z, f[0], b0, b1);
  if (exact) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[e] += z[e];
    return;
  }
  mma_bf16z(x, f[2], b0, b1);
  mma_bf16z(y, f[1], b0, b1);
#pragma unroll
  for (int e = 0; e < 4; ++e) s[e] += (x[e] + y[e]) + z[e];
}

// Grid (splits, B*H, row tiles). Block = lane b, page head h, query rows
// [g0, g0 + gt) (gt <= 16: one m16 tile), the pages of slice `split` of the
// lane. Each tile of MLA_TT tokens is staged once (cp.async, STAGES - 1
// tiles in flight; one-byte rows then widened to bf16) and both products
// read it on the tensor cores (mma.sync m16n8k16, bf16 in, fp32 out):
//   * scores: warp w takes the columns [w DP / 8, +DP / 8) of c (and step w
//     of k_rope, w < kr), with q's and q2's fragments of those columns in
//     three bf16 parts in registers: its partial S = q c^T over its
//     columns, each 16-wide step's MMAs from zero into fp32 sums, to shared
//     memory; then warp w takes rows w and w + 8, lane t token t:
//     the eight partials summed in a fixed order, the k_rope term, the
//     scales, the mask, the online (max, den) in registers, and P = p *
//     v_scale split into two bf16 parts (hi + lo, ~2^-18 of p), with the
//     rows' rescale, into shared memory;
//   * values: warp w holds the fp32 accumulators of all rows for its
//     columns of V: O = O * rescale + (P_hi + P_lo) V, one 16-token step's
//     two MMAs from zero at a time into a fresh sum folded in once a tile.
template <typename T, int DP>
__global__ void __launch_bounds__(MLA_THREADS, DP == 256 ? 2 : 1) paged_mla_tc_kernel(Args a) {
  constexpr int CW = DP / MLA_WARPS;   // columns of c a warp takes
  constexpr int KW = CW / 16;          // their 16-wide steps (the scores' k)
  constexpr int NW = CW / 8;           // their 8-wide tiles (the values' n)
  constexpr int NT = MLA_TT / 8;       // token tiles of a staged tile
  constexpr int ROWS = MLA_TC_ROWS;
  constexpr int SR = ROWS / MLA_WARPS; // softmax rows a warp
  constexpr bool WIDEN = sizeof(T) == 1;
  extern __shared__ uint4 smem4[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem4);

  const int D = a.D, blk = a.block, H = a.H;
  const bool sep_v = a.v != a.k;
  const MlaTcLayout L = mla_tc_layout(sizeof(T), DP, a.D2, sep_v, a.pages_per_split, a.stages);
  float* part = reinterpret_cast<float*>(smem + L.part);
  float* rpart = reinterpret_cast<float*>(smem + L.rpart);
  bf16* ph_s = reinterpret_cast<bf16*>(smem + L.ph);
  bf16* pl_s = reinterpret_cast<bf16*>(smem + L.pl);
  float* alpha_s = reinterpret_cast<float*>(smem + L.alpha);
  float* m_s = reinterpret_cast<float*>(smem + L.m);
  float* l_s = reinterpret_cast<float*>(smem + L.l);
  int* pages = reinterpret_cast<int*>(smem + L.pages);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int split = blockIdx.x, bh = blockIdx.y, b = bh / H, h = bh % H;
  const int g0 = blockIdx.z * a.rows, gt = min(a.rows, a.G - g0);
  const long long qrow = ((long long)b * H + h) * a.G + g0;
  const int* ptb = a.pt + (long long)b * a.P;
  const int len = a.lengths[b];
  const int2 sl = lane_slice(a, len, split);
  const int t_lo = sl.x, t_hi = sl.y;
  const int ntiles = t_hi > t_lo ? (t_hi - t_lo + MLA_TT - 1) / MLA_TT : 0;
  const int p0 = t_lo / blk, p1 = t_hi > t_lo ? (t_hi + blk - 1) / blk : p0;
  const int S = L.stages;
  for (int i = threadIdx.x; i < p1 - p0; i += MLA_THREADS) pages[i] = ptb[p0 + i];
  // the columns past D and past D2 of the staged rows are zero, never
  // written by a copy (the products read them)
  if (D < DP || a.D2 < L.d2p) {
    for (int i = threadIdx.x; i < S * L.stage / 16; i += MLA_THREADS)
      smem4[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();   // page ids and zero fill
  for (int s = 0; s < S - 1; ++s) {
    if (s < ntiles)
      issue_mla_tc_tile<T>(smem + s * L.stage, a, pages, p0, t_lo + s * MLA_TT, t_hi, h, L,
                           sep_v);
    cp_commit();
  }
  // q's fragments of this warp's columns and q2's of its step of k_rope
  // (their loads in flight with the first tiles')
  uint32_t qf[KW][3][4], qr[3][4];
  bool exact = true;
  auto load_frags = [&](auto* q, auto* q2) {
#pragma unroll
    for (int kk = 0; kk < KW; ++kk)
      exact &= q_frags(qf[kk], q, qrow * D, D, 0, gt, warp * CW + 16 * kk, D);
    if (warp < L.kr) exact &= q_frags(qr, q2, qrow * a.D2, a.D2, 0, gt, 16 * warp, a.D2);
  };
  if (a.q_dtype == F32)
    load_frags(static_cast<const float*>(a.q), static_cast<const float*>(a.q2));
  else
    load_frags(static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.q2));
  exact = __syncthreads_and(exact);

  const bool round_p = !a.fused && sizeof(T) == 2;
  float m[SR], l[SR];
#pragma unroll
  for (int j = 0; j < SR; ++j) m[j] = NEG_INF, l[j] = 0.f;
  float o[NW][4];
#pragma unroll
  for (int n = 0; n < NW; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  // ldmatrix's row and column offsets of this lane (its matrix l / 8, row l %
  // 8): A fragments and .trans B fragments (lr, lc); the scores' B fragments,
  // tokens as rows (br, bc)
  const int lr = (lane & 7) + ((lane >> 3) & 1) * 8, lc = (lane >> 4) * 8;
  const int br = (lane & 7) + (lane >> 4) * 8, bc = ((lane >> 3) & 1) * 8;

  for (int it = 0; it < ntiles; ++it) {
    const int t0 = t_lo + it * MLA_TT;
    if (S == 4)
      cp_wait<2>();
    else if (S == 3)
      cp_wait<1>();
    else
      cp_wait<0>();
    __syncthreads();   // tile `it` has landed for all; the previous tile's reads are done
    if (it + S - 1 < ntiles)
      issue_mla_tc_tile<T>(smem + ((it + S - 1) % S) * L.stage, a, pages, p0,
                           t0 + (S - 1) * MLA_TT, t_hi, h, L, sep_v);
    cp_commit();
    const unsigned char* st = smem + (it % S) * L.stage;
    const float* ks_st = reinterpret_cast<const float*>(
        st + MLA_TT * (L.raw_row + (sep_v ? L.raw_vrow : 0)));
    const float* vs_st = ks_st + MLA_TT;
    const float* k2s_st = vs_st + MLA_TT;
    const unsigned char* kt = st;   // bf16 rows [c | k_rope], L.row apart
    const unsigned char* vt = sep_v ? st + MLA_TT * L.raw_row : st;
    const int vrow = sep_v ? L.vrow : L.row;
    if constexpr (WIDEN) {
      unsigned char* conv = smem + L.conv;
      widen_rows<T>(conv, L.row, st, L.raw_row, DP + L.d2p);
      if (sep_v) widen_rows<T>(conv + MLA_TT * L.row, L.vrow, st + MLA_TT * L.raw_row,
                               L.raw_vrow, DP);
      __syncthreads();
      kt = conv;
      vt = sep_v ? conv + MLA_TT * L.row : conv;
    }

    // ---- partial scores over this warp's columns (and its k_rope step)
    {
      float sc[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KW; ++kk) {
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t bb[4];
          ldsm(bb, kt + (16 * np + br) * L.row + 2 * (warp * CW + 16 * kk + bc));
          mma_q(sc[2 * np], qf[kk], exact, bb[0], bb[1]);
          mma_q(sc[2 * np + 1], qf[kk], exact, bb[2], bb[3]);
        }
      }
      float* pw = part + warp * ROWS * MLA_PS;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        *reinterpret_cast<float2*>(pw + g * MLA_PS + 8 * n + 2 * t) = make_float2(sc[n][0], sc[n][1]);
        *reinterpret_cast<float2*>(pw + (g + 8) * MLA_PS + 8 * n + 2 * t) =
            make_float2(sc[n][2], sc[n][3]);
      }
      if (warp < L.kr) {
        float* rw = rpart + warp * ROWS * MLA_PS;
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t bb[4];
          ldsm(bb, kt + (16 * np + br) * L.row + 2 * (DP + 16 * warp + bc));
          float c0[4] = {0.f, 0.f, 0.f, 0.f}, c1[4] = {0.f, 0.f, 0.f, 0.f};
          mma_q(c0, qr, exact, bb[0], bb[1]);
          mma_q(c1, qr, exact, bb[2], bb[3]);
          const int n = 2 * np;
          *reinterpret_cast<float2*>(rw + g * MLA_PS + 8 * n + 2 * t) = make_float2(c0[0], c0[1]);
          *reinterpret_cast<float2*>(rw + (g + 8) * MLA_PS + 8 * n + 2 * t) =
              make_float2(c0[2], c0[3]);
          *reinterpret_cast<float2*>(rw + g * MLA_PS + 8 * n + 8 + 2 * t) =
              make_float2(c1[0], c1[1]);
          *reinterpret_cast<float2*>(rw + (g + 8) * MLA_PS + 8 * n + 8 + 2 * t) =
              make_float2(c1[2], c1[3]);
        }
      }
    }
    __syncthreads();

    // ---- softmax: warp w rows w, w + 8; lane = token. The score order of
    // the plain version (dot, x k_scale, + q2.k2 x k2_scale, x scale, mask)
    {
      const bool on = t0 + lane < t_hi;
      const float ksc = a.ks ? ks_st[lane] : 1.f, k2sc = a.k2s ? k2s_st[lane] : 1.f;
      const float vsc = a.vs ? vs_st[lane] : 1.f;
#pragma unroll
      for (int j = 0; j < SR; ++j) {
        const int row = warp + MLA_WARPS * j;
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < MLA_WARPS; ++w) s += part[(w * ROWS + row) * MLA_PS + lane];
        s *= ksc;
        if (a.D2) {
          float s2 = 0.f;
#pragma unroll
          for (int w = 0; w < MLA_MAX_D2 / 16; ++w)
            if (w < L.kr) s2 += rpart[(w * ROWS + row) * MLA_PS + lane];
          s += s2 * k2sc;
        }
        const float x = on ? s * a.scale : NEG_INF;
        float tmax = x;
        for (int off = 16; off > 0; off >>= 1)
          tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
        const float mnew = fmaxf(m[j], tmax);
        const float alpha = __expf(m[j] - mnew);
        float p = on ? __expf(x - mnew) : 0.f;
        float psum = p;
        for (int off = 16; off > 0; off >>= 1) psum += __shfl_xor_sync(0xffffffffu, psum, off);
        l[j] = fmaf(l[j], alpha, psum);
        m[j] = mnew;
        p *= vsc;
        const bf16 hi = __float2bfloat16_rn(p);
        ph_s[row * MLA_PS + lane] = hi;
        pl_s[row * MLA_PS + lane] =
            round_p ? __float2bfloat16_rn(0.f) : __float2bfloat16_rn(p - __bfloat162float(hi));
        if (lane == 0) alpha_s[row] = alpha;
      }
    }
    __syncthreads();

    // ---- values: this warp's columns of V, all rows
    {
      const float al0 = alpha_s[g], al1 = alpha_s[g + 8];
      uint32_t ah[2][4], alo[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        ldsm(ah[j], ph_s + lr * MLA_PS + 16 * j + lc);
        ldsm(alo[j], pl_s + lr * MLA_PS + 16 * j + lc);
      }
#pragma unroll
      for (int np = 0; np < NW / 2; ++np) {
        float f[2][4] = {};
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          uint32_t vb[4];
          ldsm_t(vb, vt + (16 * j + lr) * vrow + 2 * (warp * CW + 16 * np + lc));
#pragma unroll
          for (int p = 0; p < 2; ++p) {
            float x[4], y[4];
            mma_bf16z(y, ah[j], vb[2 * p], vb[2 * p + 1]);
            if (round_p) {
#pragma unroll
              for (int e = 0; e < 4; ++e) f[p][e] += y[e];
            } else {
              mma_bf16z(x, alo[j], vb[2 * p], vb[2 * p + 1]);
#pragma unroll
              for (int e = 0; e < 4; ++e) f[p][e] += x[e] + y[e];
            }
          }
        }
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          float* oc = o[2 * np + p];
          oc[0] = fmaf(oc[0], al0, f[p][0]);
          oc[1] = fmaf(oc[1], al0, f[p][1]);
          oc[2] = fmaf(oc[2], al1, f[p][2]);
          oc[3] = fmaf(oc[3], al1, f[p][3]);
        }
      }
    }
  }
  cp_wait<0>();
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < SR; ++j) {
      m_s[warp + MLA_WARPS * j] = m[j];
      l_s[warp + MLA_WARPS * j] = l[j];
    }
  }
  __syncthreads();
  const long long prow = ((long long)split * a.B * H + bh) * a.G + g0;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int gr = g + 8 * hh;
    if (gr >= gt) continue;
    const float den = l_s[gr], dd = fmaxf(den, 1e-30f);
#pragma unroll
    for (int n = 0; n < NW; ++n) {
      const int d = warp * CW + 8 * n + 2 * t;   // this thread's two columns d, d + 1
      const float x0 = o[n][2 * hh], x1 = o[n][2 * hh + 1];
      if (a.splits > 1) {
        float* pa = a.part_acc + (prow + gr) * D + d;
        if (D % 2 == 0 && d < D)
          *reinterpret_cast<float2*>(pa) = make_float2(x0, x1);
        else if (d < D) {
          pa[0] = x0;
          if (d + 1 < D) pa[1] = x1;
        }
      } else if (d < D) {
        store_out(a.out, a.out_dtype, (qrow + gr) * D + d, x0 / dd);
        if (d + 1 < D) store_out(a.out, a.out_dtype, (qrow + gr) * D + d + 1, x1 / dd);
      }
    }
    if (a.splits > 1 && warp == 0 && t == 0)
      a.part_ml[(prow + gr) * 2] = m_s[gr], a.part_ml[(prow + gr) * 2 + 1] = den;
  }
}

// ---------------------------------------------------------------------------
// The MLA instance on the TF32 tensor cores (fp32 pages).

constexpr int MLA_TF32_PAD = 4;   // words past a staged fp32 row's columns: strides of 4 mod 32

// Blocks an SM the fp32 instance is laid out for: two at D 256 (shared
// memory then holds two stages a block, registers 128 a thread), one at 512.
template <int DP>
__host__ __device__ constexpr int mla_tf32_blocks() { return DP == 256 ? 2 : 1; }

// The block's shared memory in MlaTcLayout's fields (row and vrow in
// floats, the rest in bytes from its start): a ring of `stages` tiles of
// MLA_TT fp32 rows [c | k_rope] (the latents' DP columns, k_rope's D2 at
// column DP, the row rounded up to 32 floats plus MLA_TF32_PAD), then V's
// rows of DP + MLA_TF32_PAD floats where V is not K, then k_scale, v_scale
// and k2_scale; each warp's partial scores over its columns of c [rows]
// [MLA_PS] and, for warps w < D2 / 8, over k_rope's 8-wide step w; P's two
// TF32 parts [rows][MLA_PS]; each row's rescale, max and den; the slice's
// page ids. Strides of 4 mod 32 floats keep both products' B fragments on
// 32 banks (paged_mla_tf32_kernel).
__host__ __device__ inline MlaTcLayout mla_tf32_layout(int DP, int D2, bool sep_v,
                                                       int pages_per_split, int stages) {
  MlaTcLayout L;
  constexpr int rows = MLA_TC_ROWS, f = (int)sizeof(float);
  L.d2p = (D2 + 31) / 32 * 32;
  L.kr = D2 / 8;                              // k_rope's 8-wide steps: warps 0 .. kr - 1
  L.row = DP + L.d2p + MLA_TF32_PAD;
  L.vrow = DP + MLA_TF32_PAD;
  L.raw_row = L.row * f;
  L.raw_vrow = L.vrow * f;
  L.stage = MLA_TT * (L.raw_row + (sep_v ? L.raw_vrow : 0)) + 3 * MLA_TT * f;
  L.stages = stages;
  L.conv = L.part = stages * L.stage;
  L.rpart = L.part + MLA_WARPS * rows * MLA_PS * f;
  L.ph = L.rpart + L.kr * rows * MLA_PS * f;
  L.pl = L.ph + rows * MLA_PS * f;
  L.alpha = L.pl + rows * MLA_PS * f;
  L.m = L.alpha + rows * f;
  L.l = L.m + rows * f;
  L.pages = L.l + rows * f;
  L.total = L.pages + (pages_per_split + 3) / 4 * 16;
  return L;
}

// As many stages as fit, up to MLA_TC_STAGES, with room for the instance's
// blocks an SM (the SM's 228 KB less 1 KB a block); one where a separate V
// leaves room for no more.
template <int DP>
MlaTcLayout mla_tf32_fit(int D2, bool sep_v, int pps) {
  constexpr int room = mla_tf32_blocks<DP>() == 1 ? SMEM_MAX : 233472 / 2 - 1024;
  MlaTcLayout L = mla_tf32_layout(DP, D2, sep_v, pps, MLA_TC_STAGES);
  for (int st = MLA_TC_STAGES - 1; L.total > room && st >= 1; --st)
    L = mla_tf32_layout(DP, D2, sep_v, pps, st);
  return L;
}

// The A fragment (16 x 8: a0 (g, c + t), a1 (g + 8, c + t), a2 (g, c + t +
// 4), a3 (g + 8, c + t + 4)) of a query operand x [rows, D] of type Q, zero
// past `rows` and D, split in two TF32 parts. The loads are unconditional
// (clamped in range, then selected), as q_frags' are.
template <typename Q>
__device__ __forceinline__ void q_frag_tf32(flare::FragA& f, const Q* x, long long base, int ld,
                                            int rows, int c, int D) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float v[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = g + 8 * (i & 1), cc = c + t + 4 * (i >> 1);
    const float y = widen(x[base + (long long)min(r, rows - 1) * ld + min(cc, D - 1)]);
    v[i] = r < rows && cc < D ? y : 0.f;
  }
  flare::split_a(f, v[0], v[1], v[2], v[3]);
}

// P's A fragment of rows g, g + 8 over the tokens [8 kk, 8 kk + 8) in pair
// order (the k index t is token 2t, t + 4 is token 2t + 1: one float2 a row
// and part), from its hi and lo parts [rows][MLA_PS]
__device__ __forceinline__ void p_frag(flare::FragA& f, const float* ph, const float* pl, int kk) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int o0 = g * MLA_PS + 8 * kk + 2 * t, o1 = o0 + 8 * MLA_PS;
  const float2 h0 = *reinterpret_cast<const float2*>(ph + o0);
  const float2 h1 = *reinterpret_cast<const float2*>(ph + o1);
  const float2 l0 = *reinterpret_cast<const float2*>(pl + o0);
  const float2 l1 = *reinterpret_cast<const float2*>(pl + o1);
  const float hi[4] = {h0.x, h1.x, h0.y, h1.y}, lo[4] = {l0.x, l1.x, l0.y, l1.y};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f.hi[i] = __float_as_uint(hi[i]);
    f.lo[i] = __float_as_uint(lo[i]);
  }
}

// Grid (splits, B*H, row tiles): paged_mla_tc_kernel's blocks and phases
// over fp32 pages, the products on the TF32 tensor cores (mma.sync m16n8k8,
// flare_mma.cuh) with every operand in two TF32 parts, hi + lo, and three
// MMAs a product (lo.hi + hi.lo + hi.hi: about 2^-21 where one rounding
// leaves 2^-11): q and q2 split once into registers, the staged rows as each
// B fragment is read, P by the softmax. Each 8-wide step's hi.hi product
// starts from zero and is added to fp32 sums, the small terms summed in the
// tensor core (mma3_out: the tensor core truncates its additions).
//   * scores: warp w takes the columns [w DP / 8, +DP / 8) of c (and step w
//     of k_rope, w < D2 / 8): B fragments b0 = c[token g][col t], b1 =
//     c[g][t + 4], two scalar reads; partial S to shared memory, summed in
//     a fixed order by the softmax (warp w rows w and w + 8, lane t token t);
//   * values: warp w holds the fp32 accumulators of all rows for its
//     columns; P V contracts in pair order, so P's A fragment is one float2
//     a row and part and the B fragment b0 = v[token 2t][col g], b1 =
//     v[2t + 1][g]; a tile's P V goes into a fresh sum folded in once a tile.
// There is no 32-bit ldmatrix, and the scores read the tile along a row
// while P V reads it down the columns. With a row stride of 4 mod 32 floats
// both reads are conflict-free: the scores' lane (g, t) hits bank 4g + t,
// the values' 8t + g (pair order). The pair order for both (the scores'
// b0, b1 as one float2 at (g, 2t)) would want 8 mod 32, where the values'
// reads at (2t, g) are two-way conflicts.
template <int DP>
__global__ void __launch_bounds__(MLA_THREADS, mla_tf32_blocks<DP>())
    paged_mla_tf32_kernel(Args a) {
  using flare::FragA;
  using flare::mma3_out;
  using flare::split_b;
  constexpr int CW = DP / MLA_WARPS;   // columns of c a warp takes
  constexpr int KW = CW / 8;           // their 8-wide steps (the scores' k)
  constexpr int NW = CW / 8;           // their 8-wide tiles (the values' n)
  constexpr int NT = MLA_TT / 8;       // 8-token tiles of a staged tile (S's n, P V's k)
  constexpr int ROWS = MLA_TC_ROWS;
  constexpr int SR = ROWS / MLA_WARPS; // softmax rows a warp
  extern __shared__ uint4 smem4[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem4);

  const int D = a.D, blk = a.block, H = a.H;
  const bool sep_v = a.v != a.k;
  const MlaTcLayout L = mla_tf32_layout(DP, a.D2, sep_v, a.pages_per_split, a.stages);
  float* part = reinterpret_cast<float*>(smem + L.part);
  float* rpart = reinterpret_cast<float*>(smem + L.rpart);
  float* ph_s = reinterpret_cast<float*>(smem + L.ph);
  float* pl_s = reinterpret_cast<float*>(smem + L.pl);
  float* alpha_s = reinterpret_cast<float*>(smem + L.alpha);
  float* m_s = reinterpret_cast<float*>(smem + L.m);
  float* l_s = reinterpret_cast<float*>(smem + L.l);
  int* pages = reinterpret_cast<int*>(smem + L.pages);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int split = blockIdx.x, bh = blockIdx.y, b = bh / H, h = bh % H;
  const int g0 = blockIdx.z * a.rows, gt = min(a.rows, a.G - g0);
  const long long qrow = (long long)bh * a.G + g0;
  const int* ptb = a.pt + (long long)b * a.P;
  const int len = a.lengths[b];
  const int2 sl = lane_slice(a, len, split);
  const int t_lo = sl.x, t_hi = sl.y;
  const int ntiles = t_hi > t_lo ? (t_hi - t_lo + MLA_TT - 1) / MLA_TT : 0;
  const int p0 = t_lo / blk, p1 = t_hi > t_lo ? (t_hi + blk - 1) / blk : p0;
  const int S = L.stages;
  for (int i = threadIdx.x; i < p1 - p0; i += MLA_THREADS) pages[i] = ptb[p0 + i];
  // the columns past D of the staged rows are zero, never written by a copy
  // (both products read them)
  if (D < DP) {
    for (int i = threadIdx.x; i < S * L.stage / 16; i += MLA_THREADS)
      smem4[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();   // page ids and zero fill
  for (int s = 0; s < S - 1; ++s) {
    if (s < ntiles)
      issue_mla_tc_tile<float>(smem + s * L.stage, a, pages, p0, t_lo + s * MLA_TT, t_hi, h, L,
                               sep_v);
    cp_commit();
  }
  // q's fragments of this warp's columns and q2's of its step of k_rope
  // (their loads in flight with the first tiles')
  FragA qf[KW], qr;
  auto load_frags = [&](auto* q, auto* q2) {
#pragma unroll
    for (int kk = 0; kk < KW; ++kk) q_frag_tf32(qf[kk], q, qrow * D, D, gt, warp * CW + 8 * kk, D);
    if (warp < L.kr) q_frag_tf32(qr, q2, qrow * a.D2, a.D2, gt, 8 * warp, a.D2);
  };
  if (a.q_dtype == F32)
    load_frags(static_cast<const float*>(a.q), static_cast<const float*>(a.q2));
  else
    load_frags(static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.q2));

  float m[SR], l[SR];
#pragma unroll
  for (int j = 0; j < SR; ++j) m[j] = NEG_INF, l[j] = 0.f;
  float o[NW][4];
#pragma unroll
  for (int n = 0; n < NW; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    const int t0 = t_lo + it * MLA_TT;
    if (S == 1) {   // one stage: the previous tile's reads done, then this tile's copies
      __syncthreads();
      issue_mla_tc_tile<float>(smem, a, pages, p0, t0, t_hi, h, L, sep_v);
      cp_commit();
    }
    if (S == 4)
      cp_wait<2>();
    else if (S == 3)
      cp_wait<1>();
    else
      cp_wait<0>();
    __syncthreads();   // tile `it` has landed for all; the previous tile's reads are done
    if (S > 1) {
      if (it + S - 1 < ntiles)
        issue_mla_tc_tile<float>(smem + ((it + S - 1) % S) * L.stage, a, pages, p0,
                                 t0 + (S - 1) * MLA_TT, t_hi, h, L, sep_v);
      cp_commit();
    }
    const unsigned char* st = smem + (it % S) * L.stage;
    const float* ks_st = reinterpret_cast<const float*>(
        st + MLA_TT * (L.raw_row + (sep_v ? L.raw_vrow : 0)));
    const float* vs_st = ks_st + MLA_TT;
    const float* k2s_st = vs_st + MLA_TT;
    const float* kt = reinterpret_cast<const float*>(st);   // rows [c | k_rope], L.row apart
    const float* vt = sep_v ? reinterpret_cast<const float*>(st + MLA_TT * L.raw_row) : kt;
    const int vrow = sep_v ? L.vrow : L.row;

    // ---- partial scores over this warp's columns (and its k_rope step)
    {
      float sc[NT][4], cs[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[n][e] = cs[n][e] = 0.f;
      const float* kb = kt + g * L.row + warp * CW + t;
#pragma unroll
      for (int kk = 0; kk < KW; ++kk)
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const float* x = kb + 8 * n * L.row + 8 * kk;
          mma3_out(sc[n], cs[n], qf[kk], split_b(x[0], x[4]));
        }
      float* pw = part + warp * ROWS * MLA_PS;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        *reinterpret_cast<float2*>(pw + g * MLA_PS + 8 * n + 2 * t) =
            make_float2(sc[n][0] + cs[n][0], sc[n][1] + cs[n][1]);
        *reinterpret_cast<float2*>(pw + (g + 8) * MLA_PS + 8 * n + 2 * t) =
            make_float2(sc[n][2] + cs[n][2], sc[n][3] + cs[n][3]);
      }
      if (warp < L.kr) {
        const float* rb = kt + g * L.row + DP + 8 * warp + t;
        float* rw = rpart + warp * ROWS * MLA_PS;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          float r[4] = {0.f, 0.f, 0.f, 0.f}, rc[4] = {0.f, 0.f, 0.f, 0.f};
          const float* x = rb + 8 * n * L.row;
          mma3_out(r, rc, qr, split_b(x[0], x[4]));
          *reinterpret_cast<float2*>(rw + g * MLA_PS + 8 * n + 2 * t) =
              make_float2(r[0] + rc[0], r[1] + rc[1]);
          *reinterpret_cast<float2*>(rw + (g + 8) * MLA_PS + 8 * n + 2 * t) =
              make_float2(r[2] + rc[2], r[3] + rc[3]);
        }
      }
    }
    __syncthreads();

    // ---- softmax: warp w rows w, w + 8; lane = token. The score order of
    // the plain version (dot, x k_scale, + q2.k2 x k2_scale, x scale, mask)
    {
      const bool on = t0 + lane < t_hi;
      const float ksc = a.ks ? ks_st[lane] : 1.f, k2sc = a.k2s ? k2s_st[lane] : 1.f;
      const float vsc = a.vs ? vs_st[lane] : 1.f;
#pragma unroll
      for (int j = 0; j < SR; ++j) {
        const int row = warp + MLA_WARPS * j;
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < MLA_WARPS; ++w) s += part[(w * ROWS + row) * MLA_PS + lane];
        s *= ksc;
        if (a.D2) {
          float s2 = 0.f;
#pragma unroll
          for (int w = 0; w < MLA_MAX_D2 / 8; ++w)
            if (w < L.kr) s2 += rpart[(w * ROWS + row) * MLA_PS + lane];
          s += s2 * k2sc;
        }
        const float x = on ? s * a.scale : NEG_INF;
        float tmax = x;
        for (int off = 16; off > 0; off >>= 1)
          tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
        const float mnew = fmaxf(m[j], tmax);
        const float alpha = __expf(m[j] - mnew);
        float p = on ? __expf(x - mnew) : 0.f;
        float psum = p;
        for (int off = 16; off > 0; off >>= 1) psum += __shfl_xor_sync(0xffffffffu, psum, off);
        l[j] = fmaf(l[j], alpha, psum);
        m[j] = mnew;
        p *= vsc;
        const uint32_t hi = flare::tf32(p);
        ph_s[row * MLA_PS + lane] = __uint_as_float(hi);
        pl_s[row * MLA_PS + lane] = __uint_as_float(flare::tf32(p - __uint_as_float(hi)));
        if (lane == 0) alpha_s[row] = alpha;
      }
    }
    __syncthreads();

    // ---- values: this warp's columns of V, all rows
    {
      const float al0 = alpha_s[g], al1 = alpha_s[g + 8];
      FragA pf[NT];
#pragma unroll
      for (int kk = 0; kk < NT; ++kk) p_frag(pf[kk], ph_s, pl_s, kk);
      const float* vb = vt + 2 * t * vrow + warp * CW + g;
#pragma unroll
      for (int n = 0; n < NW; ++n) {
        float f[4] = {0.f, 0.f, 0.f, 0.f}, fc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int kk = 0; kk < NT; ++kk) {
          const float* x = vb + 8 * kk * vrow + 8 * n;
          mma3_out(f, fc, pf[kk], split_b(x[0], x[vrow]));
        }
        o[n][0] = fmaf(o[n][0], al0, f[0] + fc[0]);
        o[n][1] = fmaf(o[n][1], al0, f[1] + fc[1]);
        o[n][2] = fmaf(o[n][2], al1, f[2] + fc[2]);
        o[n][3] = fmaf(o[n][3], al1, f[3] + fc[3]);
      }
    }
  }
  cp_wait<0>();
  // the end as paged_mla_tc_kernel's (written out in each: a helper shared by
  // both spills the bf16 instance's registers at D 256)
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < SR; ++j) {
      m_s[warp + MLA_WARPS * j] = m[j];
      l_s[warp + MLA_WARPS * j] = l[j];
    }
  }
  __syncthreads();
  const long long prow = ((long long)split * a.B * H + bh) * a.G + g0;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int gr = g + 8 * hh;
    if (gr >= gt) continue;
    const float den = l_s[gr], dd = fmaxf(den, 1e-30f);
#pragma unroll
    for (int n = 0; n < NW; ++n) {
      const int d = warp * CW + 8 * n + 2 * t;   // this thread's two columns d, d + 1
      const float x0 = o[n][2 * hh], x1 = o[n][2 * hh + 1];
      if (a.splits > 1) {
        float* pa = a.part_acc + (prow + gr) * D + d;
        if (D % 2 == 0 && d < D)
          *reinterpret_cast<float2*>(pa) = make_float2(x0, x1);
        else if (d < D) {
          pa[0] = x0;
          if (d + 1 < D) pa[1] = x1;
        }
      } else if (d < D) {
        store_out(a.out, a.out_dtype, (qrow + gr) * D + d, x0 / dd);
        if (d + 1 < D) store_out(a.out, a.out_dtype, (qrow + gr) * D + d + 1, x1 / dd);
      }
    }
    if (a.splits > 1 && warp == 0 && t == 0)
      a.part_ml[(prow + gr) * 2] = m_s[gr], a.part_ml[(prow + gr) * 2 + 1] = den;
  }
}

// ---------------------------------------------------------------------------

// One thread an output element (b, h, g, d): merge the slices in order, in
// one pass with a running max (every slice's loads independent of the sums).
__global__ void paged_combine_kernel(Args a) {
  const long long n = (long long)a.B * a.H * a.G * a.D;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long row = i / a.D, stride = (long long)a.B * a.H * a.G;
  float mx = NEG_INF, den = 0.f, num = 0.f;
#pragma unroll 8
  for (int s = 0; s < a.splits; ++s) {
    const long long r = s * stride + row;
    const float ms = a.part_ml[r * 2], ls = a.part_ml[r * 2 + 1];
    const float xs = a.part_acc[r * a.D + i % a.D];
    const float mnew = fmaxf(mx, ms);
    const float wa = __expf(mx - mnew), wb = __expf(ms - mnew);
    den = fmaf(den, wa, ls * wb);
    num = fmaf(num, wa, xs * wb);
    mx = mnew;
  }
  store_out(a.out, a.out_dtype, i, num / fmaxf(den, 1e-30f));
}

// D's padded width: the next power of two from 8 to 128 (0 above 128).
int padded_width(int D) {
  int dp = 8;
  while (dp < D) dp *= 2;
  return D <= 128 ? dp : 0;
}

bool use_encode(int G, int D, int D2) { return D2 == 0 && D <= ENC_MAX_D && G >= ENC_MIN_G; }

bool use_mla(int D) { return D > 128; }

// The instance a call runs, numbered as kernels/paged_attention.py's ROUTES:
// the entry point dispatches on it and reports it to the caller.
enum Route { DECODE = 0, ENCODE = 1, MLA_TC = 2, MLA_TF32 = 3 };
int route_of(int G, int D, int D2, int page_dtype) {
  if (use_mla(D)) return page_dtype == F32 ? MLA_TF32 : MLA_TC;
  return use_encode(G, D, D2) ? ENCODE : DECODE;
}

int row_tiles(int G) { return (G + ROWS_MAX - 1) / ROWS_MAX; }

// The MLA instances' padded width of D, and row tiles of G (each tile
// reads the lane's latents once more): both take 16 rows a block (one m16
// tile) at both widths.
int mla_dp(int D) { return D <= 256 ? 256 : 512; }
int mla_row_tiles(int G) { return (G + MLA_TC_ROWS - 1) / MLA_TC_ROWS; }

cudaError_t combine(const Args& a, cudaStream_t stream) {
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.splits == 1) return err;
  const long long n = (long long)a.B * a.H * a.G * a.D;
  paged_combine_kernel<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int GTM>
cudaError_t launch_decode(const Args& a, cudaStream_t stream) {
  const int bytes = decode_smem_bytes<T, GTM>(a.D, a.DP, a.pages_per_split);
  cudaError_t err = cudaFuncSetAttribute(paged_decode_kernel<T, GTM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  paged_decode_kernel<T, GTM>
      <<<dim3(a.splits, a.B * a.H, row_tiles(a.G)), THREADS, bytes, stream>>>(a);
  return combine(a, stream);
}

template <typename T>
cudaError_t decode_rows(const Args& a, cudaStream_t stream) {
  if (a.rows <= 1) return launch_decode<T, 1>(a, stream);
  if (a.rows <= 2) return launch_decode<T, 2>(a, stream);
  if (a.rows <= 4) return launch_decode<T, 4>(a, stream);
  if (a.rows <= 6) return launch_decode<T, 6>(a, stream);
  return launch_decode<T, 8>(a, stream);
}

template <int DP>
cudaError_t launch_encode(const Args& a, cudaStream_t stream) {
  const bool plain = !a.ks && !a.vs && a.scale == 1.f && (a.fused || a.page_dtype != BF16);
  const dim3 grid(a.splits, a.B * a.H, (a.G + THREADS - 1) / THREADS);
  if (plain)
    paged_encode_kernel<DP, true><<<grid, THREADS, 0, stream>>>(a);
  else
    paged_encode_kernel<DP, false><<<grid, THREADS, 0, stream>>>(a);
  return combine(a, stream);
}

template <typename T, int DP>
cudaError_t launch_mla_tc(Args a, cudaStream_t stream) {
  const MlaTcLayout L = mla_tc_fit(sizeof(T), DP, a.D2, a.v != a.k, a.pages_per_split);
  if (L.total > SMEM_MAX) return cudaErrorInvalidValue;
  a.stages = L.stages;
  cudaError_t err = cudaFuncSetAttribute(paged_mla_tc_kernel<T, DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
  if (err != cudaSuccess) return err;
  paged_mla_tc_kernel<T, DP><<<dim3(a.splits, a.B * a.H, mla_row_tiles(a.G)), MLA_THREADS,
                               L.total, stream>>>(a);
  return combine(a, stream);
}

template <int DP>
cudaError_t launch_mla_tf32(Args a, cudaStream_t stream) {
  const MlaTcLayout L = mla_tf32_fit<DP>(a.D2, a.v != a.k, a.pages_per_split);
  if (L.total > SMEM_MAX) return cudaErrorInvalidValue;
  a.stages = L.stages;
  cudaError_t err = cudaFuncSetAttribute(paged_mla_tf32_kernel<DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
  if (err != cudaSuccess) return err;
  paged_mla_tf32_kernel<DP><<<dim3(a.splits, a.B * a.H, mla_row_tiles(a.G)), MLA_THREADS,
                              L.total, stream>>>(a);
  return combine(a, stream);
}

template <typename T>
cudaError_t mla_tc(const Args& a, cudaStream_t stream) {
  return mla_dp(a.D) == 512 ? launch_mla_tc<T, 512>(a, stream) : launch_mla_tc<T, 256>(a, stream);
}

// MLA blocks of `kernel` the card runs at once with `smem` bytes of shared
// memory a block.
template <typename Kernel>
int mla_wave_of(Kernel kernel, int smem) {
  int per_sm = 0, dev = 0, sms = 0;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, MLA_THREADS, smem) !=
          cudaSuccess ||
      cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 132;
  return (per_sm > 0 ? per_sm : 1) * sms;
}

// The wave of the MLA instance for page dtype T (K read as V).
template <typename T>
int mla_tc_wave(int D, int D2, int P) {
  const int smem = mla_tc_fit(sizeof(T), mla_dp(D), D2, false, P).total;
  return mla_dp(D) == 512 ? mla_wave_of(paged_mla_tc_kernel<T, 512>, smem)
                          : mla_wave_of(paged_mla_tc_kernel<T, 256>, smem);
}

int mla_tf32_wave(int D, int D2, int P) {
  if (mla_dp(D) == 512)
    return mla_wave_of(paged_mla_tf32_kernel<512>, mla_tf32_fit<512>(D2, false, P).total);
  return mla_wave_of(paged_mla_tf32_kernel<256>, mla_tf32_fit<256>(D2, false, P).total);
}

// Decode blocks the card runs at once: the instance's blocks a
// multiprocessor (registers, and shared memory with room for every page id
// of a lane) times the multiprocessors of the current device.
template <typename T, int GTM>
int wave_of(int D, int P) {
  const int bytes = decode_smem_bytes<T, GTM>(D, padded_width(D), P);
  int per_sm = 0, dev = 0, sms = 0;
  if (cudaFuncSetAttribute(paged_decode_kernel<T, GTM>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, bytes) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, paged_decode_kernel<T, GTM>,
                                                    THREADS, bytes) != cudaSuccess ||
      cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return TARGET_BLOCKS;
  return per_sm * sms;
}

template <typename T>
int wave_rows(int rows, int D, int P) {
  if (rows <= 1) return wave_of<T, 1>(D, P);
  if (rows <= 2) return wave_of<T, 2>(D, P);
  if (rows <= 4) return wave_of<T, 4>(D, P);
  if (rows <= 6) return wave_of<T, 6>(D, P);
  return wave_of<T, 8>(D, P);
}

// The wave of (page dtype, rows a block, D, D2, P) of the decode or the MLA
// instance, computed once per key and device (a decode step asks for it on
// every layer).
int decode_wave(int G, int D, int D2, int P, int page_dtype) {
  struct Entry {
    int dev, dtype, rows, D, D2, P, wave;
  };
  static Entry cache[64];
  static int used = 0;
  static std::mutex lock;
  const bool mla = use_mla(D);
  const int tiles = mla ? mla_row_tiles(G) : row_tiles(G);
  const int rows = (G + tiles - 1) / tiles;
  const int key_d2 = mla ? D2 : 0;
  int dev = 0;
  cudaGetDevice(&dev);
  std::lock_guard<std::mutex> hold(lock);
  for (int i = 0; i < used; ++i) {
    const Entry& e = cache[i];
    if (e.dev == dev && e.dtype == page_dtype && e.rows == rows && e.D == D && e.D2 == key_d2 &&
        e.P == P)
      return e.wave;
  }
  int wave;
  if (mla) {
    switch (page_dtype) {
      case F32:
        wave = mla_tf32_wave(D, D2, P);
        break;
      case BF16: wave = mla_tc_wave<__nv_bfloat16>(D, D2, P); break;
      case I8: wave = mla_tc_wave<int8_t>(D, D2, P); break;
      default: wave = mla_tc_wave<__nv_fp8_e4m3>(D, D2, P);
    }
  } else {
    switch (page_dtype) {
      case F32: wave = wave_rows<float>(rows, D, P); break;
      case BF16: wave = wave_rows<__nv_bfloat16>(rows, D, P); break;
      case I8: wave = wave_rows<int8_t>(rows, D, P); break;
      default: wave = wave_rows<__nv_fp8_e4m3>(rows, D, P);
    }
  }
  cache[used < 64 ? used++ : dev % 64] = Entry{dev, page_dtype, rows, D, key_d2, P, wave};
  return wave;
}

}  // namespace

extern "C" {

// Page slices of a call: the caller sizes the fp32 partials, part_acc
// [splits, B*H, G, D] and part_ml [splits, B*H, G, 2], from it. From the
// shapes and the card only, never the lengths. The decode instance: one
// wave of blocks (as many as the card holds at once), at least MIN_PAGES
// pages a slice; the encode instance: about ENC_WAVE blocks, at least
// ENC_MIN_TOKENS tokens a slice.
int paged_attention_splits(int B, int H, int G, int D, int D2, int block, int P,
                           int page_dtype) {
  if (D < 1 || D > 512 || B * H < 1 || G < 1) return 1;
  long long want, most;
  if (use_encode(G, D, D2)) {
    want = ENC_WAVE / ((long long)B * H * ((G + THREADS - 1) / THREADS));
    most = (long long)P * block / ENC_MIN_TOKENS;
  } else {
    const long long tiles =
        (long long)B * H * (use_mla(D) ? mla_row_tiles(G) : row_tiles(G));
    want = decode_wave(G, D, D2, P, page_dtype) / tiles;
    most = P / MIN_PAGES;
  }
  if (want > most) want = most;
  if (want > 65535) want = 65535;
  return (int)(want < 1 ? 1 : want);
}

// q [B, H, G, D] (fp32 / bf16, q2 likewise with D2, or null and D2 = 0);
// pages [NB, block, H, D] of page_dtype (k2 with D2); scales [NB, block, H]
// fp32 or null; out [B, H, G, D] of out_dtype. All contiguous, pages 16-byte
// aligned; 1 <= D <= 512, D2 a multiple of 8 up to 128 (up to 64 where D >
// 128); splits from paged_attention_splits. Writes the instance it launched
// (a Route) to *route.
int paged_attention(const void* q, const void* q2, const void* k, const void* v, const void* k2,
                    const int* page_table, const int* lengths, const float* k_scale,
                    const float* v_scale, const float* k2_scale, void* out, float* part_acc,
                    float* part_ml, int B, int H, int G, int D, int D2, int block, int P,
                    int splits, float scale, int q_dtype, int page_dtype, int out_dtype,
                    int fused, void* stream, int* route) {
  const bool mla = use_mla(D);
  if (D < 1 || D > 512 || D2 < 0 || D2 > (mla ? MLA_MAX_D2 : 128) || D2 % 8 || splits < 1 ||
      G < 1)
    return cudaErrorInvalidValue;
  const int tiles = mla ? mla_row_tiles(G) : row_tiles(G);
  Args a{q, q2, k, v, k2, page_table, lengths, k_scale, v_scale, k2_scale, out, part_acc,
         part_ml, B, H, G, D, mla ? mla_dp(D) : padded_width(D), D2, block, P, splits,
         (P + splits - 1) / splits, (G + tiles - 1) / tiles, scale, q_dtype, page_dtype,
         out_dtype, fused};
  cudaStream_t s = (cudaStream_t)stream;
  if (page_dtype < F32 || page_dtype > FP8) return cudaErrorInvalidValue;
  *route = route_of(G, D, D2, page_dtype);
  if (*route == MLA_TF32)
    return a.DP == 512 ? launch_mla_tf32<512>(a, s) : launch_mla_tf32<256>(a, s);
  if (*route == MLA_TC) {
    switch (page_dtype) {
      case BF16: return mla_tc<__nv_bfloat16>(a, s);
      case I8: return mla_tc<int8_t>(a, s);
      default: return mla_tc<__nv_fp8_e4m3>(a, s);
    }
  }
  if (*route == ENCODE)
    return a.DP == 8 ? launch_encode<8>(a, s) : a.DP == 16 ? launch_encode<16>(a, s)
                                                           : launch_encode<32>(a, s);
  switch (page_dtype) {
    case F32: return decode_rows<float>(a, s);
    case BF16: return decode_rows<__nv_bfloat16>(a, s);
    case I8: return decode_rows<int8_t>(a, s);
    default: return decode_rows<__nv_fp8_e4m3>(a, s);
  }
}

}  // extern "C"
