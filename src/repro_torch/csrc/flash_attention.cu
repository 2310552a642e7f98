// Flash attention for Hopper (sm_90a), CUDA C++: the fp32 route on the TF32
// tensor cores, and the bf16 calls the wgmma kernel does not take on the
// bf16 tensor cores through mma.sync.
//
// Replaces the TPU kernel of the JAX package:
//   flash_tf32_kernel, flash_bf16_kernel
//       <- repro/kernels/attention.py::_flash_kernel (flash_attention_pallas)
// beside flash_attention_sm90.cu (flash_tc_kernel), which runs every bf16
// call whose D is a multiple of 8 and whose strides TMA can address.
// kernels/attention.py::flash_route picks from dtype, D and strides alone:
// fp32 runs flash_tf32_kernel; bf16 at D % 8 != 0 or strides or bases TMA
// cannot address runs flash_bf16_kernel.
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
// (:41-45) solved for the tile index (live_tiles): a causal block stops at
// its last live tile, a windowed block starts at its first. Both kernels
// share the tile bounds, the dead-warp test and the online softmax
// (online_softmax: base 2 on scale * log2(e) scores, exp2f one MUFU op an
// exp, masked weights zeroed, two-level den parts). The grid is (B * H,
// ceil(Sq / 128)) with the query tiles longest first (block y takes tile
// n - 1 - y, the causal tail), so B * H may reach 2^31 - 1.
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
// ---- flash_bf16_kernel: bf16 on the tensor cores off TMA's route ----------
//
// The bf16 calls flash_tc_kernel does not take: D % 8 != 0 (any D from 1 to
// 128), or strides or bases TMA cannot address (a view off 16 bytes).
// What bounds it: the two products, 4 * D FLOP a kept (query, key) pair:
// 3.30 TFLOP at qwen2-1.5b's prefill_32k layer 0 (the figures above), 3.335
// ms at the bf16 tensor-core peak; with P in two parts (below) the products
// as issued are 4.95 TFLOP, 5.0 ms at 989 TFLOP/s and 7.8 ms at mma.sync's
// measured bf16 rate (635 TFLOP/s, scripts/torch_mma_rate.py); the exps ~1.5
// ms. Its predecessor ran in fp32 on the CUDA cores (131.6 ms on an NVIDIA
// H100 80GB HBM3 at 700 W). With mma.sync every B fragment comes from shared
// memory through ldmatrix, so shared-memory reads rival the MMAs. The
// design, flash_tf32_kernel's tile loop on the bf16 MMA:
//   * Products. mma.sync m16n8k16, bf16 in and fp32 accumulate. q, K and V
//     are bf16 values, exact: S = Q K^T is one MMA a 16-wide step, summed
//     over D in the tensor core, as flash_tc_kernel's wgmma does. The
//     weights are not bf16 values: P = P_hi + P_lo, P_hi = bf16(p),
//     P_lo = bf16(p - P_hi), two MMAs into one accumulator, which leaves
//     ~2^-18 of p; one rounding (the TPU kernel's :75) moves o by ~2^-9 of
//     |v| and misses the check beyond bf16's output rounding against fp64.
//     P V takes P as the A operand straight from S's accumulator (the two
//     layouts coincide), so P never touches shared memory.
//   * Blocks. 4 warps of 32 query rows (BQ = 128): a warp's two 16-row
//     m-tiles share every K and V fragment it reads, which halves the
//     shared-memory reads a product against one m-tile a warp (8 warps of 16
//     rows took 27.4 ms at qwen2's layer 0 on that H100, this 23.3:
//     PERF.md). O (DP registers a thread), S and the two P parts fill the
//     registers; 104 KB of shared memory at DP 128, two blocks an SM. A warp
//     all of whose rows a tile masks skips its products; only tiles a mask
//     crosses test pairs.
//   * Fragments by ldmatrix from padded rows of DP + 8 elements (an odd
//     number of 16-byte units, so the eight rows of each 8 x 8 matrix hit
//     eight bank groups): Q as A fragments each step, K as [n][k] B
//     fragments, V through .trans.
//   * Staging. Only the device-memory side is unaligned; shared memory is
//     laid out by the kernel. A row goes in pieces of `unit` bytes, the
//     widest of 16, 8 and 4 that divides 2 D, every stride and every base
//     (flash_route's off-TMA calls: D = 100 or a base off by 8 bytes take 8,
//     a row stride of 60 bytes 4), by cp.async, rows past Skv (or Sq) zero-filled
//     and nothing read for them; an odd D (unit 2) goes through registers.
//     K and V tiles of BK = 64 keys are double-buffered: the next tile is in
//     flight while this one computes, one barrier a tile. Lanes past D stay
//     as the kernel zeroed them at its start.
//   * Precision: two-level sums. A tile's P V goes into a fresh accumulator,
//     16 columns at a time, folded into the carried O once a tile (a
//     carried sum takes 512 additions at S = 32,768), and each thread's den
//     part likewise.
//   * Widths. D up to 128 at the padded widths DP in {16, 32, 64, 96, 128}.
//
// The entry points launch on the given stream, allocate nothing, and
// return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flare_mma.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

struct Args {
  const void* q;   // [B, H, Sq, D] by strides, unit D stride (fp32 or bf16 by kernel)
  const void* k;   // [B, H, Skv, D]
  const void* v;
  void* o;         // [B, H, Sq, D], v's dtype
  int B, H, group, Sq, Skv, D;   // group = H / Hkv: query heads a KV head
  long long q_b, q_h, q_s, k_b, k_h, k_s, v_b, v_h, v_s, o_b, o_h, o_s;
  float scale;
  int causal, window;   // window < 0: no window
  int unit;             // bytes a copy of q, k, v rows: it divides each row, stride and base
};

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// This thread's copies of all but the newest N groups have landed (and are
// visible to it).
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}


// The live key tiles [x, y) of a block's query rows [q0, q0 + BQ): the TPU
// kernel's skip test (:41-45) solved for the tile index.
template <int BQ, int BK>
__device__ __forceinline__ int2 live_tiles(const Args& a, int q0) {
  int end = (a.Skv + BK - 1) / BK;
  if (a.causal) end = min(end, (q0 + BQ - 1) / BK + 1);
  int begin = 0;
  if (a.window >= 0) {
    const long long lo = (long long)q0 - a.window - BK + 2;   // the least live k_start
    if (lo > 0) begin = (int)min((long long)end, (lo + BK - 1) / BK);
  }
  return make_int2(begin, end);
}

// Whether the masks drop every pair of a warp's rows [R0, R0 + ROWS) and
// the key tile [k0, k0 + BK): such a warp computes nothing.
template <int BK, int ROWS = 16>
__device__ __forceinline__ bool dead_rows(const Args& a, int k0, int R0) {
  return R0 >= a.Sq || (a.causal && k0 > R0 + ROWS - 1) ||
         (a.window >= 0 && (long long)k0 + BK - 1 <= (long long)R0 - a.window);
}

// One key tile of the online softmax, for a warp's rows r0 = R0 + g and
// r1 = r0 + 8 (g = lane / 4, t = lane % 4): s holds their scores against
// NT n-tiles of 8 keys from k0 (element e of n-tile n: row e < 2 ? r0 : r1,
// key k0 + 8n + 2t + (e & 1)). They are scaled to base 2, masked (-1e30)
// where a mask crosses the tile, and become the weights (masked ones exactly
// 0); the rows' max (m0, m1, over the quad) and den parts (l0, l1, this
// thread's, a tile's part formed apart and added once) are carried, and
// al0, al1 are the rescale of what came before.
template <int NT>
__device__ __forceinline__ void online_softmax(float (&s)[NT][4], const Args& a, int k0, int R0,
                                               float scale2, float& m0, float& m1, float& l0,
                                               float& l1, float& al0, float& al1) {
  static_assert(NT <= 8, "a bit of `keep` an element");
  const int t = threadIdx.x & 3, r0 = R0 + ((threadIdx.x & 31) >> 2), r1 = r0 + 8;
  const bool whole = k0 + 8 * NT <= a.Skv && (!a.causal || k0 + 8 * NT - 1 <= R0) &&
                     (a.window < 0 || (long long)k0 > (long long)R0 + 15 - a.window);
  uint32_t keep = 0xffffffffu;
  float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
  for (int n = 0; n < NT; ++n)
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
  al0 = exp2f(m0 - n0);
  al1 = exp2f(m1 - n1);
  m0 = n0;
  m1 = n1;
  float ts0 = 0.f, ts1 = 0.f;
#pragma unroll
  for (int n = 0; n < NT; ++n)
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
}

// ---------------------------------------------------------------------------
// flash_tf32_kernel: fp32 on the TF32 tensor cores (the head comment).

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
      dst[t] = flare::split_b(x[t], x[t + 4]);
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
    for (int g = 0; g < 8; ++g) dst[4 * g] = flare::split_b(ra[g], rb[g]);
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
  const bool vec = a.unit == 16;
  const float scale2 = a.scale * LOG2E;   // the softmax in base 2: one MUFU op an exp

  const int2 live = live_tiles<TBQ, TBK>(a, q0);
  const int t_begin = live.x, ntiles = live.y - live.x;
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

    float s[T_NT][4];
    if (!dead_rows<TBK>(a, k0, R0)) {
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
        for (int n = 0; n < T_NT; ++n)
          flare::mma3_out(s[n], cs[n], qf, sk[(n * KS + kk) * 32 + lane]);
      }
#pragma unroll
      for (int n = 0; n < T_NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] += cs[n][e];
      float al0, al1;
      online_softmax(s, a, k0, R0, scale2, m0, m1, l0, l1, al0, al1);
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

// ---------------------------------------------------------------------------
// flash_bf16_kernel: bf16 on the tensor cores off TMA's route (the head
// comment).

using bf16 = __nv_bfloat16;
using flare::ldsm;
using flare::ldsm_t;
using flare::mma_bf16;
using flare::split_bf16;

constexpr int BBQ = 128;              // query rows a block
constexpr int BBK = 64;               // keys a tile
constexpr int B_MT = 2;               // 16-row m-tiles a warp: 4 warps, two blocks an SM
constexpr int B_THREADS = 32 * BBQ / (16 * B_MT);
constexpr int B_NT = BBK / 8;         // 8-key n-tiles of S a tile

template <int DP>
struct Bf16Layout {   // shared memory, in bf16 elements
  static constexpr int DS = DP + 8;              // row stride: an odd number of 16-byte units
  static constexpr int Q = 0;                    // q [BBQ][DS]
  static constexpr int K = Q + BBQ * DS;         // k, two buffers [2][BBK][DS]
  static constexpr int V = K + 2 * BBK * DS;     // v, two buffers [2][BBK][DS]
  static constexpr int END = V + 2 * BBK * DS;
  static constexpr int BYTES = END * 2;          // 104 KB at DP 128
};

// Rows [0, R) of a padded tile dst[r * DS + d] from a strided bf16 operand
// (row stride `stride`, D elements a row, `rows` of them valid): by cp.async
// in pieces of `unit` bytes where unit >= 4, rows past `rows` zero-filled
// and nothing read for them; else through registers, two bytes at a time.
// Lanes D <= d < DP are not written. Thread i takes pieces i, i + threads,
// ... of the tile, its (row, piece) stepped without a division a piece.
template <int DS, int R>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src, long long stride,
                                           int rows, int D, int unit) {
  const int per = unit >= 4 ? unit / 2 : 1, pieces = D / per;   // elements a piece, pieces a row
  const int dr = B_THREADS / pieces, dc = B_THREADS - dr * pieces;
  int r = threadIdx.x / pieces, c = threadIdx.x - r * pieces;
  for (; r < R; r += dr, c += dc) {
    if (c >= pieces) {
      c -= pieces;
      if (++r >= R) break;
    }
    const bool on = r < rows;
    const int e = c * per;
    if (unit < 4) {
      dst[r * DS + e] = on ? src[r * stride + e] : __float2bfloat16(0.f);
      continue;
    }
    const bf16* from = on ? src + r * stride + e : src;
    const uint32_t to = flare::smem_addr(dst + r * DS + e);
    if (unit == 16)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(to), "l"(from),
                   "r"(on ? 16 : 0));
    else if (unit == 8)
      asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;" ::"r"(to), "l"(from),
                   "r"(on ? 8 : 0));
    else
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(to), "l"(from),
                   "r"(on ? 4 : 0));
  }
}

// Grid (B * H, ceil(Sq / BBQ)). Block: group (b, h), query tile n - 1 - y;
// warp w its rows q0 + 16 B_MT w + [0, 16 B_MT), B_MT m-tiles of 16, so each
// K and V fragment read from shared memory serves them all.
template <int DP>
__global__ void __launch_bounds__(B_THREADS, 256 / B_THREADS) flash_bf16_kernel(Args a) {
  using L = Bf16Layout<DP>;
  constexpr int DS = L::DS, KT = DP / 16;   // 16-wide steps of D (and column pairs of O)
  constexpr int MT = B_MT;
  extern __shared__ float4 smem4[];
  bf16* sm = reinterpret_cast<bf16*>(smem4);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  // ldmatrix: lane l gives row l % 8 of matrix l / 8; a 16 x 16 block at
  // (r, c) is read as an A operand from (r + r8 + hi8, c + hi16), a pair of
  // B operands ([n][k] stored) from (r + r8 + hi16, c + hi8), transposed
  // ([k][n] stored) from (r + r8 + hi8, c + hi16)
  const int r8 = lane & 7, hi8 = 8 * ((lane >> 3) & 1), hi16 = 8 * (lane >> 4);
  const int grp = blockIdx.x, b = grp / a.H, h = grp % a.H, hkv = h / a.group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BBQ;
  const int R0 = q0 + 16 * MT * warp;   // the warp's first row
  const bf16* q = static_cast<const bf16*>(a.q) + b * a.q_b + h * a.q_h + q0 * a.q_s;
  const bf16* k = static_cast<const bf16*>(a.k) + b * a.k_b + hkv * a.k_h;
  const bf16* v = static_cast<const bf16*>(a.v) + b * a.v_b + hkv * a.v_h;
  const float scale2 = a.scale * LOG2E;

  // zero all tiles once: the lanes past D stay zero
  for (int i = threadIdx.x; i < L::END / 8; i += B_THREADS)
    reinterpret_cast<uint4*>(sm)[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();

  const int2 live = live_tiles<BBQ, BBK>(a, q0);
  const int t_begin = live.x, ntiles = live.y - live.x;
  auto load = [&](int tile, int buf) {
    const int k0 = tile * BBK, kn = min(BBK, a.Skv - k0);
    stage_rows<DS, BBK>(sm + L::K + buf * BBK * DS, k + k0 * a.k_s, a.k_s, kn, a.D, a.unit);
    stage_rows<DS, BBK>(sm + L::V + buf * BBK * DS, v + k0 * a.v_s, a.v_s, kn, a.D, a.unit);
  };
  stage_rows<DS, BBQ>(sm + L::Q, q, a.q_s, min(BBQ, a.Sq - q0), a.D, a.unit);
  if (ntiles > 0) load(t_begin, 0);
  cp_commit();
  cp_wait<0>();
  __syncthreads();
  // the warp's rows of q, read as A fragments each step (in registers they
  // would take DP / 2 of them a thread)
  const bf16* qs = sm + L::Q + (16 * MT * warp + r8 + hi8) * DS + hi16;

  float o[MT][2 * KT][4], m[MT][2], l[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int n = 0; n < 2 * KT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[mt][n][e] = 0.f;
    m[mt][0] = m[mt][1] = NEG_INF;
    l[mt][0] = l[mt][1] = 0.f;
  }

  for (int i = 0; i < ntiles; ++i) {
    const int tile = t_begin + i, k0 = tile * BBK, buf = i & 1;
    if (i > 0) {   // this tile has landed, and every warp is done with the one before
      cp_wait<0>();
      __syncthreads();
    }
    if (i + 1 < ntiles) load(tile + 1, buf ^ 1);
    cp_commit();
    if (dead_rows<BBK, 16 * MT>(a, k0, R0)) continue;
    const bf16* ks = sm + L::K + buf * BBK * DS;
    const bf16* vs = sm + L::V + buf * BBK * DS;

    // S = Q K^T over D in the tensor core (q and k exact in bf16)
    float s[MT][B_NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int n = 0; n < B_NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mt][n][e] = 0.f;
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
      uint32_t qa[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) ldsm(qa[mt], qs + 16 * mt * DS + 16 * kt);
#pragma unroll
      for (int np = 0; np < B_NT / 2; ++np) {
        uint32_t bb[4];
        ldsm(bb, ks + (16 * np + r8 + hi16) * DS + 16 * kt + hi8);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(s[mt][2 * np], qa[mt], bb[0], bb[1]);
          mma_bf16(s[mt][2 * np + 1], qa[mt], bb[2], bb[3]);
        }
      }
    }
    // the softmax a m-tile at a time; P in two bf16 parts as the A fragments
    // of the key steps kk (keys [16 kk, +16)): S's n-tiles 2 kk and 2 kk + 1
    // as they stand
    float al[MT][2];
    uint32_t ph[MT][B_NT / 2][4], pl[MT][B_NT / 2][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      online_softmax(s[mt], a, k0, R0 + 16 * mt, scale2, m[mt][0], m[mt][1], l[mt][0], l[mt][1],
                     al[mt][0], al[mt][1]);
#pragma unroll
      for (int kk = 0; kk < B_NT / 2; ++kk) {
        split_bf16(s[mt][2 * kk][0], s[mt][2 * kk][1], ph[mt][kk][0], pl[mt][kk][0]);
        split_bf16(s[mt][2 * kk][2], s[mt][2 * kk][3], ph[mt][kk][1], pl[mt][kk][1]);
        split_bf16(s[mt][2 * kk + 1][0], s[mt][2 * kk + 1][1], ph[mt][kk][2], pl[mt][kk][2]);
        split_bf16(s[mt][2 * kk + 1][2], s[mt][2 * kk + 1][3], ph[mt][kk][3], pl[mt][kk][3]);
      }
    }
    // O = O * alpha + P V, 16 columns at a time through a fresh accumulator:
    // the tile's 8 MMAs a column tile summed in the tensor core, small part
    // first
#pragma unroll
    for (int c = 0; c < KT; ++c) {
      float f[MT][2][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int p = 0; p < 2; ++p)
#pragma unroll
          for (int e = 0; e < 4; ++e) f[mt][p][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < B_NT / 2; ++kk) {
        uint32_t vb[4];
        ldsm_t(vb, vs + (16 * kk + r8 + hi8) * DS + 16 * c + hi16);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int p = 0; p < 2; ++p) {
            mma_bf16(f[mt][p], pl[mt][kk], vb[2 * p], vb[2 * p + 1]);
            mma_bf16(f[mt][p], ph[mt][kk], vb[2 * p], vb[2 * p + 1]);
          }
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          float* oc = o[mt][2 * c + p];
          oc[0] = fmaf(oc[0], al[mt][0], f[mt][p][0]);
          oc[1] = fmaf(oc[1], al[mt][0], f[mt][p][1]);
          oc[2] = fmaf(oc[2], al[mt][1], f[mt][p][2]);
          oc[3] = fmaf(oc[3], al[mt][1], f[mt][p][3]);
        }
    }
  }
  cp_wait<0>();

  // each row's den is the sum of its 4 threads' parts, clamped (:84)
  bf16* og = static_cast<bf16*>(a.o) + b * a.o_b + h * a.o_h;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int r0 = R0 + 16 * mt + g, r1 = r0 + 8;
    const float d0 = fmaxf(flare::quad_sum(l[mt][0]), 1e-30f);
    const float d1 = fmaxf(flare::quad_sum(l[mt][1]), 1e-30f);
#pragma unroll
    for (int n = 0; n < 2 * KT; ++n) {
      const int col = 8 * n + 2 * t;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        if (col + c >= a.D) continue;
        if (r0 < a.Sq) og[r0 * a.o_s + col + c] = __float2bfloat16(o[mt][n][c] / d0);
        if (r1 < a.Sq) og[r1 * a.o_s + col + c] = __float2bfloat16(o[mt][n][2 + c] / d1);
      }
    }
  }
}

template <int DP>
cudaError_t launch_bf16(const Args& a, cudaStream_t stream) {
  constexpr int bytes = Bf16Layout<DP>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(flash_bf16_kernel<DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.B * a.H, (a.Sq + BBQ - 1) / BBQ);
  flash_bf16_kernel<DP><<<grid, B_THREADS, bytes, stream>>>(a);
  return cudaGetLastError();
}

// f(DP) at the padded width of D: 16, 32, 64, 96 or 128
template <typename F>
cudaError_t at_width(int D, F&& f) {
  using std::integral_constant;
  if (D <= 16) return f(integral_constant<int, 16>{});
  if (D <= 32) return f(integral_constant<int, 32>{});
  if (D <= 64) return f(integral_constant<int, 64>{});
  if (D <= 96) return f(integral_constant<int, 96>{});
  return f(integral_constant<int, 128>{});
}

// The arguments of either entry point, or false where a kernel does not
// take them: 1 <= D <= 128, B * H < 2^31, ceil(Sq / 128) <= 65535.
bool args_of(Args& a, const void* q, const void* k, const void* v, void* o, int B, int H,
             int Hkv, int Sq, int Skv, int D, const long long* st, float scale, int causal,
             int window, int unit) {
  if (D < 1 || D > 128 || Sq < 1 || Skv < 1 || B < 1 || Hkv < 1 || H % Hkv ||
      (long long)B * H > 2147483647LL || (Sq + BBQ - 1) / BBQ > 65535)
    return false;
  a = Args{q, k, v, o, B, H, H / Hkv, Sq, Skv, D, st[0], st[1], st[2], st[3], st[4], st[5],
           st[6], st[7], st[8], st[9], st[10], st[11], scale, causal, window, unit};
  return true;
}

}  // namespace

extern "C" {

// bf16 q [B, H, Sq, D], k, v [B, Hkv, Skv, D] (Hkv | H) by element strides
// (b, h, s; the D stride is 1), o [B, H, Sq, D] bf16: the bf16 tensor-core
// kernel off TMA's route. 1 <= D <= 128, B * H < 2^31, ceil(Sq / 128) <=
// 65535. window < 0: no window. unit: the bytes of one copy of a row's
// piece, 16, 8, 4 (cp.async) or 2 (through registers); it divides 2 D, the
// bytes of every stride of q, k, v and every base address.
int flash_attention_bf16(const void* q, const void* k, const void* v, void* o, int B, int H,
                         int Hkv, int Sq, int Skv, int D, long long q_b, long long q_h,
                         long long q_s, long long k_b, long long k_h, long long k_s,
                         long long v_b, long long v_h, long long v_s, long long o_b,
                         long long o_h, long long o_s, float scale, int causal, int window,
                         int unit, void* stream) {
  const long long st[12] = {q_b, q_h, q_s, k_b, k_h, k_s, v_b, v_h, v_s, o_b, o_h, o_s};
  Args a;
  if ((unit != 16 && unit != 8 && unit != 4 && unit != 2) || (2 * D) % unit ||
      !args_of(a, q, k, v, o, B, H, Hkv, Sq, Skv, D, st, scale, causal, window, unit))
    return cudaErrorInvalidValue;
  return at_width(D, [&](auto dp) {
    return launch_bf16<decltype(dp)::value>(a, (cudaStream_t)stream);
  });
}

// fp32 q, k, v, o as above: the TF32 tensor-core kernel. unit: 16 only
// when D % 4 == 0 and every stride and base pointer is a multiple of 4
// elements (16-byte copies), else 4.
int flash_attention_tf32(const void* q, const void* k, const void* v, void* o, int B, int H,
                         int Hkv, int Sq, int Skv, int D, long long q_b, long long q_h,
                         long long q_s, long long k_b, long long k_h, long long k_s,
                         long long v_b, long long v_h, long long v_s, long long o_b,
                         long long o_h, long long o_s, float scale, int causal, int window,
                         int unit, void* stream) {
  const long long st[12] = {q_b, q_h, q_s, k_b, k_h, k_s, v_b, v_h, v_s, o_b, o_h, o_s};
  Args a;
  if ((unit != 16 && unit != 4) ||
      !args_of(a, q, k, v, o, B, H, Hkv, Sq, Skv, D, st, scale, causal, window, unit))
    return cudaErrorInvalidValue;
  return at_width(D, [&](auto dp) {
    return launch_tf32<decltype(dp)::value>(a, (cudaStream_t)stream);
  });
}

}  // extern "C"
