// Flash attention on Hopper's tensor cores (sm_90a), CUDA C++: the bf16 route.
//
// Replaces the TPU kernel of the JAX package, beside flash_attention.cu:
//   flash_tc_kernel <- repro/kernels/attention.py::_flash_kernel (flash_attention_pallas)
// flash_attention.cu keeps the fp32 route and the bf16 calls this kernel does
// not take (D % 8 != 0, or strides TMA cannot address); kernels/attention.py
// ::flash_route picks between them from dtype, D and strides alone.
//
// What it computes: what flash_attention.cu computes (its head comment), for
// bf16 q, k, v with k, v of Hkv heads, Hkv | H (GQA): query head h reads KV
// head h / (H / Hkv), so the model's K and V go in unexpanded. Scores are
// q . k in fp32 on the tensor cores, then * scale, then -1e30 where masked
// (causal top-left, window, j < Skv), masked weights zeroed explicitly, den
// clamped at 1e-30: a row with no key returns exactly 0. o is bf16.
//
// What bounds it. Two products of 2 * D FLOP for each (query, key) pair the
// masks keep: at qwen2-1.5b's prefill_32k, layer 0 (H = 12, D = 128,
// S = 32,768, causal), 3.30 TFLOP, 3.335 ms at the H100's bf16 tensor-core
// peak (989 TFLOP/s). This kernel runs the value product twice (the split P
// below), 4.95 TFLOP: its own floor is 5.0 ms. The bytes (q, o and the
// unexpanded k, v once: 0.23 GB, 0.07 ms at 3.35 TB/s) are far below.
//
// The design (the hopper-kernels guide, section 1):
//   * Blocks. A block takes one (b, h) and BQ = 128 query rows: W = 2
//     consumer warpgroups of 64 rows each and one producer warpgroup, one
//     thread of which issues every load. setmaxnreg gives the producer 40
//     registers and each consumer thread 232. The two consumers share every
//     K/V tile, and while one runs its softmax the other's products keep the
//     tensor cores busy.
//   * Loads. TMA (cp.async.bulk.tensor, completion on an mbarrier), with
//     tensor maps built on the host through cudaGetDriverEntryPoint
//     ("cuTensorMapEncodeTiled"), so nothing links libcuda. q is loaded once;
//     K and V tiles of BK = 64 keys go through a ring of STAGES = 2 (full
//     and empty mbarriers per stage). The maps' dims are the real (D, S, H,
//     B) in the operand's own strides (the model's [B, H, S, D] views of
//     [B, S, H, D] go in without a copy), so TMA zero-fills rows past Sq or
//     Skv and lanes past D: ragged Sq, Skv and D need no masked loads, and
//     nothing is padded in device memory. TMA needs every stride a multiple
//     of 16 bytes (D % 8 == 0) and a 16-byte base; flash_route sends other
//     calls to flash_attention.cu.
//   * Shared layout. Each tile is DP / AC column blocks of AC bf16 columns,
//     swizzled by TMA as wgmma reads them: AC = 64 (128-byte swizzle) where
//     64 | DP, else 32 (64-byte) where 32 | DP, else 16 (32-byte). D = 96
//     runs at DP = 96 as three 32-column atoms, not 1.5 of 64.
//   * Scores. S = Q K^T by wgmma m64n64k16 (bf16 in, fp32 out), Q and K both
//     K-major from shared memory, DP / 16 steps. Scale and mask as the fp32
//     kernel; only tiles that cross the diagonal, the window's edge or Skv
//     evaluate the mask. The softmax runs in base 2 on scale * log2(e)
//     scores; a row's max and sum reduce over the 4 threads that hold it.
//   * Value product. O += P V by wgmma m64nNk16 with P as the A operand
//     from registers (the S accumulator's fp32 pairs, converted in place: the
//     accumulator and A fragment layouts coincide) and V from shared memory,
//     MN-major (the transpose bit), in column chunks of N <= 64 (two at
//     DP = 96 and 128).
//   * Precision: a split P. Rounding p to bf16 before the value product, as
//     the TPU kernel does (:75) and SDPA does, moves o by up to ~2^-9 of |v|,
//     which the fp64 check beyond bf16 output rounding (chip_smoke.py,
//     Checks.hold_rounded, 1e-5 of max |o|) rejects. So P = P_hi + P_lo with
//     P_hi = bf16(P) and P_lo = bf16(P - P_hi), two wgmmas into the same
//     accumulator; the residual is ~2^-18 of p. den sums the fp32 weights.
//     The cost: a third product, 1.5x the two products' work.
//   * Sums run in two levels, as in flash_attention.cu: a tile's P V goes
//     into a fresh accumulator that is folded into the carried O once a
//     tile, so at S = 32,768 the carried sum takes 512 additions. The fresh
//     accumulator is one chunk's (N / 2 registers a thread): with all DP / 2
//     of it beside O and the P parts, DP = 128 spilled 384 bytes.
//   * Causal tail. Only live tiles are loaded, with the fp32 kernel's loop
//     bounds (window included); query tiles run longest first: the grid is
//     (B * H, Sq / 128) and block y takes query tile n - 1 - y.
//   * Registers and shared memory (ptxas -v, sm_90a, CUDA 12.9; chip_smoke.py
//     prints them): 168 registers a thread at entry (384 threads, one block
//     an SM), which setmaxnreg moves to 232 a consumer thread and 40 a
//     producer thread; 88 bytes of spill stores at DP = 128, none at
//     DP <= 96. Shared memory (BQ + 2 * STAGES * BK) * DP * 2 bytes plus 1 KB
//     for alignment and barriers: 97 KB at DP = 128.
//
// The entry point launches on the given stream, allocates nothing, and
// returns a cudaError_t code (cudaErrorNotSupported when the driver has no
// tensor-map encoder, cudaErrorInvalidValue when a map is refused).

#include <cuda.h>   // CUtensorMap and its enums; the encoder comes from the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int W = 2;                    // consumer warpgroups, 64 query rows each
constexpr int BQ = 64 * W;              // query rows a block
constexpr int BK = 64;                  // keys a tile
constexpr int STAGES = 2;               // K/V ring
constexpr int THREADS = 128 * (W + 1);  // the consumers, then the producer warpgroup

template <int DP>
struct Tiling {
  static constexpr int AC = DP % 64 == 0 ? 64 : (DP % 32 == 0 ? 32 : 16);   // atom columns
  // the value product's column chunks: [0, N0) and [N0, DP), each into its
  // own fresh accumulator (N0 / 2 registers a thread, not DP / 2)
  static constexpr int N0 = DP > 64 ? 64 : DP, N1 = DP - N0;
  static constexpr int ROW = AC * 2;                        // bytes a row of an atom: the swizzle
  static constexpr uint64_t LAYOUT = AC == 64 ? 1 : (AC == 32 ? 2 : 3);   // wgmma's swizzle code
  static constexpr int Q_BYTES = BQ * DP * 2;
  static constexpr int KV_BYTES = BK * DP * 2;              // one K or V tile
  static constexpr int K_OFF = Q_BYTES;                     // every offset a multiple of 1024
  static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + STAGES * KV_BYTES;
  static constexpr int BYTES = BAR_OFF + 8 * (1 + 2 * STAGES) + 1024;   // + base alignment
};

struct TcArgs {
  __nv_bfloat16* o;     // [B, H, Sq, D] by strides
  long long o_b, o_h, o_s;
  int H, group, Sq, Skv, D;   // group = H / Hkv
  float scale_log2;           // scale * log2(e)
  int causal, window;         // window < 0: no window
  int q_perm, k_perm, v_perm; // the maps' outer dims: 2 bits each, 0 = s, 1 = h, 2 = b
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// Wait for the completion of the barrier's phase of this parity. A phase
// that never completes is a fault of the kernel: trap (the launch fails with
// an error) rather than hang the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  for (uint32_t spins = 0;; ++spins) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (spins == (1u << 26)) __trap();
  }
}

// A TMA box of map `m` at (d0, s, h, b) into shared memory; its bytes
// complete on `bar`. The map's outer dims are (s, h, b) in `perm`'s order.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* m, uint32_t bar,
                                         int d0, int s, int h, int b, int perm) {
  auto pick = [&](int role) { return role == 0 ? s : (role == 1 ? h : b); };
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(m)), "r"(bar), "r"(d0), "r"(pick(perm & 3)),
      "r"(pick((perm >> 2) & 3)), "r"(pick((perm >> 4) & 3))
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keep the compiler from moving reads or writes of wgmma's registers across
// the (asynchronous) instruction's issue and wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// A wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (16-byte units) and the swizzle code.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint64_t layout) {
  return (uint64_t)((addr >> 4) & 0x3FFF) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

// S (+)= A B^T, m64n64k16: A and B K-major in shared memory
__device__ __forceinline__ void ss_n64(float (&d)[32], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(acc));
}

// O (+)= P V, m64nNk16: P (A) from registers, V (B) MN-major in shared memory
template <int N>
struct Rs;

template <>
struct Rs<16> {
  static __device__ __forceinline__ void mma(float (&d)[8], const uint32_t (&a)[4],
                                             uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
  }
};

template <>
struct Rs<32> {
  static __device__ __forceinline__ void mma(float (&d)[16], const uint32_t (&a)[4],
                                             uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
  }
};

template <>
struct Rs<64> {
  static __device__ __forceinline__ void mma(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
  }
};

// O[:, C0 : C0 + N] = O * alpha + (P_hi + P_lo) V[:, C0 : C0 + N]: the tile's
// product into a fresh accumulator (V MN-major from `v`, the chunk's first
// column, 16 keys a step), then folded into the carried O (its elements
// 4c + {0, 1} are row r0, 4c + {2, 3} row r1).
template <int N, int C0, int ROW, int OH>
__device__ __forceinline__ void pv_chunk(float (&o)[OH], float al0, float al1, uint32_t (&hi)[16],
                                         uint32_t (&lo)[16], uint32_t v, uint64_t layout) {
  float ot[N / 2];
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const uint32_t frag[4] = {hi[4 * kk], hi[4 * kk + 1], hi[4 * kk + 2], hi[4 * kk + 3]};
    Rs<N>::mma(ot, frag, make_desc(v + kk * 16 * ROW, BK * ROW, 8 * ROW, layout), kk > 0);
  }
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const uint32_t frag[4] = {lo[4 * kk], lo[4 * kk + 1], lo[4 * kk + 2], lo[4 * kk + 3]};
    Rs<N>::mma(ot, frag, make_desc(v + kk * 16 * ROW, BK * ROW, 8 * ROW, layout), 1);
  }
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(ot);
  fence_regs(hi);
  fence_regs(lo);
#pragma unroll
  for (int c = 0; c < N / 8; ++c) {
    float* oc = o + C0 / 2 + 4 * c;
    oc[0] = fmaf(oc[0], al0, ot[4 * c]);
    oc[1] = fmaf(oc[1], al0, ot[4 * c + 1]);
    oc[2] = fmaf(oc[2], al1, ot[4 * c + 2]);
    oc[3] = fmaf(oc[3], al1, ot[4 * c + 3]);
  }
}

// Grid (B * H, ceil(Sq / BQ)). Block: group g = (b, h), query tile n - 1 - y.
template <int DP>
__global__ void __launch_bounds__(THREADS, 1)
    flash_tc_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, const TcArgs a) {
  using L = Tiling<DP>;
  constexpr int AC = L::AC, ROW = L::ROW;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base, k_s = base + L::K_OFF, v_s = base + L::V_OFF;
  const uint32_t q_bar = base + L::BAR_OFF;            // then full[STAGES], empty[STAGES]
  auto full = [&](int s) { return q_bar + 8u * (1 + s); };
  auto empty = [&](int s) { return q_bar + 8u * (1 + STAGES + s); };

  const int g = blockIdx.x, b = g / a.H, h = g % a.H, hkv = h / a.group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  // the live tiles: flash_attention.cu's bounds for the block's BQ rows
  int t_end = (a.Skv + BK - 1) / BK;
  if (a.causal) t_end = min(t_end, (q0 + BQ - 1) / BK + 1);
  int t_begin = 0;
  if (a.window >= 0) {
    const long long lo = (long long)q0 - a.window - BK + 2;   // the least live k_start
    if (lo > 0) t_begin = (lo + BK - 1) / BK < t_end ? (int)((lo + BK - 1) / BK) : t_end;
  }

  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 128 * W);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == W) {
    // ---- producer: one thread issues every load -------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == 0) {
      mbar_expect_tx(q_bar, L::Q_BYTES);
      for (int j = 0; j < DP / AC; ++j)
        tma_load(q_s + j * BQ * ROW, &tq, q_bar, j * AC, q0, h, b, a.q_perm);
      for (int t = t_begin, i = 0; t < t_end; ++t, ++i) {
        const int s = i % STAGES, round = i / STAGES;
        if (round > 0) mbar_wait(empty(s), (round - 1) & 1);
        mbar_expect_tx(full(s), 2 * L::KV_BYTES);
        for (int j = 0; j < DP / AC; ++j) {
          tma_load(k_s + s * L::KV_BYTES + j * BK * ROW, &tk, full(s), j * AC, t * BK, hkv, b,
                   a.k_perm);
          tma_load(v_s + s * L::KV_BYTES + j * BK * ROW, &tv, full(s), j * AC, t * BK, hkv, b,
                   a.v_perm);
        }
      }
    }
  } else {
    // ---- consumer warpgroup wg: query rows q0 + 64 wg + [0, 64) ----------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int warp = tid / 32, lane = tid % 32;
    const int r0 = q0 + 64 * wg + 16 * warp + lane / 4, r1 = r0 + 8;   // this thread's rows
    const int cq = 2 * (lane % 4);   // its first column in each 8-column chunk
    const int R0 = q0 + 64 * wg;     // the warpgroup's first row
    float o[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
    float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;
    const uint32_t qa = q_s + wg * 64 * ROW;
    mbar_wait(q_bar, 0);

    for (int t = t_begin, i = 0; t < t_end; ++t, ++i) {
      const int st = i % STAGES;
      mbar_wait(full(st), (i / STAGES) & 1);
      const uint32_t ks = k_s + st * L::KV_BYTES, vs = v_s + st * L::KV_BYTES;

      // S = Q K^T: K-major operands, DP / 16 steps of 16 columns
      float s[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const int blk = kk * 16 / AC, col = (kk * 16 % AC) * 2;
        ss_n64(s, make_desc(qa + blk * BQ * ROW + col, 16, 8 * ROW, L::LAYOUT),
               make_desc(ks + blk * BK * ROW + col, 16, 8 * ROW, L::LAYOUT), kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);

      // scale and mask (-1e30); element 4c + j is row j < 2 ? r0 : r1, key
      // k0 + 8c + cq + (j & 1). Only tiles some pair of which is masked test.
      const int k0 = t * BK;
      const bool whole = k0 + BK <= a.Skv && (!a.causal || k0 + BK - 1 <= R0) &&
                         (a.window < 0 || k0 > R0 + 63 - a.window);
      uint32_t keep = 0xffffffffu;
      float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float x = s[4 * c + j] * a.scale_log2;
          if (!whole) {
            const int key = k0 + 8 * c + cq + (j & 1), row = j < 2 ? r0 : r1;
            const bool ok = key < a.Skv && (!a.causal || key <= row) &&
                            (a.window < 0 || key > row - a.window);
            if (!ok) {
              x = NEG_INF;
              keep &= ~(1u << (4 * c + j));
            }
          }
          s[4 * c + j] = x;
          if (j < 2)
            mx0 = fmaxf(mx0, x);
          else
            mx1 = fmaxf(mx1, x);
        }
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float n0 = fmaxf(m0, mx0), n1 = fmaxf(m1, mx1);
      const float al0 = exp2f(m0 - n0), al1 = exp2f(m1 - n1);
      m0 = n0;
      m1 = n1;

      // the weights (masked ones exactly 0), this tile's part of the den, and
      // P split into bf16 halves as the A operand: fragment kk's registers
      // are elements 8kk + {0,1}, {2,3}, {4,5}, {6,7}
      uint32_t hi[16], lo[16];
      float ts0 = 0.f, ts1 = 0.f;
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const float p = (keep >> e) & 1u ? exp2f(s[e] - ((e & 3) < 2 ? n0 : n1)) : 0.f;
        s[e] = p;
        if ((e & 3) < 2)
          ts0 += p;
        else
          ts1 += p;
      }
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const __nv_bfloat162 ph = __floats2bfloat162_rn(s[2 * e], s[2 * e + 1]);
        const float2 back = __bfloat1622float2(ph);
        const __nv_bfloat162 pl = __floats2bfloat162_rn(s[2 * e] - back.x, s[2 * e + 1] - back.y);
        hi[e] = *reinterpret_cast<const uint32_t*>(&ph);
        lo[e] = *reinterpret_cast<const uint32_t*>(&pl);
      }
      l0 = fmaf(l0, al0, ts0);
      l1 = fmaf(l1, al1, ts1);

      // this tile's P V, a column chunk at a time, each into a fresh
      // accumulator folded into the carried O
      pv_chunk<L::N0, 0, ROW>(o, al0, al1, hi, lo, vs, L::LAYOUT);
      if constexpr (L::N1 > 0)
        pv_chunk<L::N1, L::N0, ROW>(o, al0, al1, hi, lo, vs + (L::N0 / AC) * BK * ROW,
                                    L::LAYOUT);
      mbar_arrive(empty(st));   // this warpgroup is done with the stage
    }

    // each row's den is the sum of its 4 threads' partials, clamped (:84)
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
    __nv_bfloat16* og = a.o + b * a.o_b + h * a.o_h;
#pragma unroll
    for (int c = 0; c < DP / 8; ++c) {
      const int col = 8 * c + cq;
      if (col >= a.D) continue;
      if (r0 < a.Sq)
        *reinterpret_cast<__nv_bfloat162*>(og + r0 * a.o_s + col) =
            __floats2bfloat162_rn(o[4 * c] / d0, o[4 * c + 1] / d0);
      if (r1 < a.Sq)
        *reinterpret_cast<__nv_bfloat162*>(og + r1 * a.o_s + col) =
            __floats2bfloat162_rn(o[4 * c + 2] / d1, o[4 * c + 3] / d1);
    }
  }
}

// ---- host: tensor maps and the launch ------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = (EncodeTiled)p;
  }
  return fn;
}

// A 4-D bf16 map of an operand [B, Hn, S, D] by element strides (D stride 1):
// dim 0 is d, the outer three (s, h, b) in ascending stride order (`perm`
// records it, 2 bits a dim); the box is (cols, rows along s, 1, 1). A dim
// of size 1 takes the operand's span as its stride (any multiple of 16
// bytes will do; PyTorch's may not be one).
cudaError_t make_map(CUtensorMap* map, const void* ptr, int D, int S, int Hn, int B,
                     long long ss, long long sh, long long sb, int cols, int rows,
                     CUtensorMapSwizzle swizzle, int* perm) {
  EncodeTiled enc = encoder();
  if (enc == nullptr) return cudaErrorNotSupported;
  struct Dim {
    long long stride;
    int size, role, box;
  } dims[3] = {{ss, S, 0, rows}, {sh, Hn, 1, 1}, {sb, B, 2, 1}};
  long long span = D;
  for (const Dim& d : dims)
    if (d.size > 1 && d.stride * d.size > span) span = d.stride * d.size;
  for (Dim& d : dims)
    if (d.size == 1) d.stride = (span + 7) / 8 * 8;
  for (int i = 1; i < 3; ++i)   // insertion sort by stride
    for (int j = i; j > 0 && dims[j].stride < dims[j - 1].stride; --j) {
      const Dim t = dims[j];
      dims[j] = dims[j - 1];
      dims[j - 1] = t;
    }
  cuuint64_t gdim[4] = {(cuuint64_t)D, (cuuint64_t)dims[0].size, (cuuint64_t)dims[1].size,
                        (cuuint64_t)dims[2].size};
  cuuint64_t gstride[3] = {(cuuint64_t)dims[0].stride * 2, (cuuint64_t)dims[1].stride * 2,
                           (cuuint64_t)dims[2].stride * 2};
  cuuint32_t box[4] = {(cuuint32_t)cols, (cuuint32_t)dims[0].box, (cuuint32_t)dims[1].box,
                       (cuuint32_t)dims[2].box};
  cuuint32_t unit[4] = {1, 1, 1, 1};
  *perm = dims[0].role | dims[1].role << 2 | dims[2].role << 4;
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), gdim,
                         gstride, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

struct Call {
  const void *q, *k, *v;
  void* o;
  int B, H, Hkv, Sq, Skv, D;
  long long q_b, q_h, q_s, k_b, k_h, k_s, v_b, v_h, v_s, o_b, o_h, o_s;
  float scale;
  int causal, window;
};

template <int DP>
cudaError_t launch_tc(const Call& c, cudaStream_t stream) {
  using L = Tiling<DP>;
  const CUtensorMapSwizzle sw = L::AC == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
                                : L::AC == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                              : CU_TENSOR_MAP_SWIZZLE_32B;
  CUtensorMap mq, mk, mv;
  int q_perm, k_perm, v_perm;
  cudaError_t err =
      make_map(&mq, c.q, c.D, c.Sq, c.H, c.B, c.q_s, c.q_h, c.q_b, L::AC, BQ, sw, &q_perm);
  if (err == cudaSuccess)
    err = make_map(&mk, c.k, c.D, c.Skv, c.Hkv, c.B, c.k_s, c.k_h, c.k_b, L::AC, BK, sw, &k_perm);
  if (err == cudaSuccess)
    err = make_map(&mv, c.v, c.D, c.Skv, c.Hkv, c.B, c.v_s, c.v_h, c.v_b, L::AC, BK, sw, &v_perm);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_tc_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             L::BYTES);
  if (err != cudaSuccess) return err;
  TcArgs a{static_cast<__nv_bfloat16*>(c.o), c.o_b, c.o_h, c.o_s, c.H, c.H / c.Hkv, c.Sq,
           c.Skv, c.D, c.scale * LOG2E, c.causal, c.window, q_perm, k_perm, v_perm};
  const dim3 grid(c.B * c.H, (c.Sq + BQ - 1) / BQ);
  flash_tc_kernel<DP><<<grid, THREADS, L::BYTES, stream>>>(mq, mk, mv, a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// bf16 q [B, H, Sq, D], k, v [B, Hkv, Skv, D] (Hkv | H) and o [B, H, Sq, D]
// by element strides (b, h, s; the D stride is 1). D % 8 == 0 and D <= 128;
// every pointer 16-byte aligned and every stride of a dim longer than 1 a
// multiple of 8 elements (TMA); B * H < 2^31, ceil(Sq / 128) <= 65535.
// window < 0: no window.
int flash_attention_tc(const void* q, const void* k, const void* v, void* o, int B, int H,
                       int Hkv, int Sq, int Skv, int D, long long q_b, long long q_h,
                       long long q_s, long long k_b, long long k_h, long long k_s,
                       long long v_b, long long v_h, long long v_s, long long o_b,
                       long long o_h, long long o_s, float scale, int causal, int window,
                       void* stream) {
  if (D < 8 || D > 128 || D % 8 || Sq < 1 || Skv < 1 || B < 1 || Hkv < 1 || H % Hkv ||
      (Sq + BQ - 1) / BQ > 65535)
    return cudaErrorInvalidValue;
  const Call c{q, k, v, o, B, H, Hkv, Sq, Skv, D, q_b, q_h, q_s, k_b, k_h, k_s, v_b, v_h, v_s,
               o_b, o_h, o_s, scale, causal, window};
  cudaStream_t s = (cudaStream_t)stream;
  if (D <= 16) return launch_tc<16>(c, s);
  if (D <= 32) return launch_tc<32>(c, s);
  if (D <= 64) return launch_tc<64>(c, s);
  if (D <= 96) return launch_tc<96>(c, s);
  return launch_tc<128>(c, s);
}

}  // extern "C"
