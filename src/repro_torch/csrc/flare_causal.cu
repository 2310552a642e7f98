// Causal FLARE for Hopper (sm_90a), CUDA C++: both routes on the tensor
// cores, bf16 in bf16 MMAs, fp32 in TF32 MMAs on split operands.
//
// Replaces the TPU kernel of the JAX package:
//   causal_tc_kernel (bf16) / causal_tf32_kernel (fp32) + causal_combine_kernel
//       <- repro/kernels/flare_causal.py::_causal_chunk_kernel (flare_causal_chunk_pallas)
//
// What it computes. Token t of group g = (b, h) decodes against the latent
// state of tokens <= t: with scores s[m, t] = q_m . k_t (scale 1),
//   y_t = sum_m softmax_m(s[:, t]) * num_m(t) / den_m(t),
//   num_m(t) = sum_{tau <= t} e^{s[m, tau] - ref_m} v_tau,  den_m(t) likewise,
// where ref_m is a per-latent stabiliser. As in the TPU kernel, the tokens
// are swept in tiles carrying (max, num, den) per latent, and ref_m is the
// running max including the whole current tile: the bounded-score contract
// of core/flare_stream.py (den underflows only where a later in-tile score
// exceeds the running max by ~69-85 nats; a 64-token tile (bf16) or a
// 32-token one (fp32) narrows that against the TPU kernel's 1024).
//
// What bounds it. Three products of 2*M*T*D FLOP per group (scores, the
// state update, the decode): at flare_lm's width (H = 16, M = 512, D = 128)
// and T = 32,768 that is 206 GFLOP a call, 0.208 ms at the H100's bf16
// tensor-core rate (989 TFLOP/s), 3.08 ms at fp32's 67 on the CUDA cores
// (the bound of any fp32 implementation), against 0.12 ms for the bytes of
// q, k, v and y. Both routes once ran every product on the CUDA cores in
// fp32: 17.012 ms (bf16) and 16.661 ms (fp32) at flare_lm's layer 0 on an
// NVIDIA H100 80GB HBM3 at 700 W (PERF.md section 6, row 5).
//
// What does not carry over from the TPU, and the design (both routes):
//   * The TPU kernel is one program per group that walks the T tiles in
//     order with the latent state in VMEM. Here the carried numerator is
//     M*D fp32 = 256 KB per group, above a block's 227 KB, and one block per
//     group would give only B*H = 16 blocks for 132 SMs. But the latents are
//     independent of each other in the state; only the decode softmax
//     couples them, through one normaliser per token. So a block takes one
//     group and a slice of CL = 64 latents (M / 64 splits), sweeps all T
//     tiles of CT = 64 tokens in order with its slice's state, and writes a
//     flash-decoding partial per token: the decode numerator over its
//     latents against its own max of their scores, and that max and the sum
//     of weights. causal_combine_kernel then merges the splits per token in
//     a fixed order (no atomics, deterministic) and writes y in the output
//     dtype. The partials are fp32 [M / 64, B*H, T, D]: at flare_lm's layer
//     0 they are 2.1 GB written and read again, ~1.3 ms of the card's
//     memory rate. Merging a group's splits in a thread-block cluster
//     through distributed shared memory instead was built and measured
//     slower (PERF.md section 6): the occupancy query lets fewer clusters
//     of 8 run at once than flare_lm's 16 groups need, and with clusters of
//     2 the merge's barrier and remote reads each tile cost more than the
//     partials saved.
//   * Precision: the carried sums take one addition a tile (512 at T =
//     32,768, not 32,768; the lesson of the encode in flare.cu), the tile's
//     own part formed apart and added once.
//   * No padding in device memory: a ragged last tile is a loop bound and
//     its missing rows are zero-filled and given zero weight; a ragged last
//     latent slice gives its missing latents zero weight. K, V and Y go by
//     strides ([B, H, T, D] views of [B, T, H*D] activations), so the model
//     copies nothing.
//   * Head dims: any D from 1 to 128 runs at the next padded width DP (32,
//     64, 128: a warp takes a quarter or half of it), lanes D <= d < DP
//     of q, k and v zero where they are staged, so they add exactly 0 to
//     every score, and nothing is written to them (the fp32 partials are
//     [.., N, D]). A D equal to its width runs an instance of its own with D
//     known at compile time. So D = 96 (phi3's width) runs at DP = 128.
//
// bf16, causal_tc_kernel: the factored form of the TPU kernel, every product
// on the tensor cores (mma.sync m16n8k16, bf16 in, fp32 accumulate; mma.sync
// rather than wgmma because each product's operand comes out of the one
// before it in registers, and the block's 64-latent slice is one warpgroup's
// 64 rows only in the first product). Eight warps, each a 16-row tile lt
// and a half hf; per tile:
//   phase 1, a warp per 16 latents and half the tile's tokens: the scores
//     S = q k^T over D (q and k exact in bf16); per latent the tile max (the
//     two halves' through shared memory), the reference, f1 = e^{s - ref}
//     and the prefix sums of f1 over tokens on the carried den (cden; the
//     quad's running sums by shuffles, the first half's total through shared
//     memory); per token the max of its scores over the slice (shuffles
//     across the warp's rows, then the four latent tiles through shared
//     memory), the decode weights w and f2 = w / cden; f1, f2 and the
//     carried numerator (rescaled) go to shared memory;
//   the state update num += f1 v, a warp per 16 latents and half the head
//     dim, f1 read back as A fragments;
//   phase 2, a warp per 16 tokens and half the head dim: the carried decode
//     f2^T num and the intra-tile mixing a = f2^T f1, both contracting over
//     latents, read f2 transposed from shared memory (ldmatrix .trans: the
//     transpose costs nothing), a masked to i <= j and only over the token
//     tiles up to the warp's own; then y += a v with a's accumulator as the
//     A fragment.
//   Eight warps, not four: with B*H*M/64 = 128 blocks there is one block an
//   SM, and four warps (one a scheduler) left each dependent chain's latency
//   exposed (4.86 ms against 3.84 at flare_lm's layer 0, PERF.md section 6).
//   * Precision: f1, f2, a and the carried numerator are not bf16 values.
//     Each enters its MMA split in two bf16 parts, hi = bf16(x) and
//     lo = bf16(x - hi) (about 2^-17 |x| left); a product of two such
//     operands is three MMAs (lo.hi, hi.lo, hi.hi), of one with v two. One
//     rounding to bf16 would leave ~2^-9 and miss the check beyond the
//     output's rounding (tests/test_torch_kernels.py holds both choices on
//     an emulation, kernels/ref.py::flare_causal_split_ref). The TPU kernel
//     rounds f1 once, to v's dtype; this one deliberately does not.
//   * Loads: the next tile's k and v go through cp.async into a second
//     buffer while this tile computes (16-byte units; a head dim that is
//     not a multiple of 8 loads through registers instead).
//
// fp32, causal_tf32_kernel: the same factored form and phases on the TF32
// tensor cores (mma.sync m16n8k8). What bounds it: one TF32 rounding
// (2^-11) of an operand misses the fp32 check (1e-5 of max |y| against
// fp64), so every fp32 operand (q, k and v too) enters split, hi = tf32(x)
// and lo = tf32(x - hi), and every product is three MMAs (lo.hi + hi.lo +
// hi.hi): 3 x 206 GFLOP at flare_lm's layer 0, 1.25 ms at TF32's 495
// TFLOP/s, more at mma.sync's measured rate, and the splits (five integer
// or fp32 operations an element) compete with the MMAs for issue slots.
// What the design does about it:
//   * Shared memory. The bf16 layout in fp32 (q, and K and V double-
//     buffered, alone 174 KB at DP 128) does not fit, so tiles are 32
//     tokens, and every operand but q is stored raw (fp32) once and split as
//     a fragment is read: K, V, the carried numerator, f1 (latent-major, and
//     token-major for the mixing's B operand) and f2 (token-major); q, the
//     same every tile, is split once at the start. 208 KB at DP 128, one
//     block an SM (the grid is 128 blocks at flare_lm's layer 0 anyway).
//   * Fragments. No ldmatrix for 32-bit transposes: every product contracts
//     in pair order (an 8-wide step's k indices t and t + 4 are columns 2t
//     and 2t + 1), so an A fragment is two float2 reads and a B fragment of
//     a [n][k] tile one, an accumulator is the next product's A fragment as
//     it stands, and the row strides (q, K: DP + 8; V, num: DP + 4; f1:
//     TT + 8; f1, f2 token-major: CL + 8) keep each read on 32 banks.
//   * Warps. Phase 1 and the update as the bf16 route's (a 16-latent tile
//     and a half of the tile's tokens or of the head dim); phase 2 a
//     16-token tile and a quarter of the head dim. The intra-tile mixing a
//     is computed once, each of its six 16 x 8 tiles by one warp beside its
//     carried decode, and shared through shared memory (a barrier), not
//     computed by each of the four warps of a token tile.
//   * Precision. The tensor core truncates its additions (flare_mma.cuh):
//     where a sum is long (S over D, f2^T num and a over 64 latents, and
//     a v with them) each step's main product (hi.hi) starts from zero and
//     is added to fp32 sums, the small terms summed in the tensor core; the
//     update's 32-token f1 v is summed in the tensor core from zero and
//     added to the carried numerator once a tile (the two-level sums).
//     kernels/ref.py::flare_causal_split_ref(split="tf32") emulates the
//     products (tests/test_torch_tc_splits.py: within 1e-5 of fp64 where one
//     TF32 rounding is not).
//
// The entry point launches on the given stream, allocates nothing (the
// caller gives the fp32 partials), and returns cudaGetLastError().

#include "flare_mma.cuh"

namespace {

using namespace flare;

constexpr int CT = 64;               // tokens a tile of the bf16 route
constexpr int CL = 64;               // latents a block (one split of M)

constexpr int TT = 32;               // tokens a tile of the fp32 route
constexpr int TC_THREADS = 256;      // eight warps on both routes

// ---------------------------------------------------------------------------
// The bf16 route on the tensor cores (mma.sync m16n8k16, bf16 in, fp32
// accumulate), the factored form of the TPU kernel.

using bf16 = __nv_bfloat16;

// a C fragment's pair of columns (2t, 2t + 1) of one row, split, stored at
// element `at` of the hi and the lo bf16 tiles
__device__ __forceinline__ void store_split(bf16* hi, bf16* lo, int at, float a, float b) {
  uint32_t h, l;
  split_bf16(a, b, h, l);
  *reinterpret_cast<uint32_t*>(hi + at) = h;
  *reinterpret_cast<uint32_t*>(lo + at) = l;
}

template <int DP>
struct TcLayout {   // shared memory of causal_tc_kernel, in bf16 elements
  static constexpr int DS = DP + 8;   // row stride of the [*, DP] tiles: an odd number of
  static constexpr int FS = CT + 8;   // 16-byte units, so ldmatrix's 8 rows hit 8 bank groups
  static constexpr int Q = 0;                       // the slice's q [CL][DS]
  static constexpr int K = Q + CL * DS;             // k, two buffers [2][CT][DS]
  static constexpr int V = K + 2 * CT * DS;         // v, two buffers [2][CT][DS]
  static constexpr int F1H = V + 2 * CT * DS;       // f1 [CL][FS], hi and lo parts
  static constexpr int F1L = F1H + CL * FS;
  static constexpr int F2H = F1L + CL * FS;         // f2 [CL][FS], hi and lo
  static constexpr int F2L = F2H + CL * FS;
  static constexpr int NH = F2L + CL * FS;          // the carried numerator [CL][DS], hi and lo
  static constexpr int NL = NH + CL * DS;
  static constexpr int END = NL + CL * DS;          // then fp32 exchange arrays:
  static constexpr int BYTES = END * 2 + (9 * CT + 4 * CL) * 4;
};

struct TcSwap {   // the fp32 exchange arrays after the tiles, at the route's token tile n
  float* col_max;   // [4][n] per latent tile: max over its 16 latents of each token's score
  float* col_sum;   // [4][n] per latent tile: sum of each token's decode weights
  float* tok_mx;    // [n] max over the slice of each token's scores
  float* row_max;   // [2][CL] per token half: max of each latent's scores
  float* row_sum;   // [2][CL] per token half: sum of each latent's f1

  __device__ TcSwap(float* p, int n)
      : col_max(p), col_sum(p + 4 * n), tok_mx(p + 8 * n), row_max(p + 9 * n),
        row_sum(p + 9 * n + 2 * CL) {}
};

// Grid (M / CL splits, B*H), bf16 q, k, v. Block = group g, latents
// [split*CL, +CL), at the padded width DP (32, 64, 128) for the head dim
// Dr <= DP (EXACT: Dr == DP). Writes part[split, g, t, :Dr] (the fp32
// decode numerator over the slice) and stat[split, g, t, :] = (slice max of
// the token's scores, sum of its weights). `async`: k and v rows are whole
// 16-byte units (Dr % 8 == 0, aligned strides and bases) and go through
// cp.async into the next tile's buffer while this tile computes; else they
// are loaded through registers.
template <int DP, bool EXACT>
__global__ void __launch_bounds__(TC_THREADS, 1)
causal_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, float* __restrict__ part,
                 float* __restrict__ stat, int H, int M, int N, int d_run, Strides ks,
                 Strides vs, bool async) {
  using L = TcLayout<DP>;
  constexpr int DT = DP / 8, DS = L::DS, FS = L::FS;
  extern __shared__ float4 smem4[];
  bf16* sm = reinterpret_cast<bf16*>(smem4);
  float* swap = reinterpret_cast<float*>(sm + L::END);
  const TcSwap sw(swap, CT);
  const int Dr = EXACT ? DP : d_run;
  const int split = blockIdx.x, g = blockIdx.y, b = g / H, h = g % H;
  const int l0 = split * CL, nl = min(CL, M - l0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gi = lane >> 2, ti = lane & 3;
  const bf16* kg = k + b * ks.b + h * ks.h;
  const bf16* vg = v + b * vs.b + h * vs.h;
  const bf16* qh = q + ((long long)h * M + l0) * Dr;
  const long long row = (long long)split * gridDim.y + g;
  float* part_g = part + row * N * Dr;
  float* stat_g = stat + row * N * 2;
  // ldmatrix: lane l gives row l % 8 of matrix l / 8; a 16 x 16 block at
  // (r, c) is read as an A operand from (r + r8 + hi8, c + hi16), a pair of
  // B operands ([n][k] stored) from (r + r8 + hi16, c + hi8); transposed
  // ([k][row] or [k][n] stored) the same two with the roles of hi8 and hi16
  // swapped
  const int r8 = lane & 7, hi8 = 8 * ((lane >> 3) & 1), hi16 = 8 * (lane >> 4);

  // zero all tiles once: the lanes past Dr and the rows past N stay zero
  for (int i = tid; i < L::END / 8; i += TC_THREADS)
    reinterpret_cast<uint4*>(sm)[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();
  for (int i = tid; i < nl * Dr; i += TC_THREADS)
    sm[L::Q + (i / Dr) * DS + i % Dr] = qh[i];

  auto load_tile = [&](int t0, int buf) {
    const int tn = min(CT, N - t0);
    bf16* kd = sm + L::K + buf * CT * DS;
    bf16* vd = sm + L::V + buf * CT * DS;
    if (async) {
      const int units = Dr / 8;
      for (int i = tid; i < CT * units; i += TC_THREADS) {
        const int j = i / units, c = (i % units) * 8;
        const long long n = t0 + min(j, tn - 1);   // rows past N: zero-filled, nothing read
        const int bytes = j < tn ? 16 : 0;
        cp_async16(kd + j * DS + c, kg + n * ks.n + c, bytes);
        cp_async16(vd + j * DS + c, vg + n * vs.n + c, bytes);
      }
      asm volatile("cp.async.commit_group;");
    } else {
      for (int i = tid; i < CT * Dr; i += TC_THREADS) {
        const int j = i / Dr, d = i % Dr;
        const bool in = j < tn;
        kd[j * DS + d] = in ? kg[(long long)(t0 + j) * ks.n + d] : __float2bfloat16(0.f);
        vd[j * DS + d] = in ? vg[(long long)(t0 + j) * vs.n + d] : __float2bfloat16(0.f);
      }
    }
  };

  // warp = (lt, hf): the 16-row tile lt of latents (phase 1) or tokens
  // (phase 2), and a half hf of the tile's tokens (scores) or of the head dim
  // (the state update, the decode). The carried state of rows gi and gi + 8
  // of latent tile lt: the numerator's half hf in registers; the max and den
  // held alike by both warps of lt.
  constexpr int DH = DT / 2;   // 8-wide column tiles of a head-dim half
  const int lt = warp & 3, hf = warp >> 2;
  float carry[DH][4] = {}, mxr[2] = {NEG_INF, NEG_INF}, denr[2] = {0.f, 0.f};
  bool lv[2];
  for (int hh = 0; hh < 2; ++hh) lv[hh] = 16 * lt + gi + 8 * hh < nl;
  load_tile(0, 0);
  for (int t0 = 0, it = 0; t0 < N; t0 += CT, ++it) {
    const int tn = min(CT, N - t0), buf = it & 1;
    if (async) asm volatile("cp.async.wait_all;" ::: "memory");
    __syncthreads();
    if (t0 + CT < N) load_tile(t0 + CT, buf ^ 1);
    const bf16* ks_t = sm + L::K + buf * CT * DS;
    const bf16* vs_t = sm + L::V + buf * CT * DS;

    // ---- phase 1: latents [16 lt, +16) against tokens [32 hf, +32)
    float s[4][4] = {};   // scores, n-tile nt = tokens [32 hf + 8 nt, +8)
#pragma unroll
    for (int kt = 0; kt < DP / 16; ++kt) {
      uint32_t a[4];
      ldsm(a, sm + L::Q + (16 * lt + r8 + hi8) * DS + 16 * kt + hi16);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t bb[4];
        ldsm(bb, ks_t + (32 * hf + 16 * np + r8 + hi16) * DS + 16 * kt + hi8);
        mma_bf16(s[2 * np], a, bb[0], bb[1]);
        mma_bf16(s[2 * np + 1], a, bb[2], bb[3]);
      }
    }
    auto tok = [&](int nt, int c) { return 32 * hf + 8 * nt + 2 * ti + c; };
    // each latent's max over the half's tokens, each token's over the tile's latents
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float tm = NEG_INF;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int c = 0; c < 2; ++c)
          if (tok(nt, c) < tn) tm = fmaxf(tm, s[nt][2 * hh + c]);
      tm = quad_max(tm);
      if (ti == 0) sw.row_max[hf * CL + 16 * lt + gi + 8 * hh] = tm;
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float x = fmaxf(lv[0] ? s[nt][c] : NEG_INF, lv[1] ? s[nt][2 + c] : NEG_INF);
        x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
        x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 8));
        x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 16));
        if (gi == 0) sw.col_max[lt * CT + tok(nt, c)] = x;
      }
    __syncthreads();
    // per latent: the reference (the running max with the tile's), f1 and
    // its prefix sums over the half's tokens; per token: the decode weights
    float f1[4][4], cd[4][4], w[4][4], ref[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int l = 16 * lt + gi + 8 * hh;
      ref[hh] = fmaxf(mxr[hh], fmaxf(sw.row_max[l], sw.row_max[CL + l]));
      float run = 0.f;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        float e[2];
#pragma unroll
        for (int c = 0; c < 2; ++c)
          e[c] = lv[hh] && tok(nt, c) < tn ? __expf(s[nt][2 * hh + c] - ref[hh]) : 0.f;
        const float pair = e[0] + e[1];
        float incl = pair;   // inclusive scan over the quad's columns
        float up = __shfl_up_sync(0xffffffffu, incl, 1, 4);
        if (ti >= 1) incl += up;
        up = __shfl_up_sync(0xffffffffu, incl, 2, 4);
        if (ti >= 2) incl += up;
        cd[nt][2 * hh] = run + (incl - pair) + e[0];
        cd[nt][2 * hh + 1] = cd[nt][2 * hh] + e[1];
        f1[nt][2 * hh] = e[0];
        f1[nt][2 * hh + 1] = e[1];
        run += __shfl_sync(0xffffffffu, incl, 3, 4);
      }
      if (ti == 0) sw.row_sum[hf * CL + l] = run;
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = tok(nt, c);
        const float tmx = fmaxf(fmaxf(sw.col_max[col], sw.col_max[CT + col]),
                                fmaxf(sw.col_max[2 * CT + col], sw.col_max[3 * CT + col]));
        if (lt == 0 && gi == 0) sw.tok_mx[col] = tmx;
        w[nt][c] = lv[0] ? __expf(s[nt][c] - tmx) : 0.f;
        w[nt][2 + c] = lv[1] ? __expf(s[nt][2 + c] - tmx) : 0.f;
        float x = w[nt][c] + w[nt][2 + c];
        x += __shfl_xor_sync(0xffffffffu, x, 4);
        x += __shfl_xor_sync(0xffffffffu, x, 8);
        x += __shfl_xor_sync(0xffffffffu, x, 16);
        if (gi == 0) sw.col_sum[lt * CT + col] = x;
      }
    __syncthreads();
    // the carried den on the new reference and the first half's f1 under
    // the second's prefix; f2 = w / cden; f1, f2 and the rescaled carried
    // numerator (this warp's half of the head dim) to shared memory in two
    // bf16 parts
    float scale[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int l = 16 * lt + gi + 8 * hh;
      scale[hh] = lv[hh] ? __expf(mxr[hh] - ref[hh]) : 0.f;
      const float base = denr[hh] * scale[hh];
      const float below = hf == 1 ? sw.row_sum[l] : 0.f;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int c = 0; c < 2; ++c) cd[nt][2 * hh + c] += base + below;
      denr[hh] = base + sw.row_sum[l] + sw.row_sum[CL + l];
      mxr[hh] = lv[hh] ? ref[hh] : NEG_INF;
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int at = (16 * lt + gi + 8 * hh) * FS + 32 * hf + 8 * nt + 2 * ti;
        store_split(sm + L::F2H, sm + L::F2L, at,
                    __fdividef(w[nt][2 * hh], fmaxf(cd[nt][2 * hh], 1e-30f)),
                    __fdividef(w[nt][2 * hh + 1], fmaxf(cd[nt][2 * hh + 1], 1e-30f)));
        store_split(sm + L::F1H, sm + L::F1L, at, f1[nt][2 * hh], f1[nt][2 * hh + 1]);
      }
#pragma unroll
    for (int dt = 0; dt < DH; ++dt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        carry[dt][2 * hh] *= scale[hh];
        carry[dt][2 * hh + 1] *= scale[hh];
        store_split(sm + L::NH, sm + L::NL,
                    (16 * lt + gi + 8 * hh) * DS + 8 * (DH * hf + dt) + 2 * ti,
                    carry[dt][2 * hh], carry[dt][2 * hh + 1]);
      }
    __syncthreads();

    // the state update, latents [16 lt, +16) x the head dim's half hf: this
    // tile's f1 v (f1 in two parts from shared memory), four column pairs at
    // a time (eight independent chains of MMAs), added to the carry once
    {
      constexpr int NP = DH / 2, G = NP < 4 ? NP : 4;
#pragma unroll
      for (int n0 = 0; n0 < NP; n0 += G) {
        float t2[G][2][4] = {};
#pragma unroll
        for (int kt = 0; kt < 4; ++kt) {
          uint32_t fa_h[4], fa_l[4];
          ldsm(fa_h, sm + L::F1H + (16 * lt + r8 + hi8) * FS + 16 * kt + hi16);
          ldsm(fa_l, sm + L::F1L + (16 * lt + r8 + hi8) * FS + 16 * kt + hi16);
#pragma unroll
          for (int np = 0; np < G; ++np) {
            uint32_t vb[4];
            ldsm_t(vb, vs_t + (16 * kt + r8 + hi8) * DS + 8 * DH * hf + 16 * (n0 + np) + hi16);
#pragma unroll
            for (int p = 0; p < 2; ++p) {
              mma_bf16(t2[np][p], fa_l, vb[2 * p], vb[2 * p + 1]);
              mma_bf16(t2[np][p], fa_h, vb[2 * p], vb[2 * p + 1]);
            }
          }
        }
#pragma unroll
        for (int np = 0; np < G; ++np)
#pragma unroll
          for (int p = 0; p < 2; ++p)
#pragma unroll
            for (int r = 0; r < 4; ++r) carry[2 * (n0 + np) + p][r] += t2[np][p][r];
      }
    }

    // ---- phase 2: tokens [16 lt, +16) against the slice's latents, the head
    // dim's half hf
    uint32_t f2h[4][4], f2l[4][4];   // f2^T as A fragments, k = latents [16 kt, +16)
#pragma unroll
    for (int kt = 0; kt < 4; ++kt) {
      ldsm_t(f2h[kt], sm + L::F2H + (16 * kt + r8 + hi16) * FS + 16 * lt + hi8);
      ldsm_t(f2l[kt], sm + L::F2L + (16 * kt + r8 + hi16) * FS + 16 * lt + hi8);
    }
    // the intra-tile mixing a = f2^T f1 over the token tiles up to the warp's
    // own, three products, small terms first; masked to i <= j and split
    // into A fragments (k = tokens [16 kt, +16)) for a v
    uint32_t ah[4][4], al[4][4];
    {
      float ap[8][4] = {};
#pragma unroll
      for (int kt = 0; kt < 4; ++kt)
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          if (np > lt) break;
          uint32_t bh[4], bl[4];
          ldsm_t(bh, sm + L::F1H + (16 * kt + r8 + hi8) * FS + 16 * np + hi16);
          ldsm_t(bl, sm + L::F1L + (16 * kt + r8 + hi8) * FS + 16 * np + hi16);
#pragma unroll
          for (int p = 0; p < 2; ++p) {
            mma_bf16(ap[2 * np + p], f2l[kt], bh[2 * p], bh[2 * p + 1]);
            mma_bf16(ap[2 * np + p], f2h[kt], bl[2 * p], bl[2 * p + 1]);
            mma_bf16(ap[2 * np + p], f2h[kt], bh[2 * p], bh[2 * p + 1]);
          }
        }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          if (8 * nt + 2 * ti + (r & 1) > 16 * lt + gi + 8 * (r >> 1)) ap[nt][r] = 0.f;
#pragma unroll
      for (int kt = 0; kt < 4; ++kt)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          split_bf16(ap[2 * kt + (r >> 1)][2 * (r & 1)], ap[2 * kt + (r >> 1)][2 * (r & 1) + 1],
                     ah[kt][r], al[kt][r]);
    }
    // y = f2^T num (the carried decode, three products) + a v (two); each k
    // step's MMAs go to every column tile of the half, so no MMA waits on
    // the one before it
    {
      float y[DH][4] = {};
      const int c0 = 8 * DH * hf;   // the half's first column
#pragma unroll
      for (int kt = 0; kt < 4; ++kt)
#pragma unroll
        for (int np = 0; np < DH / 2; ++np) {
          uint32_t nh[4], nlo[4];
          ldsm_t(nh, sm + L::NH + (16 * kt + r8 + hi8) * DS + c0 + 16 * np + hi16);
          ldsm_t(nlo, sm + L::NL + (16 * kt + r8 + hi8) * DS + c0 + 16 * np + hi16);
#pragma unroll
          for (int p = 0; p < 2; ++p) {
            mma_bf16(y[2 * np + p], f2l[kt], nh[2 * p], nh[2 * p + 1]);
            mma_bf16(y[2 * np + p], f2h[kt], nlo[2 * p], nlo[2 * p + 1]);
            mma_bf16(y[2 * np + p], f2h[kt], nh[2 * p], nh[2 * p + 1]);
          }
        }
#pragma unroll
      for (int kt = 0; kt < 4; ++kt) {
        if (kt > lt) break;
#pragma unroll
        for (int np = 0; np < DH / 2; ++np) {
          uint32_t vb[4];
          ldsm_t(vb, vs_t + (16 * kt + r8 + hi8) * DS + c0 + 16 * np + hi16);
#pragma unroll
          for (int p = 0; p < 2; ++p) {
            mma_bf16(y[2 * np + p], al[kt], vb[2 * p], vb[2 * p + 1]);
            mma_bf16(y[2 * np + p], ah[kt], vb[2 * p], vb[2 * p + 1]);
          }
        }
      }
      // the slice's partial for the warp's tokens, and their statistics
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int j = 16 * lt + gi + 8 * hh;
        if (j >= tn) continue;
        float* pj = part_g + (long long)(t0 + j) * Dr + c0;
#pragma unroll
        for (int dt = 0; dt < DH; ++dt)
#pragma unroll
          for (int c = 0; c < 2; ++c)
            if (c0 + 8 * dt + 2 * ti + c < Dr) pj[8 * dt + 2 * ti + c] = y[dt][2 * hh + c];
        if (hf == 0 && ti == 0) {
          float* sj = stat_g + (long long)(t0 + j) * 2;
          sj[0] = sw.tok_mx[j];
          sj[1] = (sw.col_sum[j] + sw.col_sum[CT + j]) +
                  (sw.col_sum[2 * CT + j] + sw.col_sum[3 * CT + j]);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The fp32 route on the TF32 tensor cores (mma.sync m16n8k8; every fp32
// operand split hi + lo, three MMAs a product), the factored form of the
// bf16 route on 32-token tiles. Every product contracts in pair order: an
// 8-wide step's k indices t and t + 4 are its columns (rows) 2t and 2t + 1,
// so an A fragment is two float2 reads, a [n][k] B fragment one, and an
// accumulator's columns (2t, 2t + 1) are the next product's A fragment as
// they stand (flare_mma.cuh).

template <int DP>
struct TfLayout {   // shared memory of causal_tf32_kernel, in floats: q split once,
                    // the rest raw fp32, split into TF32 parts as a fragment is read
  static constexpr int QS = DP + 8;   // q and k rows: float2 reads at (g, 2t) hit 32 banks
  static constexpr int VS = DP + 4;   // v and numerator rows: reads at (2t, g) hit 32 banks
  static constexpr int F1S = TT + 8;  // f1 rows, latent-major (float2 reads at (g, 2t))
  static constexpr int FTS = CL + 8;  // f1 and f2 rows, token-major (float2 reads at (g, 2t))
  static constexpr int MS = TT + 8;   // the mixing's rows (float2 reads at (g, 2t))
  static constexpr int QH = 0;                  // the slice's q [CL][QS], split once:
  static constexpr int QL = QH + CL * QS;       // its TF32 hi and lo words
  static constexpr int K = QL + CL * QS;        // k, two buffers [2][TT][QS]
  static constexpr int V = K + 2 * TT * QS;     // v, two buffers [2][TT][VS]
  static constexpr int NUM = V + 2 * TT * VS;   // the carried numerator [CL][VS]
  static constexpr int F1 = NUM + CL * VS;      // f1 [CL][F1S]
  static constexpr int F1T = F1 + CL * F1S;     // f1 transposed [TT][FTS]
  static constexpr int F2T = F1T + TT * FTS;    // f2 transposed [TT][FTS]
  static constexpr int MIX = F2T + TT * FTS;    // the intra-tile mixing a [TT][MS]
  static constexpr int END = MIX + TT * MS;     // then the exchange arrays
  static constexpr int BYTES = (END + 9 * TT + 4 * CL) * 4;   // 208 KB at DP 128
};

// The A fragment of rows r and r + 8 (ra, rb at the step's first column) in
// pair order, split
__device__ __forceinline__ void frag_pairs(FragA& f, const float* ra, const float* rb) {
  const float2 x = *reinterpret_cast<const float2*>(ra);
  const float2 y = *reinterpret_cast<const float2*>(rb);
  split_a(f, x.x, y.x, x.y, y.y);
}

// The same from a tile split when it was staged: the hi words at ra and rb,
// the lo words `lo` floats on
__device__ __forceinline__ void frag_pairs_split(FragA& f, const float* ra, const float* rb,
                                                 int lo) {
  const float2 xh = *reinterpret_cast<const float2*>(ra);
  const float2 yh = *reinterpret_cast<const float2*>(rb);
  const float2 xl = *reinterpret_cast<const float2*>(ra + lo);
  const float2 yl = *reinterpret_cast<const float2*>(rb + lo);
  const float hi[4] = {xh.x, yh.x, xh.y, yh.y}, lw[4] = {xl.x, yl.x, xl.y, yl.y};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f.hi[i] = __float_as_uint(hi[i]);
    f.lo[i] = __float_as_uint(lw[i]);
  }
}

// A [n][k] B fragment in pair order (b0, b1 at p[0], p[1]), split
__device__ __forceinline__ uint4 frag_pair_b(const float* p) {
  const float2 x = *reinterpret_cast<const float2*>(p);
  return split_b(x.x, x.y);
}

// Grid (M / CL splits, B*H), fp32 q, k, v. Block = group g, latents
// [split*CL, +CL), at the padded width DP (32, 64, 128) for the head dim
// Dr <= DP (EXACT: Dr == DP). Writes part and stat as causal_tc_kernel does.
// `async`: k and v rows are whole 16-byte units (Dr % 4 == 0, aligned
// strides and bases) and go through cp.async into the next tile's buffer
// while this tile computes; else they are loaded through registers.
template <int DP, bool EXACT>
__global__ void __launch_bounds__(TC_THREADS, 1)
causal_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, float* __restrict__ part,
                   float* __restrict__ stat, int H, int M, int N, int d_run, Strides ks,
                   Strides vs, bool async) {
  using L = TfLayout<DP>;
  constexpr int QS = L::QS, VS = L::VS, F1S = L::F1S, FTS = L::FTS;
  constexpr int DH = DP / 16;   // 8-wide column tiles of a head-dim half (the state update)
  constexpr int DQ = DP / 32;   // ... of a quarter (phase 2)
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float *f1s = sm + L::F1, *f1t = sm + L::F1T, *f2t = sm + L::F2T, *num = sm + L::NUM;
  const TcSwap sw(sm + L::END, TT);
  const int Dr = EXACT ? DP : d_run;
  const int split = blockIdx.x, g = blockIdx.y, b = g / H, h = g % H;
  const int l0 = split * CL, nl = min(CL, M - l0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gi = lane >> 2, ti = lane & 3;
  const float* kg = k + b * ks.b + h * ks.h;
  const float* vg = v + b * vs.b + h * vs.h;
  const float* qh = q + ((long long)h * M + l0) * Dr;
  const long long row = (long long)split * gridDim.y + g;
  float* part_g = part + row * N * Dr;
  float* stat_g = stat + row * N * 2;

  // zero all tiles once: the lanes past Dr and the latents past nl stay
  // zero; q is split into its TF32 parts once, for every tile
  for (int i = tid; i < L::END / 4; i += TC_THREADS)
    reinterpret_cast<float4*>(sm)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();
  for (int i = tid; i < nl * Dr; i += TC_THREADS) {
    const float x = qh[i];
    const uint32_t hi = tf32(x);
    const int at = (i / Dr) * QS + i % Dr;
    sm[L::QH + at] = __uint_as_float(hi);
    sm[L::QL + at] = __uint_as_float(tf32(x - __uint_as_float(hi)));
  }

  auto load_tile = [&](int t0, int buf) {
    const int tn = min(TT, N - t0);
    float* kd = sm + L::K + buf * TT * QS;
    float* vd = sm + L::V + buf * TT * VS;
    if (async) {
      const int units = Dr / 4;
      for (int i = tid; i < TT * units; i += TC_THREADS) {
        const int j = i / units, c = (i % units) * 4;
        const long long n = t0 + min(j, tn - 1);   // rows past N: zero-filled, nothing read
        const int bytes = j < tn ? 16 : 0;
        cp_async16(kd + j * QS + c, kg + n * ks.n + c, bytes);
        cp_async16(vd + j * VS + c, vg + n * vs.n + c, bytes);
      }
      asm volatile("cp.async.commit_group;");
    } else {
      for (int i = tid; i < TT * Dr; i += TC_THREADS) {
        const int j = i / Dr, d = i % Dr;
        const bool in = j < tn;
        kd[j * QS + d] = in ? kg[(long long)(t0 + j) * ks.n + d] : 0.f;
        vd[j * VS + d] = in ? vg[(long long)(t0 + j) * vs.n + d] : 0.f;
      }
    }
  };

  // warp = (lt, hf) in phase 1 and the state update: the 16-row tile lt of
  // latents and a half hf of the tile's tokens (scores) or of the head dim
  // (the update; its carried numerator stays in registers, the max and den
  // held alike by both warps of lt); (tt, dq) in phase 2: the 16-token tile
  // tt and a quarter dq of the head dim. Warps w and w + 4 share a scheduler,
  // so each scheduler holds one warp of each token tile (tt = 1 does twice
  // the mixing of tt = 0)
  const int lt = warp & 3, hf = warp >> 2, tt = warp >> 2, dq = warp & 3;
  float carry[DH][4] = {}, mxr[2] = {NEG_INF, NEG_INF}, denr[2] = {0.f, 0.f};
  bool lv[2];
  for (int hh = 0; hh < 2; ++hh) lv[hh] = 16 * lt + gi + 8 * hh < nl;
  load_tile(0, 0);
  for (int t0 = 0, it = 0; t0 < N; t0 += TT, ++it) {
    const int tn = min(TT, N - t0), buf = it & 1;
    if (async) asm volatile("cp.async.wait_all;" ::: "memory");
    __syncthreads();
    if (t0 + TT < N) load_tile(t0 + TT, buf ^ 1);
    const float* kt_s = sm + L::K + buf * TT * QS;
    const float* vt_s = sm + L::V + buf * TT * VS;

    // ---- phase 1: latents [16 lt, +16) against tokens [16 hf, +16), S over
    // the head dim with each step's main product in fp32 sums
    float s[2][4] = {};
    {
      float cs[2][4] = {};
      const float* qa = sm + L::QH + (16 * lt + gi) * QS + 2 * ti;
      const float* kb = kt_s + (16 * hf + gi) * QS + 2 * ti;
#pragma unroll
      for (int kk = 0; kk < DP / 8; ++kk) {
        FragA qf;
        frag_pairs_split(qf, qa + 8 * kk, qa + 8 * QS + 8 * kk, L::QL - L::QH);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
          mma3_out(s[nt], cs[nt], qf, frag_pair_b(kb + 8 * nt * QS + 8 * kk));
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] += cs[nt][e];
    }
    auto tok = [&](int nt, int c) { return 16 * hf + 8 * nt + 2 * ti + c; };
    // each latent's max over the half's tokens, each token's over the tile's latents
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float tm = NEG_INF;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int c = 0; c < 2; ++c)
          if (tok(nt, c) < tn) tm = fmaxf(tm, s[nt][2 * hh + c]);
      tm = quad_max(tm);
      if (ti == 0) sw.row_max[hf * CL + 16 * lt + gi + 8 * hh] = tm;
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float x = fmaxf(lv[0] ? s[nt][c] : NEG_INF, lv[1] ? s[nt][2 + c] : NEG_INF);
        x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
        x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 8));
        x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 16));
        if (gi == 0) sw.col_max[lt * TT + tok(nt, c)] = x;
      }
    __syncthreads();
    // per latent: the reference (the running max with the tile's), f1 and
    // its prefix sums over the half's tokens; per token: the decode weights
    float f1[2][4], cd[2][4], w[2][4], ref[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int l = 16 * lt + gi + 8 * hh;
      ref[hh] = fmaxf(mxr[hh], fmaxf(sw.row_max[l], sw.row_max[CL + l]));
      float run = 0.f;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        float e[2];
#pragma unroll
        for (int c = 0; c < 2; ++c)
          e[c] = lv[hh] && tok(nt, c) < tn ? __expf(s[nt][2 * hh + c] - ref[hh]) : 0.f;
        const float pair = e[0] + e[1];
        float incl = pair;   // inclusive scan over the quad's columns
        float up = __shfl_up_sync(0xffffffffu, incl, 1, 4);
        if (ti >= 1) incl += up;
        up = __shfl_up_sync(0xffffffffu, incl, 2, 4);
        if (ti >= 2) incl += up;
        cd[nt][2 * hh] = run + (incl - pair) + e[0];
        cd[nt][2 * hh + 1] = cd[nt][2 * hh] + e[1];
        f1[nt][2 * hh] = e[0];
        f1[nt][2 * hh + 1] = e[1];
        run += __shfl_sync(0xffffffffu, incl, 3, 4);
      }
      if (ti == 0) sw.row_sum[hf * CL + l] = run;
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = tok(nt, c);
        const float tmx = fmaxf(fmaxf(sw.col_max[col], sw.col_max[TT + col]),
                                fmaxf(sw.col_max[2 * TT + col], sw.col_max[3 * TT + col]));
        if (lt == 0 && gi == 0) sw.tok_mx[col] = tmx;
        w[nt][c] = lv[0] ? __expf(s[nt][c] - tmx) : 0.f;
        w[nt][2 + c] = lv[1] ? __expf(s[nt][2 + c] - tmx) : 0.f;
        float x = w[nt][c] + w[nt][2 + c];
        x += __shfl_xor_sync(0xffffffffu, x, 4);
        x += __shfl_xor_sync(0xffffffffu, x, 8);
        x += __shfl_xor_sync(0xffffffffu, x, 16);
        if (gi == 0) sw.col_sum[lt * TT + col] = x;
      }
    __syncthreads();
    // the carried den on the new reference and the first half's f1 under
    // the second's prefix; f2 = w / cden; f1 (latent-major and transposed),
    // f2 (transposed) and the rescaled carried numerator (this warp's half
    // of the head dim) to shared memory, raw
    float scale[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int l = 16 * lt + gi + 8 * hh;
      scale[hh] = lv[hh] ? __expf(mxr[hh] - ref[hh]) : 0.f;
      const float base = denr[hh] * scale[hh];
      const float below = hf == 1 ? sw.row_sum[l] : 0.f;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int c = 0; c < 2; ++c) cd[nt][2 * hh + c] += base + below;
      denr[hh] = base + sw.row_sum[l] + sw.row_sum[CL + l];
      mxr[hh] = lv[hh] ? ref[hh] : NEG_INF;
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int l = 16 * lt + gi + 8 * hh, j = tok(nt, 0);
        *reinterpret_cast<float2*>(f1s + l * F1S + j) =
            make_float2(f1[nt][2 * hh], f1[nt][2 * hh + 1]);
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          f1t[(j + c) * FTS + l] = f1[nt][2 * hh + c];
          f2t[(j + c) * FTS + l] = w[nt][2 * hh + c] / fmaxf(cd[nt][2 * hh + c], 1e-30f);
        }
      }
#pragma unroll
    for (int dt = 0; dt < DH; ++dt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        carry[dt][2 * hh] *= scale[hh];
        carry[dt][2 * hh + 1] *= scale[hh];
        *reinterpret_cast<float2*>(num + (16 * lt + gi + 8 * hh) * VS + 8 * (DH * hf + dt) +
                                   2 * ti) = make_float2(carry[dt][2 * hh], carry[dt][2 * hh + 1]);
      }
    __syncthreads();

    // the state update, latents [16 lt, +16) x the head dim's half hf: this
    // tile's f1 v (32 tokens, summed in the tensor core from zero), G column
    // tiles at a time, added to the carry once
    {
      constexpr int G = DH < 4 ? DH : 4;
      const float* fa = f1s + (16 * lt + gi) * F1S + 2 * ti;
      const float* vb = vt_s + 2 * ti * VS + 8 * DH * hf + gi;
#pragma unroll
      for (int n0 = 0; n0 < DH; n0 += G) {
        float t2[G][4] = {};
#pragma unroll
        for (int kt = 0; kt < TT / 8; ++kt) {
          FragA a;
          frag_pairs(a, fa + 8 * kt, fa + 8 * F1S + 8 * kt);
#pragma unroll
          for (int j = 0; j < G; ++j) {
            const float* p = vb + 8 * kt * VS + 8 * (n0 + j);
            mma3<false, false>(t2[j], a, split_b(p[0], p[VS]));
          }
        }
#pragma unroll
        for (int j = 0; j < G; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r) carry[n0 + j][r] += t2[j][r];
      }
    }

    // ---- phase 2: tokens [16 tt, +16) against the slice's latents, the head
    // dim's quarter dq: the carried decode f2^T num over 64 latents, each
    // step's main product in fp32 sums. The intra-tile mixing a = f2^T f1
    // (its 16 x 8 tiles up to the diagonal: 2 of token tile 0, 4 of tile 1)
    // is computed once, a tile a warp alongside, masked to i <= j and shared
    // through shared memory; then y += a v over the token tiles up to the
    // warp's own
    {
      float y[DQ][4] = {}, yc[DQ][4] = {}, ap[4] = {}, ac[4] = {};
      const bool mixes = dq < 2 * (tt + 1);   // the warp's mixing tile: columns 8 dq
      const int c0 = 8 * DQ * dq;   // the quarter's first column
      const float* fa = f2t + (16 * tt + gi) * FTS + 2 * ti;
      const float* nb = num + 2 * ti * VS + c0 + gi;
      const float* f1b = f1t + (8 * dq + gi) * FTS + 2 * ti;
#pragma unroll
      for (int kt = 0; kt < CL / 8; ++kt) {
        FragA a;
        frag_pairs(a, fa + 8 * kt, fa + 8 * FTS + 8 * kt);
#pragma unroll
        for (int j = 0; j < DQ; ++j) {
          const float* p = nb + 8 * kt * VS + 8 * j;
          mma3_out(y[j], yc[j], a, split_b(p[0], p[VS]));
        }
        if (mixes) mma3_out(ap, ac, a, frag_pair_b(f1b + 8 * kt));
      }
      float* mix = sm + L::MIX;
      if (mixes) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int i = 16 * tt + gi + 8 * hh, j = 8 * dq + 2 * ti;
          *reinterpret_cast<float2*>(mix + i * L::MS + j) =
              make_float2(j <= i ? ap[2 * hh] + ac[2 * hh] : 0.f,
                          j + 1 <= i ? ap[2 * hh + 1] + ac[2 * hh + 1] : 0.f);
        }
      }
      __syncthreads();   // the mixing is whole
      const float* vb = vt_s + 2 * ti * VS + c0 + gi;
      const float* ma = mix + (16 * tt + gi) * L::MS + 2 * ti;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        if (nt >= 2 * (tt + 1)) break;
        FragA af;
        frag_pairs(af, ma + 8 * nt, ma + 8 * L::MS + 8 * nt);
#pragma unroll
        for (int j = 0; j < DQ; ++j) {
          const float* p = vb + 8 * nt * VS + 8 * j;
          mma3_out(y[j], yc[j], af, split_b(p[0], p[VS]));
        }
      }
      // the slice's partial for the warp's tokens, and their statistics
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int j = 16 * tt + gi + 8 * hh;
        if (j >= tn) continue;
        float* pj = part_g + (long long)(t0 + j) * Dr + c0;
#pragma unroll
        for (int dt = 0; dt < DQ; ++dt)
#pragma unroll
          for (int c = 0; c < 2; ++c)
            if (c0 + 8 * dt + 2 * ti + c < Dr)
              pj[8 * dt + 2 * ti + c] = y[dt][2 * hh + c] + yc[dt][2 * hh + c];
        if (dq == 0 && ti == 0) {
          float* sj = stat_g + (long long)(t0 + j) * 2;
          sj[0] = sw.tok_mx[j];
          sj[1] = (sw.col_sum[j] + sw.col_sum[TT + j]) +
                  (sw.col_sum[2 * TT + j] + sw.col_sum[3 * TT + j]);
        }
      }
    }
  }
}

// Merge the latent splits per token, flash-decoding style: one thread per
// V consecutive d of a token t of group g (V = 4 where D % 4 == 0: one
// 16-byte load a split, the statistics read once for the four);
// y[b, h, t, d] = sum_s w_s part_s / sum_s w_s sum_s, w_s = e^{max_s - max},
// in a fixed order over the splits. D = DC where DC > 0 (an exact width),
// else d_run.
template <typename T, int DC, int V>
__global__ void causal_combine_kernel(const float* __restrict__ part,
                                      const float* __restrict__ stat, T* __restrict__ y,
                                      int H, int N, int d_run, int splits, Strides ys) {
  const int D = DC > 0 ? DC : d_run;
  const int g = blockIdx.y, b = g / H, h = g % H;
  const long long i = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * V;
  if (i >= (long long)N * D) return;
  const long long t = i / D;
  const int d = (int)(i % D);
  const long long groups = gridDim.y;
  float mx = NEG_INF;
  for (int s = 0; s < splits; ++s) mx = fmaxf(mx, stat[((s * groups + g) * N + t) * 2]);
  float num[V] = {}, den = 0.f;
  for (int s = 0; s < splits; ++s) {
    const long long r = (s * groups + g) * N + t;
    const float2 st = *reinterpret_cast<const float2*>(stat + r * 2);
    const float w = expf(st.x - mx);
    den = fmaf(w, st.y, den);
    float p[V];
    if constexpr (V == 4) {
      const float4 p4 = *reinterpret_cast<const float4*>(part + r * D + d);
      p[0] = p4.x, p[1] = p4.y, p[2] = p4.z, p[3] = p4.w;
    } else {
      p[0] = part[r * D + d];
    }
#pragma unroll
    for (int c = 0; c < V; ++c) num[c] = fmaf(w, p[c], num[c]);
  }
  T* yt = y + b * ys.b + h * ys.h + t * ys.n + d;
#pragma unroll
  for (int c = 0; c < V; ++c) yt[c] = from_f<T>(num[c] / den);
}

template <typename T, int DP, bool EXACT>
cudaError_t combine_launch(const float* part, const float* stat, void* y, int B, int H, int N,
                           int D, int splits, Strides ys, cudaStream_t stream) {
  const dim3 grid(cdiv((long long)N * D, 256 * (D % 4 == 0 ? 4 : 1)), B * H);
  if (D % 4 == 0)
    causal_combine_kernel<T, EXACT ? DP : 0, 4>
        <<<grid, 256, 0, stream>>>(part, stat, (T*)y, H, N, D, splits, ys);
  else
    causal_combine_kernel<T, EXACT ? DP : 0, 1>
        <<<grid, 256, 0, stream>>>(part, stat, (T*)y, H, N, D, splits, ys);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// Either route's kernel, then the combine: fp32 causal_tf32_kernel, bf16
// causal_tc_kernel; k and v go by cp.async where their rows are whole
// aligned 16-byte units
template <typename T, int DP, bool EXACT>
cudaError_t causal_launch(const void* q, const void* k, const void* v, void* y, float* part,
                          float* stat, int B, int H, int M, int N, int D, Strides ks,
                          Strides vs, Strides ys, cudaStream_t stream) {
  constexpr int unit = 16 / sizeof(T);   // elements a 16-byte copy
  const int splits = cdiv(M, CL);
  const bool async = D % unit == 0 && aligned16(k) && aligned16(v) &&
                     (ks.b | ks.h | ks.n | vs.b | vs.h | vs.n) % unit == 0;
  const dim3 grid(splits, B * H);
  cudaError_t err;
  if constexpr (std::is_same<T, float>::value) {
    constexpr int bytes = TfLayout<DP>::BYTES;
    err = cudaFuncSetAttribute(causal_tf32_kernel<DP, EXACT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    causal_tf32_kernel<DP, EXACT><<<grid, TC_THREADS, bytes, stream>>>(
        (const float*)q, (const float*)k, (const float*)v, part, stat, H, M, N, D, ks, vs, async);
  } else {
    constexpr int bytes = TcLayout<DP>::BYTES;
    err = cudaFuncSetAttribute(causal_tc_kernel<DP, EXACT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    causal_tc_kernel<DP, EXACT><<<grid, TC_THREADS, bytes, stream>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, part, stat, H, M, N, D, ks, vs, async);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return combine_launch<T, DP, EXACT>(part, stat, y, B, H, N, D, splits, ys, stream);
}

// D from 1 to 128 at its padded width 32, 64 or 128 (a warp of phase 2
// takes a quarter of it, one column tile of 8 at least); a D that is its
// own width (flare_lm's 128) runs an exact instance. The dtype picks the
// route.
cudaError_t causal_d(int dtype, int D, const void* q, const void* k, const void* v, void* y,
                     float* part, float* stat, int B, int H, int M, int N, Strides ks, Strides vs,
                     Strides ys, cudaStream_t s) {
  auto at = [&](auto dp) {
    constexpr int DP = decltype(dp)::value;
    auto run = [&](auto t, auto exact) {
      return causal_launch<decltype(t), DP, decltype(exact)::value>(
          q, k, v, y, part, stat, B, H, M, N, D, ks, vs, ys, s);
    };
    if (dtype == BF16)
      return D == DP ? run(bf16{}, std::true_type{}) : run(bf16{}, std::false_type{});
    return D == DP ? run(0.f, std::true_type{}) : run(0.f, std::false_type{});
  };
  if (D < 1 || D > 128 || (dtype != F32 && dtype != BF16)) return cudaErrorInvalidValue;
  if (D <= 32) return at(std::integral_constant<int, 32>{});
  if (D <= 64) return at(std::integral_constant<int, 64>{});
  return at(std::integral_constant<int, 128>{});
}

}  // namespace

extern "C" {

// Latent splits of the causal kernel: the caller sizes the fp32 partials,
// part [splits, B*H, N, D] and stat [splits, B*H, N, 2], from it.
int flare_causal_splits(int M) { return cdiv(M, CL); }

// q [H, M, D] contiguous; k, v, y [B, H, N, D] with strides (D stride 1),
// 1 <= D <= 128; y takes dtype (fp32 or bf16, as q, k and v).
int flare_causal(const void* q, const void* k, const void* v, void* y, float* part, float* stat,
                 int B, int H, int M, int N, int D, long long ksb, long long ksh, long long ksn,
                 long long vsb, long long vsh, long long vsn, long long ysb, long long ysh,
                 long long ysn, int dtype, void* stream) {
  const Strides ks{ksb, ksh, ksn}, vs{vsb, vsh, vsn}, ys{ysb, ysh, ysn};
  return causal_d(dtype, D, q, k, v, y, part, stat, B, H, M, N, ks, vs, ys, (cudaStream_t)stream);
}

}  // extern "C"
