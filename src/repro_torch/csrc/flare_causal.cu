// Causal FLARE for Hopper (sm_90a), CUDA C++: bf16 on the tensor cores,
// fp32 on the CUDA cores.
//
// Replaces the TPU kernel of the JAX package:
//   causal_tc_kernel (bf16) / causal_kernel (fp32) + causal_combine_kernel
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
// exceeds the running max by ~69-85 nats; a 64-token tile narrows that
// against the TPU kernel's 1024).
//
// What bounds it. Three products of 2*M*T*D FLOP per group (scores, the
// state update, the decode): at flare_lm's width (H = 16, M = 512, D = 128)
// and T = 32,768 that is 206 GFLOP a call, 0.208 ms at the H100's bf16
// tensor-core rate (989 TFLOP/s), 3.08 ms at fp32's 67 on the CUDA cores,
// against 0.12 ms for the bytes of q, k, v and y. The previous bf16 route
// ran every product on the CUDA cores in fp32: 17.012 ms at flare_lm's
// layer 0 on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md section 6, row 5).
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
//   * Head dims: any D from 1 to 128 runs at the next padded width DP (fp32:
//     8, 16, 32, 64, 128; bf16: 32, 64, 128), lanes D <= d < DP
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
// fp32, causal_kernel (CUDA cores, as before the tensor cores took bf16):
//   * Per tile a block of 256 threads: stages K (transposed) and V as fp32
//     in shared memory; forms the 64 x 64 scores with each thread holding a
//     4 x 4 register tile (one broadcast float4 of q and one of k per 16
//     FMAs); takes per latent the tile max, the reference, the weights
//     f1 = e^{s - ref} and the running den, 4 threads a latent; takes per
//     token its slice max and decode weights f2 = e^{s - max}/den, 4
//     threads a token; then each thread owns one d and LPT = D/4 latents
//     and walks the tile's tokens in order: num += f1 v, y += f2 num. The
//     decode is the sequential form (two products), not the factored
//     [tile, tile] matrix. The tile's numerator goes into a fresh fp32
//     partial (tnum) and its den into a fresh prefix sum, each folded into
//     the carried state once per tile; the decode reads carry + tnum.
//     DP must divide the block's 256 threads: the state update gives each
//     thread one d and LPT = DP / 4 latents.
//
// The entry point launches on the given stream, allocates nothing (the
// caller gives the fp32 partials), and returns cudaGetLastError().

#include "flare_common.cuh"

namespace {

using namespace flare;

constexpr int CT = 64;               // tokens per tile
constexpr int CL = 64;               // latents per block (one split of M)
constexpr int C_THREADS = 256;
constexpr int KT_STRIDE = CT + 4;    // padded row of the transposed K tile

template <int D>
struct Layout {  // shared memory, in floats, at the padded width D; offsets multiples of 4
  static constexpr int MG = C_THREADS / D;  // latent groups of the update phase
  static constexpr int LPT = CL / MG;       // latents per thread there
  static constexpr int Q = 0;                        // q_t [D][CL]
  static constexpr int K = Q + D * CL;               // k_t [D][KT_STRIDE]
  static constexpr int V = K + D * KT_STRIDE;        // v_s [CT][D]
  static constexpr int S = V + CT * D;               // scores [CT][CL]
  static constexpr int F1 = S + CT * CL;             // e^{s - ref} [CT][CL]
  static constexpr int F2 = F1 + CT * CL;            // den, then decode weights [CT][CL]
  static constexpr int Y = F2 + CT * CL;             // per-group y [MG][CT][D]
  static constexpr int MX = Y + MG * CT * D;         // carried max [CL]
  static constexpr int DEN = MX + CL;                // carried den [CL]
  static constexpr int SCALE = DEN + CL;             // this tile's rescale [CL]
  static constexpr int FLOATS = SCALE + CL;
  static constexpr int BYTES = FLOATS * 4;
};

// Grid (M / CL splits, B*H). Block = group g, latents [split*CL, +CL), at
// the padded width D for the head dim Dr <= D (EXACT: Dr == D, known at
// compile time, so the lane guards fold away).
// Writes part[split, g, t, :Dr] (fp32 decode numerator over the slice) and
// stat[split, g, t, :] = (slice max of the token's scores, sum of weights).
template <typename T, int D, bool EXACT>
__global__ void __launch_bounds__(C_THREADS)
causal_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              float* __restrict__ part, float* __restrict__ stat, int H, int M, int N,
              int d_run, Strides ks, Strides vs) {
  const int Dr = EXACT ? D : d_run;
  using L = Layout<D>;
  constexpr int LPT = L::LPT;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float *q_t = smem + L::Q, *k_t = smem + L::K, *v_s = smem + L::V, *s_t = smem + L::S;
  float *f1 = smem + L::F1, *f2 = smem + L::F2, *ybuf = smem + L::Y;
  float *st_mx = smem + L::MX, *st_den = smem + L::DEN, *st_scale = smem + L::SCALE;

  const int split = blockIdx.x, g = blockIdx.y, b = g / H, h = g % H;
  const int l0 = split * CL, nl = min(CL, M - l0);
  const int tid = threadIdx.x;
  const T* kg = k + b * ks.b + h * ks.h;
  const T* vg = v + b * vs.b + h * vs.h;
  const T* qh = q + ((long long)h * M + l0) * Dr;
  const long long row = (long long)split * gridDim.y + g;
  float* part_g = part + row * N * Dr;
  float* stat_g = stat + row * N * 2;

  for (int i = tid; i < CL * D; i += C_THREADS) {
    const int l = i / D, d = i % D;
    q_t[d * CL + l] = l < nl && d < Dr ? to_f(qh[(long long)l * Dr + d]) : 0.f;
  }
  if (tid < CL) {
    st_mx[tid] = NEG_INF;
    st_den[tid] = 0.f;
  }

  const int sl = (tid / 16) * 4, sj = (tid % 16) * 4;   // score tile: 4 latents x 4 tokens
  const int qd = tid >> 2, qp = tid & 3;                // 4 threads a latent / a token
  const int ud = tid % D, ug = tid / D;                 // update: one d, LPT latents
  float carry[LPT];
#pragma unroll
  for (int l = 0; l < LPT; ++l) carry[l] = 0.f;

  for (int t0 = 0; t0 < N; t0 += CT) {
    const int tn = min(CT, N - t0);
    __syncthreads();
    for (int i = tid; i < CT * D; i += C_THREADS) {
      const int j = i / D, d = i % D;
      const bool in = j < tn && d < Dr;
      k_t[d * KT_STRIDE + j] = in ? to_f(kg[(long long)(t0 + j) * ks.n + d]) : 0.f;
      v_s[i] = in ? to_f(vg[(long long)(t0 + j) * vs.n + d]) : 0.f;
    }
    __syncthreads();

    // scores s[l, j] = q_l . k_j, stored token-major
    {
      float acc[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[a][c] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        const float4 qa = *reinterpret_cast<const float4*>(q_t + d * CL + sl);
        const float4 ka = *reinterpret_cast<const float4*>(k_t + d * KT_STRIDE + sj);
        const float qv[4] = {qa.x, qa.y, qa.z, qa.w}, kv[4] = {ka.x, ka.y, ka.z, ka.w};
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[a][c] = fmaf(qv[a], kv[c], acc[a][c]);
      }
#pragma unroll
      for (int c = 0; c < 4; ++c)
        *reinterpret_cast<float4*>(s_t + (sj + c) * CL + sl) =
            make_float4(acc[0][c], acc[1][c], acc[2][c], acc[3][c]);
    }
    __syncthreads();

    // per latent l (4 threads, 16 tokens each): reference, f1, running den
    {
      const int l = qd;
      const bool lv = l < nl;
      float tmax = NEG_INF;
      for (int jj = 0; jj < 16; ++jj) {
        const int j = qp * 16 + jj;
        if (j < tn) tmax = fmaxf(tmax, s_t[j * CL + l]);
      }
      tmax = quad_max(tmax);
      const float mx = st_mx[l];
      const float ref = fmaxf(mx, tmax);
      const float scale = lv ? expf(mx - ref) : 0.f;
      float c = 0.f;
      for (int jj = 0; jj < 16; ++jj) {
        const int j = qp * 16 + jj;
        const float e = (lv && j < tn) ? expf(s_t[j * CL + l] - ref) : 0.f;
        f1[j * CL + l] = e;
        c += e;
      }
      // exclusive prefix of the four parts' sums
      float before = 0.f, total = 0.f;
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const float cp = __shfl_sync(0xffffffffu, c, (threadIdx.x & 28) | p);
        before += p < qp ? cp : 0.f;
        total += cp;
      }
      const float base = st_den[l] * scale;
      float run = base + before;
      for (int jj = 0; jj < 16; ++jj) {
        const int j = qp * 16 + jj;
        run += f1[j * CL + l];
        f2[j * CL + l] = lv ? run : 1.f;   // the token's den against ref
      }
      __syncwarp();
      if (qp == 0) {
        st_mx[l] = lv ? ref : NEG_INF;
        st_den[l] = base + total;
        st_scale[l] = scale;
      }
    }
    __syncthreads();

    // per token j (4 threads, 16 latents each): decode weights over the
    // slice against the slice's own max, divided by the latent's den
    {
      const int j = qd;
      float mloc = NEG_INF;
      for (int ll = 0; ll < 16; ++ll) {
        const int l = qp * 16 + ll;
        if (l < nl) mloc = fmaxf(mloc, s_t[j * CL + l]);
      }
      mloc = quad_max(mloc);
      float dsum = 0.f;
      for (int ll = 0; ll < 16; ++ll) {
        const int l = qp * 16 + ll;
        const float e = l < nl ? expf(s_t[j * CL + l] - mloc) : 0.f;
        dsum += e;
        f2[j * CL + l] = e / fmaxf(f2[j * CL + l], 1e-30f);
      }
      dsum = quad_sum(dsum);
      if (qp == 0 && j < tn) {
        stat_g[(long long)(t0 + j) * 2] = mloc;
        stat_g[(long long)(t0 + j) * 2 + 1] = dsum;
      }
    }
    __syncthreads();

    // state update and decode, token by token: thread (ud, ug) owns d = ud
    // and latents [ug*LPT, +LPT); tnum is the tile's fresh partial numerator
    {
      float tnum[LPT];
#pragma unroll
      for (int l = 0; l < LPT; ++l) {
        carry[l] *= st_scale[ug * LPT + l];
        tnum[l] = 0.f;
      }
      for (int j = 0; j < tn; ++j) {
        const float vj = v_s[j * D + ud];
        const float* f1j = f1 + j * CL + ug * LPT;
        const float* f2j = f2 + j * CL + ug * LPT;
        float a[4] = {0.f, 0.f, 0.f, 0.f};
        if constexpr (LPT % 4 == 0) {
#pragma unroll
          for (int l = 0; l < LPT; l += 4) {
            const float4 e1 = *reinterpret_cast<const float4*>(f1j + l);
            const float4 e2 = *reinterpret_cast<const float4*>(f2j + l);
            tnum[l] = fmaf(e1.x, vj, tnum[l]);
            tnum[l + 1] = fmaf(e1.y, vj, tnum[l + 1]);
            tnum[l + 2] = fmaf(e1.z, vj, tnum[l + 2]);
            tnum[l + 3] = fmaf(e1.w, vj, tnum[l + 3]);
            a[0] = fmaf(e2.x, carry[l] + tnum[l], a[0]);
            a[1] = fmaf(e2.y, carry[l + 1] + tnum[l + 1], a[1]);
            a[2] = fmaf(e2.z, carry[l + 2] + tnum[l + 2], a[2]);
            a[3] = fmaf(e2.w, carry[l + 3] + tnum[l + 3], a[3]);
          }
        } else {
#pragma unroll
          for (int l = 0; l < LPT; ++l) {
            tnum[l] = fmaf(f1j[l], vj, tnum[l]);
            a[l & 3] = fmaf(f2j[l], carry[l] + tnum[l], a[l & 3]);
          }
        }
        ybuf[(ug * CT + j) * D + ud] = (a[0] + a[1]) + (a[2] + a[3]);
      }
#pragma unroll
      for (int l = 0; l < LPT; ++l) carry[l] += tnum[l];
    }
    __syncthreads();

    // sum the latent groups in order; the split's fp32 partial for the tile
    for (int i = tid; i < tn * Dr; i += C_THREADS) {
      const int j = i / Dr, d = i % Dr;
      float s = 0.f;
#pragma unroll 4
      for (int u = 0; u < L::MG; ++u) s += ybuf[(u * CT + j) * D + d];
      part_g[(long long)t0 * Dr + i] = s;
    }
  }
}

// ---------------------------------------------------------------------------
// The bf16 route on the tensor cores (mma.sync m16n8k16, bf16 in, fp32
// accumulate), the factored form of the TPU kernel.

constexpr int TC_THREADS = 256;   // eight warps: (16-row tile lt, half hf) each

using bf16 = __nv_bfloat16;

// four 8 x 8 bf16 matrices; lane l gives the address of row l % 8 of matrix
// l / 8 (.trans: each matrix transposed)
__device__ __forceinline__ void ldsm(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}

// c += a b, A 16 x 16 (a0 (g, 2t..2t+1), a1 (g+8, ..), a2 (g, 2t+8..), a3
// (g+8, 2t+8..)), B 16 x 8 (b0 (k 2t..2t+1, n g), b1 (k 2t+8.., n g)), C as
// the TF32 MMA's: c0, c1 (g, 2t..2t+1), c2, c3 (g+8, 2t..2t+1)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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

struct TcSwap {   // the fp32 arrays after the bf16 tiles
  float* col_max;   // [4][CT] per latent tile: max over its 16 latents of each token's score
  float* col_sum;   // [4][CT] per latent tile: sum of each token's decode weights
  float* tok_mx;    // [CT] max over the slice of each token's scores
  float* row_max;   // [2][CL] per token half: max of each latent's scores
  float* row_sum;   // [2][CL] per token half: sum of each latent's f1
};

// Grid (M / CL splits, B*H), bf16 q, k, v. Block = group g, latents
// [split*CL, +CL), at the padded width DP (32, 64, 128) for the head dim
// Dr <= DP (EXACT: Dr == DP). Writes part and stat as causal_kernel does.
// `async`: k and v rows are whole 16-byte units (Dr % 8 == 0, aligned
// strides and bases) and go through cp.async into the next tile's buffer
// while this tile computes; else they are loaded through registers.
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
  const TcSwap sw{swap, swap + 4 * CT, swap + 8 * CT, swap + 9 * CT, swap + 9 * CT + 2 * CL};
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

// fp32: the CUDA-core kernel
template <int DP, bool EXACT>
cudaError_t causal_launch(const void* q, const void* k, const void* v, void* y, float* part,
                          float* stat, int B, int H, int M, int N, int D, Strides ks,
                          Strides vs, Strides ys, cudaStream_t stream) {
  const int splits = cdiv(M, CL);
  constexpr int bytes = Layout<DP>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(causal_kernel<float, DP, EXACT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  causal_kernel<float, DP, EXACT><<<dim3(splits, B * H), C_THREADS, bytes, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, part, stat, H, M, N, D, ks, vs);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return combine_launch<float, DP, EXACT>(part, stat, y, B, H, N, D, splits, ys, stream);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// bf16: the tensor-core kernel
template <int DP, bool EXACT>
cudaError_t causal_tc_launch(const void* q, const void* k, const void* v, void* y, float* part,
                             float* stat, int B, int H, int M, int N, int D, Strides ks,
                             Strides vs, Strides ys, cudaStream_t stream) {
  const int splits = cdiv(M, CL);
  constexpr int bytes = TcLayout<DP>::BYTES;
  const bool async = D % 8 == 0 && aligned16(k) && aligned16(v) &&
                     (ks.b | ks.h | ks.n | vs.b | vs.h | vs.n) % 8 == 0;
  cudaError_t err = cudaFuncSetAttribute(causal_tc_kernel<DP, EXACT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  causal_tc_kernel<DP, EXACT><<<dim3(splits, B * H), TC_THREADS, bytes, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, part, stat, H, M, N, D, ks, vs, async);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return combine_launch<bf16, DP, EXACT>(part, stat, y, B, H, N, D, splits, ys, stream);
}

// D from 1 to 128 at its padded width; a D that is its own width (flare_lm's
// 128, the smoke configuration's 16 in fp32) runs an exact instance. fp32
// runs at widths 8 to 128, bf16 (the tensor cores) at 32 to 128: a warp
// takes half the width, two column tiles of 8 at least.
cudaError_t causal_d(int dtype, int D, const void* q, const void* k, const void* v, void* y,
                     float* part, float* stat, int B, int H, int M, int N, Strides ks, Strides vs,
                     Strides ys, cudaStream_t s) {
  auto at = [&](auto dp) {
    constexpr int DP = decltype(dp)::value;
    if (dtype == BF16) {
      if constexpr (DP >= 32)
        return D == DP ? causal_tc_launch<DP, true>(q, k, v, y, part, stat, B, H, M, N, D, ks,
                                                    vs, ys, s)
                       : causal_tc_launch<DP, false>(q, k, v, y, part, stat, B, H, M, N, D, ks,
                                                     vs, ys, s);
      return cudaErrorInvalidValue;
    }
    return D == DP ? causal_launch<DP, true>(q, k, v, y, part, stat, B, H, M, N, D, ks, vs, ys, s)
                   : causal_launch<DP, false>(q, k, v, y, part, stat, B, H, M, N, D, ks, vs, ys,
                                              s);
  };
  if (D < 1 || D > 128 || (dtype != F32 && dtype != BF16)) return cudaErrorInvalidValue;
  if (D <= 8 && dtype == F32) return at(std::integral_constant<int, 8>{});
  if (D <= 16 && dtype == F32) return at(std::integral_constant<int, 16>{});
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
