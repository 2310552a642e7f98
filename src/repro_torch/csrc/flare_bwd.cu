// FLARE fused backward for Hopper (sm_90a), CUDA C++ on the tensor cores.
//
// Replaces the TPU kernels of the JAX package:
//   repro/kernels/flare_packed.py::_fused_bwd_kernel (_bwd_launch), the
//   backward of the packed mixer's custom VJP, with the batch sum of dq
//   that _packed_core_bwd does after it: the flare_fused_bwd entry point;
//   repro/kernels/flare_packed_shard.py::_dz_kernel (_dz_launch): pass (a)
//   alone, the flare_bwd_dz entry point, whose dZ the ranks of a sharded
//   mixer sum before
//   repro/kernels/flare_packed_shard.py::_grads_kernel (_grads_launch):
//   passes (b) and (c) from the merged statistics and the summed dZ, the
//   flare_bwd_grads entry point (dq summed over the batch only; the ranks'
//   parts are added with the other gradients).
// flare_fused_bwd runs the same two halves in the same order, so a sharded
// backward on one rank gives the fused backward's bits.
//
// What it computes, per group g = (b, h), with scores S = q k^T (scale 1),
// encode weights A = softmax_N(S), decode weights W = softmax_M(S), the
// forward's Z = A v and y = W^T Z, and the incoming dy:
//   dZ       = W dy                       (sum over tokens)
//   delta_e  = rowsum(dZ o Z)             (per latent)
//   delta_d  = rowsum(dy o y)             (per token)
//   dS       = A o (dZ v^T - delta_e) + W o (Z dy^T - delta_d)
//   dk = dS^T q,  dv = A^T dZ,  dq = sum_b dS k.
// Residuals (all fp32, written by the fused forward): Z [B,H,M,D], the
// encode's per-latent max and den [B,H,M], and the decode's per-token
// log-sum-exp over latents [B,H,N]. A = exp(S - max - log den) and
// W = exp(S - lse) are recomputed from them; no [M, N] matrix is stored.
//
// What bounds it. Seven products of 2*B*H*M*N*D FLOP each (S, dZ, dW, dA,
// dk, dv, dq) on 3*B*H*N*D inputs: at pde_40k about 6e11 FLOP on ~50 MB,
// bound by arithmetic, 8.764 ms at fp32's 67 TFLOP/s on an H100 SXM. The
// previous version ran every product as an fp32 FMA on the CUDA cores, one
// thread an output row, and said D = 8 was below a tensor-core tile: it took
// 39.947 ms at pde_40k and 132.787 ms at pde_1m on an NVIDIA H100 80GB HBM3
// at 700 W (PERF.md section 6, row 4). That holds for bf16, whose MMA is 16 deep, not
// for TF32: mma.sync.m16n8k8 takes k = 8 = D for the scores, and n = 8 = D
// with k = 8 tokens or latents for the sums.
//
// The design. Three passes, as before, each a warp per 16 * MT output rows
// (MT = 4 latent tiles at D = 8 in (a) and (c), 2 token tiles in (b))
// and every product on the tensor cores (mma.sync m16n8k8, TF32 in, fp32
// accumulate; the helpers are in flare_mma.cuh, shared with the forward):
//   (a) dz_kernel, warps over latents, tokens streamed: S, W, dZ += W dy;
//   (b) dkv_kernel, warps over tokens, latents streamed: S^T, A, W, dS,
//       dk += dS^T q, dv += A^T dZ;
//   (c) dq_kernel, warps over latents, tokens streamed: S, A, W, dS,
//       dq += dS k, per (b, h) and token slice.
//   * Precision. One TF32 rounding (2^-11) of an operand would miss the fp32
//     check (1e-5 of max |grad| against fp64). Each fp32 operand is split
//     into hi = tf32(x) and lo = tf32(x - hi), both rounded to nearest as
//     cvt.rna.tf32.f32 does (by two integer operations), and a product is
//     three MMAs, lo.hi + hi.lo +
//     hi.hi (small terms first), leaving about 2^-21. A bf16 operand is
//     exact in TF32 (lo = 0), and its MMAs with lo are skipped. The sums
//     over the streamed dimension leave the tensor core after each 8-wide
//     step (each step's three MMAs start from zero and are added to the
//     fp32 sums in registers): the tensor core truncates its fp32 additions,
//     so a long chain inside it would drift. Those sums then run in two
//     levels (per staged tile, then across tiles), as the encode's do. The
//     sums over D (S, dZ v^T, Z dy^T) are one MMA step at D = 8; above it
//     each step's main product leaves the tensor core too (dot_d).
//   * Fragments. The streamed operand is staged in shared memory already in
//     the B-fragment order of each lane, split: one 16-byte read a lane for
//     (hi0, hi1, lo0, lo1). Each warp holds its own rows as split A
//     fragments in registers for the whole pass. The score accumulator
//     becomes the next product's A fragment with no data movement: the
//     C fragment's columns (2t, 2t + 1) are taken as the A fragment's k
//     indices (t, t + 4), and the B fragment of that product is staged with
//     its rows in the same order (rows 2t and 2t + 1 for k = t and t + 4).
//   * Exps. Five a (latent, token) pair, as before: W in (a), A and W in (b)
//     and in (c), each pass computing each weight it needs once. Forming
//     dq in (b) instead (dS through shared memory, transposed within its
//     warp, into dq^T = k^T dS; the warps' parts summed in order; one fp32
//     part of dq a block of 2,048 tokens) takes three exps a pair and eight
//     products, but measured slower on an NVIDIA H100 80GB HBM3 at 700 W:
//     22.5 ms for that pass at pde_40k against 10.9 + 9.6 for (b) and (c)
//     (PERF.md section 6), its registers spilling at 255.
//   * Where B*H leaves the card underfilled (pde_1m: 128 per-latent blocks
//     for 132 SMs), (a) and (c) split the tokens over blockIdx.z into fp32
//     partial sums, which sum_kernel adds in order (no atomics); (c) always
//     writes per-(b, h) partials that sum_kernel adds over the splits and
//     the batch into dq [H, M, D]. Deterministic: two calls give equal bits.
//   * Inputs are taken by strides (unit D stride), dk and dv are written
//     through strides; ragged N and M are zero-filled in the staged
//     fragments and masked by infinite statistics (weight exactly 0), and
//     nothing is padded in device memory. Any D from 1 to 64 runs at width
//     8, 16, 32 or 64 (below 8: at 8), lanes d >= D zero; D = 8 has an
//     instance of its own with D known at compile time. At 64 a warp's
//     fragments exceed the register file and spill (ptxas's spills are
//     printed by chip_smoke.py).
//
// Every entry point launches on the given stream, allocates nothing, and
// returns cudaGetLastError() so the caller can raise.

#include "flare_mma.cuh"

namespace {

using namespace flare;

constexpr int WARPS = MMA_WARPS;
constexpr int THREADS = MMA_THREADS;
constexpr int STAGE_FLOATS = 8192;   // floats of staged fragments a tile (32 KB)

// 16-row tiles a warp: the per-latent passes (a) and (c) four at D = 8,
// two up to 16, one above; the per-token pass (b), which holds three
// operands' fragments a tile, two up to 16 and one above (registers).
template <int D> __host__ __device__ constexpr int latent_tiles() {
  return D <= 8 ? 4 : D <= 16 ? 2 : 1;
}
template <int D> __host__ __device__ constexpr int token_tiles() { return D <= 16 ? 2 : 1; }

// c = sum over the KS steps of a[kk] b[kk] (a product summed over D) in
// three TF32 products a step. One step (D = 8) is mma3. Over more, the
// tensor core would truncate its fp32 additions along the chain: at D = 64
// on seamless-m4t's encoder operands that left dq, dk and dv 1.0-1.06e-5 of
// their max off fp64 in fp32 (an NVIDIA H100 80GB HBM3 at 700 W) (the S, dZ v^T and Z dy^T rows feed
// differences such as dZ v^T - delta_e, which cancel). So each step's main
// product (hi.hi) starts from zero and is added in fp32 registers, and the
// small ones (2^-11 of it) chain in the tensor core.
template <bool A_EXACT, bool B_EXACT, int KS>
__device__ __forceinline__ void dot_d(float (&c)[4], const FragA (&a)[KS], const uint4 (&b)[KS]) {
  if constexpr (KS == 1) {
    mma3<A_EXACT, B_EXACT>(c, a[0], b[0]);
  } else {
    float small[4] = {};
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      if (!A_EXACT) mma(small, a[kk].lo, b[kk].x, b[kk].y);
      if (!B_EXACT) mma(small, a[kk].hi, b[kk].z, b[kk].w);
      float z[4];
      mma_z(z, a[kk].hi, b[kk].x, b[kk].y);
#pragma unroll
      for (int e = 0; e < 4; ++e) c[e] += z[e];
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) c[e] += small[e];
  }
}

// ---------------------------------------------------------------------------
// (a) Grid (ceil(M / (WARPS * 16 * MT)), B*H, splits); warp = 16 * MT
// latents of group g over tokens [split*split_len, min(N, (split+1)*split_len)):
// out[split, g, m, :] = sum_n W[m, n] dy_n.
template <typename T, int D, bool EXACT>
__global__ void __launch_bounds__(THREADS)
dz_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ dy,
          const float* __restrict__ lse, float* __restrict__ out, int H, int M, int N,
          int d_run, Strides ks, Strides dys, int split_len) {
  constexpr int KS = D / 8, MT = latent_tiles<D>();
  constexpr int NS = STAGE_FLOATS / (2 * KS * 128 + 8);   // 8-token steps a tile
  constexpr bool E = std::is_same<T, __nv_bfloat16>::value;
  __shared__ uint4 kf_s[NS * KS * 32];    // k, KDIM: the scores' B
  __shared__ uint4 dyf_s[NS * KS * 32];   // dy, !KDIM: dZ's B
  __shared__ __align__(16) float l_s[NS * 8];
  const int Dr = EXACT ? D : d_run;
  const int g = blockIdx.y, b = g / H, h = g % H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, ti = lane & 3;
  const int m0 = (blockIdx.x * WARPS + warp) * 16 * MT;
  const int n0 = blockIdx.z * split_len, n1 = min(N, n0 + split_len);
  const T* kg = k + b * ks.b + h * ks.h;
  const T* dyg = dy + b * dys.b + h * dys.h;
  const float* lg = lse + (long long)g * N;

  FragA qa[MT][KS];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      load_a(qa[i][kk], q + (long long)h * M * Dr, Dr, m0 + 16 * i, M, kk, Dr);
  float tot[MT][KS][4] = {};
  for (int t0 = n0; t0 < n1; t0 += NS * 8) {
    const int tn = min(NS * 8, n1 - t0), steps = (tn + 7) / 8;
    __syncthreads();
    stage_b<T, KS, true>(kf_s, kg, ks.n, t0, tn, steps, Dr);
    stage_b<T, KS, false>(dyf_s, dyg, dys.n, t0, tn, steps, Dr);
    for (int i = threadIdx.x; i < steps * 8; i += THREADS) l_s[i] = i < tn ? lg[t0 + i] : inf();
    __syncthreads();
    if (m0 >= M) continue;
    float acc[MT][KS][4] = {};
#pragma unroll 2
    for (int s = 0; s < steps; ++s) {
      const float2 l2 = reinterpret_cast<const float2*>(l_s)[s * 4 + ti];   // tokens 2t, 2t+1
      uint4 kb[KS];
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) kb[kk] = kf_s[(s * KS + kk) * 32 + lane];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        float c[4] = {};
        dot_d<E, E, KS>(c, qa[i], kb);
        FragA wa;   // the accumulator as an A fragment: columns 2t, 2t+1 as k = t, t+4
        split_a(wa, __expf(c[0] - l2.x), __expf(c[2] - l2.x), __expf(c[1] - l2.y),
                __expf(c[3] - l2.y));
#pragma unroll
        for (int j = 0; j < KS; ++j) {
          float p[4] = {};
          mma3<false, E>(p, wa, dyf_s[(s * KS + j) * 32 + lane]);
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[i][j][r] += p[r];
        }
      }
    }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < KS; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) tot[i][j][r] += acc[i][j][r];
  }
  // C fragment: c0 (row gi, col 2t), c1 (gi, 2t+1), c2 (gi+8, 2t), c3 (gi+8, 2t+1)
  float* o = out + ((long long)blockIdx.z * gridDim.y + g) * M * Dr;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < KS; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int m = m0 + 16 * i + (lane >> 2) + (r >= 2 ? 8 : 0), d = 8 * j + 2 * ti + (r & 1);
        if (m < M && d < Dr) o[(long long)m * Dr + d] = tot[i][j][r];
      }
}

// (b) Grid (ceil(N / (WARPS * 16 * MT)), B*H); warp = 16 * MT tokens of
// group g over all latents: dk_n = sum_m dS[m, n] q_m, dv_n = sum_m A[m, n] dZ_m.
template <typename T, int D, bool EXACT>
__global__ void __launch_bounds__(THREADS)
dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           const float* __restrict__ z, const float* __restrict__ dz,
           const float* __restrict__ mx, const float* __restrict__ den,
           const float* __restrict__ lse, const T* __restrict__ y, const T* __restrict__ dy,
           T* __restrict__ dk, T* __restrict__ dv, int H, int M, int N, int d_run, Strides ks,
           Strides vs, Strides ys, Strides dys, Strides dks, Strides dvs) {
  constexpr int KS = D / 8, MT = token_tiles<D>();
  constexpr int NS = STAGE_FLOATS / (5 * KS * 128 + 16);   // 8-latent steps a tile
  constexpr bool E = std::is_same<T, __nv_bfloat16>::value;
  __shared__ uint4 qk_s[NS * KS * 32];    // q, KDIM: the scores' B
  __shared__ uint4 dzk_s[NS * KS * 32];   // dZ, KDIM: (v dZ^T)'s B
  __shared__ uint4 zk_s[NS * KS * 32];    // Z, KDIM: (dy Z^T)'s B
  __shared__ uint4 qn_s[NS * KS * 32];    // q, !KDIM: dk's B
  __shared__ uint4 dzn_s[NS * KS * 32];   // dZ, !KDIM: dv's B
  __shared__ __align__(16) float le_s[NS * 8];   // encode log-sum-exp per latent
  __shared__ __align__(16) float de_s[NS * 8];   // delta_e = dZ . Z per latent
  const int Dr = EXACT ? D : d_run;
  const int g = blockIdx.y, b = g / H, h = g % H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gi = lane >> 2, ti = lane & 3;
  const int n0 = (blockIdx.x * WARPS + warp) * 16 * MT;
  const T* qh = q + (long long)h * M * Dr;
  const float* zg = z + (long long)g * M * Dr;
  const float* dzg = dz + (long long)g * M * Dr;
  const T* kg = k + b * ks.b + h * ks.h;
  const T* vg = v + b * vs.b + h * vs.h;
  const T* yg = y + b * ys.b + h * ys.h;
  const T* dyg = dy + b * dys.b + h * dys.h;

  FragA ka[MT][KS], va[MT][KS], dya[MT][KS];
  float ld[MT][2], dd[MT][2];   // rows gi and gi + 8: decode log-sum-exp, delta_d
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      load_a(ka[i][kk], kg, ks.n, n0 + 16 * i, N, kk, Dr);
      load_a(va[i][kk], vg, vs.n, n0 + 16 * i, N, kk, Dr);
      load_a(dya[i][kk], dyg, dys.n, n0 + 16 * i, N, kk, Dr);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int n = n0 + 16 * i + gi + 8 * r;
      float x = 0.f;
      if (n < N) {
        for (int d = 0; d < Dr; ++d)
          x = fmaf(to_f(dyg[(long long)n * dys.n + d]), to_f(yg[(long long)n * ys.n + d]), x);
      }
      ld[i][r] = n < N ? lse[(long long)g * N + n] : 0.f;
      dd[i][r] = x;
    }
  }
  float dk_tot[MT][KS][4] = {}, dv_tot[MT][KS][4] = {};
  for (int l0 = 0; l0 < M; l0 += NS * 8) {
    const int tm = min(NS * 8, M - l0), steps = (tm + 7) / 8;
    __syncthreads();
    stage_b<T, KS, true>(qk_s, qh, Dr, l0, tm, steps, Dr);
    stage_b<float, KS, true>(dzk_s, dzg, Dr, l0, tm, steps, Dr);
    stage_b<float, KS, true>(zk_s, zg, Dr, l0, tm, steps, Dr);
    stage_b<T, KS, false>(qn_s, qh, Dr, l0, tm, steps, Dr);
    stage_b<float, KS, false>(dzn_s, dzg, Dr, l0, tm, steps, Dr);
    for (int i = threadIdx.x; i < steps * 8; i += THREADS) {
      float le = inf(), de = 0.f;   // a latent past M: A = 0
      if (i < tm) {
        const long long r = (long long)g * M + l0 + i;
        le = mx[r] + logf(den[r]);
        for (int d = 0; d < Dr; ++d) de = fmaf(dzg[(l0 + i) * Dr + d], zg[(l0 + i) * Dr + d], de);
      }
      le_s[i] = le;
      de_s[i] = de;
    }
    __syncthreads();
    if (n0 >= N) continue;
    float dk_acc[MT][KS][4] = {}, dv_acc[MT][KS][4] = {};
#pragma unroll 2
    for (int s = 0; s < steps; ++s) {
      const float2 le2 = reinterpret_cast<const float2*>(le_s)[s * 4 + ti];   // latents 2t, 2t+1
      const float2 de2 = reinterpret_cast<const float2*>(de_s)[s * 4 + ti];
      uint4 qb[KS], dzb[KS], zb[KS];
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const int at = (s * KS + kk) * 32 + lane;
        qb[kk] = qk_s[at], dzb[kk] = dzk_s[at], zb[kk] = zk_s[at];
      }
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        float sc[4] = {}, p1[4] = {}, p2[4] = {};
        dot_d<E, E, KS>(sc, ka[i], qb);
        dot_d<E, false, KS>(p1, va[i], dzb);
        dot_d<E, false, KS>(p2, dya[i], zb);
        // c0 (token gi, latent 2t), c1 (gi, 2t+1), c2 (gi+8, 2t), c3 (gi+8, 2t+1)
        float ds[4], aw[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int row = r >> 1;
          const float le = r & 1 ? le2.y : le2.x, de = r & 1 ? de2.y : de2.x;
          aw[r] = __expf(sc[r] - le);
          const float w = __expf(sc[r] - ld[i][row]);
          ds[r] = aw[r] * (p1[r] - de) + w * (p2[r] - dd[i][row]);
        }
        FragA dsa, aa;
        split_a(dsa, ds[0], ds[2], ds[1], ds[3]);
        split_a(aa, aw[0], aw[2], aw[1], aw[3]);
#pragma unroll
        for (int j = 0; j < KS; ++j) {
          const int at = (s * KS + j) * 32 + lane;
          float pk[4] = {}, pv[4] = {};
          mma3<false, E>(pk, dsa, qn_s[at]);
          mma3<false, false>(pv, aa, dzn_s[at]);
#pragma unroll
          for (int r = 0; r < 4; ++r) dk_acc[i][j][r] += pk[r], dv_acc[i][j][r] += pv[r];
        }
      }
    }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < KS; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          dk_tot[i][j][r] += dk_acc[i][j][r], dv_tot[i][j][r] += dv_acc[i][j][r];
  }
  T* dkg = dk + b * dks.b + h * dks.h;
  T* dvg = dv + b * dvs.b + h * dvs.h;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < KS; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int n = n0 + 16 * i + gi + (r >= 2 ? 8 : 0), d = 8 * j + 2 * ti + (r & 1);
        if (n < N && d < Dr) {
          dkg[(long long)n * dks.n + d] = from_f<T>(dk_tot[i][j][r]);
          dvg[(long long)n * dvs.n + d] = from_f<T>(dv_tot[i][j][r]);
        }
      }
}

// (c) Grid (ceil(M / (WARPS * 16 * MT)), B*H, splits); warp = 16 * MT
// latents of group g over a token split: part[split, b, h, m, :] = sum_n dS[m, n] k_n.
template <typename T, int D, bool EXACT>
__global__ void __launch_bounds__(THREADS)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          const float* __restrict__ z, const float* __restrict__ dz,
          const float* __restrict__ mx, const float* __restrict__ den,
          const float* __restrict__ lse, const T* __restrict__ y, const T* __restrict__ dy,
          float* __restrict__ part, int H, int M, int N, int d_run, Strides ks, Strides vs,
          Strides ys, Strides dys, int split_len) {
  constexpr int KS = D / 8, MT = latent_tiles<D>();
  constexpr int NS = STAGE_FLOATS / (4 * KS * 128 + 16);   // 8-token steps a tile
  constexpr bool E = std::is_same<T, __nv_bfloat16>::value;
  __shared__ uint4 kk_s[NS * KS * 32];    // k, KDIM: the scores' B
  __shared__ uint4 vk_s[NS * KS * 32];    // v, KDIM: (dZ v^T)'s B
  __shared__ uint4 dyk_s[NS * KS * 32];   // dy, KDIM: (Z dy^T)'s B
  __shared__ uint4 kn_s[NS * KS * 32];    // k, !KDIM: dq's B
  __shared__ __align__(16) float l_s[NS * 8];    // decode log-sum-exp per token
  __shared__ __align__(16) float dd_s[NS * 8];   // delta_d = dy . y per token
  const int Dr = EXACT ? D : d_run;
  const int g = blockIdx.y, b = g / H, h = g % H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gi = lane >> 2, ti = lane & 3;
  const int m0 = (blockIdx.x * WARPS + warp) * 16 * MT;
  const int n0 = blockIdx.z * split_len, n1 = min(N, n0 + split_len);
  const T* kg = k + b * ks.b + h * ks.h;
  const T* vg = v + b * vs.b + h * vs.h;
  const T* yg = y + b * ys.b + h * ys.h;
  const T* dyg = dy + b * dys.b + h * dys.h;
  const float* lg = lse + (long long)g * N;
  const float* zg = z + (long long)g * M * Dr;
  const float* dzg = dz + (long long)g * M * Dr;

  FragA qa[MT][KS], dza[MT][KS], za[MT][KS];
  float le[MT][2], de[MT][2];   // rows gi and gi + 8: encode log-sum-exp, delta_e
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      load_a(qa[i][kk], q + (long long)h * M * Dr, Dr, m0 + 16 * i, M, kk, Dr);
      load_a(dza[i][kk], dzg, Dr, m0 + 16 * i, M, kk, Dr);
      load_a(za[i][kk], zg, Dr, m0 + 16 * i, M, kk, Dr);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int m = m0 + 16 * i + gi + 8 * r;
      float x = 0.f, l = 0.f;   // a latent past M: finite, never written
      if (m < M) {
        for (int d = 0; d < Dr; ++d)
          x = fmaf(dzg[(long long)m * Dr + d], zg[(long long)m * Dr + d], x);
        l = mx[(long long)g * M + m] + logf(den[(long long)g * M + m]);
      }
      le[i][r] = l;
      de[i][r] = x;
    }
  }
  float tot[MT][KS][4] = {};
  for (int t0 = n0; t0 < n1; t0 += NS * 8) {
    const int tn = min(NS * 8, n1 - t0), steps = (tn + 7) / 8;
    __syncthreads();
    stage_b<T, KS, true>(kk_s, kg, ks.n, t0, tn, steps, Dr);
    stage_b<T, KS, true>(vk_s, vg, vs.n, t0, tn, steps, Dr);
    stage_b<T, KS, true>(dyk_s, dyg, dys.n, t0, tn, steps, Dr);
    stage_b<T, KS, false>(kn_s, kg, ks.n, t0, tn, steps, Dr);
    for (int i = threadIdx.x; i < steps * 8; i += THREADS) {
      float l = inf(), x = 0.f;   // a token past the split: W = 0
      if (i < tn) {
        const long long n = t0 + i;
        l = lg[n];
        for (int d = 0; d < Dr; ++d) x = fmaf(to_f(dyg[n * dys.n + d]), to_f(yg[n * ys.n + d]), x);
      }
      l_s[i] = l;
      dd_s[i] = x;
    }
    __syncthreads();
    if (m0 >= M) continue;
    float acc[MT][KS][4] = {};
#pragma unroll 2
    for (int s = 0; s < steps; ++s) {
      const float2 l2 = reinterpret_cast<const float2*>(l_s)[s * 4 + ti];   // tokens 2t, 2t+1
      const float2 d2 = reinterpret_cast<const float2*>(dd_s)[s * 4 + ti];
      uint4 kb[KS], vb[KS], dyb[KS];
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const int at = (s * KS + kk) * 32 + lane;
        kb[kk] = kk_s[at], vb[kk] = vk_s[at], dyb[kk] = dyk_s[at];
      }
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        float sc[4] = {}, p1[4] = {}, p2[4] = {};
        dot_d<E, E, KS>(sc, qa[i], kb);
        dot_d<false, E, KS>(p1, dza[i], vb);
        dot_d<false, E, KS>(p2, za[i], dyb);
        // c0 (latent gi, token 2t), c1 (gi, 2t+1), c2 (gi+8, 2t), c3 (gi+8, 2t+1)
        float ds[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int row = r >> 1;
          const float l = r & 1 ? l2.y : l2.x, dd = r & 1 ? d2.y : d2.x;
          ds[r] = __expf(sc[r] - le[i][row]) * (p1[r] - de[i][row]) +
                  __expf(sc[r] - l) * (p2[r] - dd);
        }
        FragA dsa;
        split_a(dsa, ds[0], ds[2], ds[1], ds[3]);
#pragma unroll
        for (int j = 0; j < KS; ++j) {
          float p[4] = {};
          mma3<false, E>(p, dsa, kn_s[(s * KS + j) * 32 + lane]);
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[i][j][r] += p[r];
        }
      }
    }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < KS; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) tot[i][j][r] += acc[i][j][r];
  }
  float* o = part + ((long long)blockIdx.z * gridDim.y + g) * M * Dr;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < KS; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int m = m0 + 16 * i + gi + (r >= 2 ? 8 : 0), d = 8 * j + 2 * ti + (r & 1);
        if (m < M && d < Dr) o[(long long)m * Dr + d] = tot[i][j][r];
      }
}

// out[i] = sum_c part[c * rows + i]: the token splits of (a), and the splits
// and batch of (c).
template <typename TO>
__global__ void sum_kernel(const float* __restrict__ part, TO* __restrict__ out, long long rows,
                           int count) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rows) return;
  float s = 0.f;
  for (int c = 0; c < count; ++c) s += part[c * rows + i];
  out[i] = from_f<TO>(s);
}

template <typename TO>
cudaError_t sum_launch(const float* part, TO* out, long long rows, int count, cudaStream_t s) {
  sum_kernel<TO><<<cdiv(rows, 256), 256, 0, s>>>(part, out, rows, count);
  return cudaGetLastError();
}

// Operand strides, in the order the entry point takes them.
enum { K = 0, V, Y, DY, DK, DV, N_STRIDED };

template <int D> int latents_a_block() { return WARPS * 16 * latent_tiles<D>(); }
template <int D> int tokens_a_block() { return WARPS * 16 * token_tiles<D>(); }

// Pass (a) into dz [B, H, M, D], with its split sum.
template <typename T, int D, bool EXACT>
cudaError_t dz_launch(const void* q, const void* k, const void* dy, const float* lse, float* dz,
                      float* part, int B, int H, int M, int N, int Dr, const Strides* st,
                      int splits, cudaStream_t s) {
  const int G = B * H;
  const dim3 lat_grid(cdiv(M, latents_a_block<D>()), G, splits);
  dz_kernel<T, D, EXACT><<<lat_grid, THREADS, 0, s>>>(
      (const T*)q, (const T*)k, (const T*)dy, lse, splits > 1 ? part : dz, H, M, N, Dr, st[K],
      st[DY], cdiv(N, splits));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  return sum_launch<float>(part, dz, (long long)G * M * Dr, splits, s);
}

// Passes (b) and (c) from dz, then dq [H, M, D] summed over the splits and
// the batch.
template <typename T, int D, bool EXACT>
cudaError_t grads_launch(const void* q, const void* k, const void* v, const float* z,
                         const float* mx, const float* den, const float* lse, const void* y,
                         const void* dy, const float* dz, void* dq, void* dk, void* dv,
                         float* part, int B, int H, int M, int N, int Dr, const Strides* st,
                         int splits, cudaStream_t s) {
  const int G = B * H;
  const dim3 lat_grid(cdiv(M, latents_a_block<D>()), G, splits);
  const T *qt = (const T*)q, *kt = (const T*)k, *vt = (const T*)v, *yt = (const T*)y,
          *dyt = (const T*)dy;
  dkv_kernel<T, D, EXACT><<<dim3(cdiv(N, tokens_a_block<D>()), G), THREADS, 0, s>>>(
      qt, kt, vt, z, dz, mx, den, lse, yt, dyt, (T*)dk, (T*)dv, H, M, N, Dr, st[K], st[V],
      st[Y], st[DY], st[DK], st[DV]);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dq_kernel<T, D, EXACT><<<lat_grid, THREADS, 0, s>>>(qt, kt, vt, z, dz, mx, den, lse, yt, dyt,
                                                      part, H, M, N, Dr, st[K], st[V], st[Y],
                                                      st[DY], cdiv(N, splits));
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  // part is [splits, B, H, M, D]: add the splits and the batch per (h, m, d)
  return sum_launch<T>(part, (T*)dq, (long long)H * M * Dr, splits * B, s);
}

template <typename T>
cudaError_t dz_d(int D, const void* q, const void* k, const void* dy, const float* lse,
                 float* dz, float* part, int B, int H, int M, int N, const Strides* st,
                 int splits, cudaStream_t s) {
  return at_mma_width(D, [&](auto w, auto exact) {
    return dz_launch<T, decltype(w)::value, decltype(exact)::value>(q, k, dy, lse, dz, part, B,
                                                                    H, M, N, D, st, splits, s);
  });
}

template <typename T>
cudaError_t grads_d(int D, const void* q, const void* k, const void* v, const float* z,
                    const float* mx, const float* den, const float* lse, const void* y,
                    const void* dy, const float* dz, void* dq, void* dk, void* dv, float* part,
                    int B, int H, int M, int N, const Strides* st, int splits, cudaStream_t s) {
  return at_mma_width(D, [&](auto w, auto exact) {
    return grads_launch<T, decltype(w)::value, decltype(exact)::value>(
        q, k, v, z, mx, den, lse, y, dy, dz, dq, dk, dv, part, B, H, M, N, D, st, splits, s);
  });
}

bool unpack_strides(const long long* strides, Strides* st) {
  if (strides == nullptr) return false;
  for (int i = 0; i < N_STRIDED; ++i)
    st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  return true;
}

}  // namespace

extern "C" {

// Pass (a): dz [B, H, M, D] fp32 = W dy over this call's tokens. q [H, M, D]
// contiguous; k and dy by strides (`strides` as for flare_fused_bwd: only
// the k and dy entries are read); lse [B, H, N] fp32. Scratch part, fp32, of
// splits*B*H*M*D (splits from flare_encode_splits).
int flare_bwd_dz(const void* q, const void* k, const void* dy, const float* lse, float* dz,
                 float* part, int B, int H, int M, int N, int D, const long long* strides,
                 int splits, int dtype, void* stream) {
  Strides st[N_STRIDED];
  if (splits < 1 || !unpack_strides(strides, st)) return cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == F32) return dz_d<float>(D, q, k, dy, lse, dz, part, B, H, M, N, st, splits, s);
  if (dtype == BF16)
    return dz_d<__nv_bfloat16>(D, q, k, dy, lse, dz, part, B, H, M, N, st, splits, s);
  return cudaErrorInvalidValue;
}

// Passes (b) and (c) given dz (fp32 [B, H, M, D], the sum of every rank's
// pass (a) in a sharded mixer): dk, dv by strides and dq [H, M, D] of dtype,
// summed over this call's batch and token splits. Operands and scratch as
// for flare_fused_bwd; z, mx and den are the encode's statistics over all
// the tokens, lse this call's tokens' own.
int flare_bwd_grads(const void* q, const void* k, const void* v, const float* z,
                    const float* mx, const float* den, const float* lse, const void* y,
                    const void* dy, const float* dz, void* dq, void* dk, void* dv, float* part,
                    int B, int H, int M, int N, int D, const long long* strides, int splits,
                    int dtype, void* stream) {
  Strides st[N_STRIDED];
  if (splits < 1 || !unpack_strides(strides, st)) return cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == F32)
    return grads_d<float>(D, q, k, v, z, mx, den, lse, y, dy, dz, dq, dk, dv, part, B, H, M, N,
                          st, splits, s);
  if (dtype == BF16)
    return grads_d<__nv_bfloat16>(D, q, k, v, z, mx, den, lse, y, dy, dz, dq, dk, dv, part, B,
                                  H, M, N, st, splits, s);
  return cudaErrorInvalidValue;
}

// q [H, M, D] contiguous; k, v, y, dy [B, H, N, D] and dk, dv (outputs) by
// strides: `strides` holds (b, h, n) element strides of k, v, y, dy, dk, dv
// in that order, each with a unit D stride. z [B, H, M, D], mx, den
// [B, H, M] and lse [B, H, N] are the forward's fp32 residuals, contiguous.
// dq [H, M, D] contiguous of dtype. Scratch, fp32: dz of B*H*M*D, and part
// of splits*B*H*M*D (splits from flare_encode_splits: the per-latent passes
// have the encode's geometry). Pass (a), then passes (b) and (c): the two
// entry points above, in order.
int flare_fused_bwd(const void* q, const void* k, const void* v, const float* z,
                    const float* mx, const float* den, const float* lse, const void* y,
                    const void* dy, void* dq, void* dk, void* dv, float* dz, float* part, int B,
                    int H, int M, int N, int D, const long long* strides, int splits, int dtype,
                    void* stream) {
  const int err = flare_bwd_dz(q, k, dy, lse, dz, part, B, H, M, N, D, strides, splits, dtype,
                               stream);
  if (err != cudaSuccess) return err;
  return flare_bwd_grads(q, k, v, z, mx, den, lse, y, dy, dz, dq, dk, dv, part, B, H, M, N, D,
                         strides, splits, dtype, stream);
}

}  // extern "C"
