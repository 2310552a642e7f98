// Causal FLARE for Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernel of the JAX package:
//   causal_kernel + causal_combine_kernel
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
// and T = 32,768 that is 206 GFLOP a call, 3.08 ms at the H100's fp32 rate
// (67 TFLOP/s, CUDA cores) against 0.12 ms for the bytes of q, k, v and y.
// The kernel is bound by fp32 arithmetic. Tensor cores (wgmma) are later work.
//
// What does not carry over from the TPU, and the design:
//   * The TPU kernel is one program per group that walks the T tiles in
//     order with the latent state in VMEM. Here the carried numerator is
//     M*D fp32 = 256 KB per group, above a block's 227 KB, and one block per
//     group would give only B*H = 16 blocks for 132 SMs. But the latents are
//     independent of each other in the state; only the decode softmax
//     couples them, through one normaliser per token. So a block takes one
//     group and a slice of CL = 64 latents (M / 64 splits), sweeps all T
//     tiles in order with its slice's state in registers (num) and shared
//     memory (max, den), and writes a flash-decoding partial per token: the
//     decode numerator over its latents against its own max of their scores,
//     and that max and the sum of weights. causal_combine_kernel then merges
//     the splits per token in a fixed order (no atomics, deterministic) and
//     writes y in the output dtype. The slice's own max needs no extra pass
//     over the scores for a global log-sum-exp.
//   * Per tile of CT = 64 tokens a block of 256 threads: stages K (transposed)
//     and V as fp32 in shared memory; forms the 64 x 64 scores with each
//     thread holding a 4 x 4 register tile (one broadcast float4 of q and
//     one of k per 16 FMAs); takes per latent the tile max, the reference,
//     the weights f1 = e^{s - ref} and the running den, 4 threads a latent;
//     takes per token its slice max and decode weights f2 = e^{s - max}/den,
//     4 threads a token; then each thread owns one d and LPT = D/4 latents
//     and walks the tile's tokens in order: num += f1 v, y += f2 num. The
//     decode is the sequential form (two products), not the factored
//     [tile, tile] matrix.
//   * Precision: sums run in two levels. The tile's numerator goes into a
//     fresh fp32 partial (tnum) and its den into a fresh prefix sum; each is
//     folded into the carried state once per tile. At T = 32,768 a carried
//     sum then takes 512 additions, not 32,768 (the lesson of the encode in
//     flare.cu). The decode reads carry + tnum.
//   * bf16 (a deliberate difference): the TPU kernel rounds f1 to v's dtype
//     before the state update. This kernel keeps f1 and all state in fp32;
//     only the loads of q, k, v and the store of y are bf16.
//   * No padding in device memory: a ragged last tile is a loop bound and
//     its missing rows are zero-filled and given zero weight; a ragged last
//     latent slice gives its missing latents zero weight. K, V and Y go by
//     strides ([B, H, T, D] views of [B, T, H*D] activations), so the model
//     copies nothing.
//   * Head dims. The kernel is built for the padded widths DP in {8, 16, 32,
//     64, 128}, and any D from 1 to 128 runs at the next of them: lanes
//     D <= d < DP of q, k and v are zero where they are staged, so they add
//     exactly 0 to every score, and nothing is written to them (the fp32
//     partials are [.., N, D]). A D equal to its width runs an instance of
//     its own with D known at compile time, as before the widening. DP must divide the block's 256 threads: the
//     state update gives each thread one d and LPT = DP / 4 latents. So
//     D = 96 (phi3's width) runs at DP = 128: a DP = 96 instance would leave
//     64 of the 256 threads idle in that phase, which costs what the 32 zero
//     lanes cost, and the score loop's extra lanes are a third of one of the
//     three products.
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

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

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

// Merge the latent splits per token, flash-decoding style: one thread per
// (t, d) of group g; y[b, h, t, d] = sum_s w_s part_s / sum_s w_s sum_s,
// w_s = e^{max_s - max}. A fixed order over the splits. D = DC where DC > 0
// (an exact width), else d_run.
template <typename T, int DC>
__global__ void causal_combine_kernel(const float* __restrict__ part,
                                      const float* __restrict__ stat, T* __restrict__ y,
                                      int H, int N, int d_run, int splits, Strides ys) {
  const int D = DC > 0 ? DC : d_run;
  const int g = blockIdx.y, b = g / H, h = g % H;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)N * D) return;
  const long long t = i / D;
  const int d = (int)(i % D);
  const long long groups = gridDim.y;
  float mx = NEG_INF;
  for (int s = 0; s < splits; ++s) mx = fmaxf(mx, stat[((s * groups + g) * N + t) * 2]);
  float num = 0.f, den = 0.f;
  for (int s = 0; s < splits; ++s) {
    const long long r = (s * groups + g) * N + t;
    const float w = expf(stat[r * 2] - mx);
    den = fmaf(w, stat[r * 2 + 1], den);
    num = fmaf(w, part[r * D + d], num);
  }
  y[b * ys.b + h * ys.h + t * ys.n + d] = from_f<T>(num / den);
}

template <typename T, int DP, bool EXACT>
cudaError_t causal_launch(const void* q, const void* k, const void* v, void* y, float* part,
                          float* stat, int B, int H, int M, int N, int D, Strides ks,
                          Strides vs, Strides ys, cudaStream_t stream) {
  const int splits = cdiv(M, CL);
  constexpr int bytes = Layout<DP>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(causal_kernel<T, DP, EXACT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  causal_kernel<T, DP, EXACT><<<dim3(splits, B * H), C_THREADS, bytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, part, stat, H, M, N, D, ks, vs);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  causal_combine_kernel<T, EXACT ? DP : 0>
      <<<dim3(cdiv((long long)N * D, 256), B * H), 256, 0, stream>>>(part, stat, (T*)y, H, N, D,
                                                                      splits, ys);
  return cudaGetLastError();
}

// D from 1 to 128 at its padded width; a D that is its own width (flare_lm's
// 128, the smoke configuration's 16) runs an exact instance.
template <typename T>
cudaError_t causal_d(int D, const void* q, const void* k, const void* v, void* y, float* part,
                     float* stat, int B, int H, int M, int N, Strides ks, Strides vs,
                     Strides ys, cudaStream_t s) {
  auto at = [&](auto dp) {
    constexpr int DP = decltype(dp)::value;
    return D == DP ? causal_launch<T, DP, true>(q, k, v, y, part, stat, B, H, M, N, D, ks, vs,
                                                ys, s)
                   : causal_launch<T, DP, false>(q, k, v, y, part, stat, B, H, M, N, D, ks, vs,
                                                 ys, s);
  };
  if (D < 1 || D > 128) return cudaErrorInvalidValue;
  if (D <= 8) return at(std::integral_constant<int, 8>{});
  if (D <= 16) return at(std::integral_constant<int, 16>{});
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
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == F32)
    return causal_d<float>(D, q, k, v, y, part, stat, B, H, M, N, ks, vs, ys, s);
  if (dtype == BF16)
    return causal_d<__nv_bfloat16>(D, q, k, v, y, part, stat, B, H, M, N, ks, vs, ys, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
