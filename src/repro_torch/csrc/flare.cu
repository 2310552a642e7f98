// FLARE encode, decode and fused forward for Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernels of the JAX package:
//   encode_kernel  <- repro/kernels/flare.py::_encode_kernel (flare_encode_pallas)
//   decode_kernel  <- repro/kernels/flare.py::_decode_kernel (flare_decode_pallas)
//   the fused forward: repro_torch/kernels/flare_packed.py calls the
//   flare_encode entry point with statistics, then flare_decode over fp32 Z
//                  <- repro/kernels/flare_packed.py::_fused_fwd_kernel (_fwd_launch)
//   the sharded forward's two kernels, in repro_torch/kernels/flare_packed_shard.py:
//   flare_enc_stats, the encode writing its numerator before the normalisation
//                  <- repro/kernels/flare_packed_shard.py::_enc_stats_kernel
//   flare_decode against the merged Z, with each token's log-sum-exp
//                  <- repro/kernels/flare_packed_shard.py::_decode_kernel
//
// What bounds them. At the paper's head dim (D = 8) every (latent, token)
// pair costs 2*D FMAs (score and weighted sum) and one exp, against 2*D*4
// bytes of K and V per token that every latent row reuses: at pde_40k the
// encode does 1.7e11 FLOP on 164 MB, about 1000 FLOP per byte. Each kernel
// is bound by fp32 arithmetic on the CUDA cores (67 TFLOP/s on an H100 SXM),
// not by memory. These kernels stay on the CUDA cores. D = 8 is below a
// bf16 tensor-core tile (16 deep), but not below a TF32 one: mma.sync
// m16n8k8 takes k = 8 = D, and flare_bwd.cu runs the backward's products
// that way, with each fp32 operand split in two TF32 parts for fp32
// accuracy; the forward's turn is later work.
//
// What the design does about it:
//   * one thread owns one output row (a latent row in the encode, a token in
//     the decode) and keeps its online-softmax state (max, den, num[D]) and
//     its query row in registers, so the inner loop is FMAs and exps only;
//   * the streamed operand (K and V tiles, or the head's Q and Z tiles) is
//     staged in shared memory and read by every thread of the block as a
//     broadcast, with no bank conflicts;
//   * scores are taken in chunks of CH: one running-max rescale per chunk,
//     not per element; the sums run in two levels (per shared tile, then
//     across tiles): on the model's own operands at N = 40,000 one running
//     sum was 7.8e-4 off fp64, two levels are 7.2e-6, at no measurable cost;
//   * the TPU's sequential-grid scratch carry becomes the loop inside the
//     block; where a batch of one leaves the card underfilled (pde_1m: 128
//     encode blocks for 132 SMs) the encode splits N over blockIdx.z and a
//     combine kernel merges the partial (max, den, num) in fp32;
//   * the decode cannot hold all M scores per token as the TPU's VMEM does,
//     so it runs an online softmax over latent chunks too;
//   * no padding: ragged N and M are bounds in the loops, the shared tiles
//     are zero-filled past the edge, and masked scores are -1e30, whose exp
//     is exactly 0, so no row comes out NaN;
//   * K, V and Y are taken with strides ([B, H, N, D] views of [B, N, H*D]
//     activations), so the model never copies a transposed tensor;
//   * for training, the fused forward also has the decode write each token's
//     log-sum-exp over the latents (an O(N) fp32 residual): the backward
//     kernels in flare_bwd.cu recompute the decode weights from it, since a
//     per-latent thread cannot see all M scores of a token. The pallas path
//     passes null and writes nothing;
//   * a sharded forward splits the tokens over ranks, and a rank's encode is
//     only part of the sum over N: flare_enc_stats writes the numerator
//     against the rank's own max with that max and den (from the unsplit
//     grid directly, or from combine_kernel), so the ranks can merge them
//     before the normalisation; the decode then runs against the merged Z;
//   * any head dim D from 1 to 64: each kernel is built at the padded widths
//     4, 8, 16, 32 and 64 (flare_common.cuh) and D runs at the next one,
//     lanes d >= D zero where operands are loaded or staged; in device
//     memory every tensor keeps its own D. D = 4 and D = 8 have instances
//     of their own with D known at compile time, so the paper's head dim
//     pays nothing for the others. At 64 the register arrays of a
//     row (state, query and partial sums) exceed the register file and
//     spill; ptxas's spill bytes are printed by chip_smoke.py.
//
// Every entry point launches on the given stream, allocates nothing, and
// returns cudaGetLastError() so the caller can raise.

#include "flare_common.cuh"

namespace {

using namespace flare;

constexpr int CH = 16;  // scores per chunk (one rescale per chunk)

// Online-softmax state of one output row, summed in two levels: the scores
// of the current shared tile go into partial sums (den, acc) taken against
// the running max mx, and each finished tile is folded into the totals. A
// total then carries about N / tile + tile roundings instead of N.
template <int D>
struct Online {
  float mx = NEG_INF, den = 0.f, acc[D];          // this tile, against mx
  float tot_mx = NEG_INF, tot_den = 0.f, tot[D];  // finished tiles, against tot_mx

  __device__ __forceinline__ Online() {
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] = tot[d] = 0.f;
  }

  // One step over `cnt` (<= CH) staged rows: scores x . key[j], with a
  // single rescale of the tile's partial sums for the chunk.
  __device__ __forceinline__ void chunk(const float (&x)[D], const float* key,
                                        const float* val, int cnt) {
    float s[CH];
    float cmax = NEG_INF;
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      float a = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) a = fmaf(x[d], key[j * D + d], a);
      s[j] = j < cnt ? a : NEG_INF;
      cmax = fmaxf(cmax, s[j]);
    }
    const float mnew = fmaxf(mx, cmax);
    const float alpha = __expf(mx - mnew);
    den *= alpha;
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] *= alpha;
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      const float p = j < cnt ? __expf(s[j] - mnew) : 0.f;
      den += p;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] = fmaf(p, val[j * D + d], acc[d]);
    }
    mx = mnew;
  }

  // Fold the tile's partial sums into the totals (mx >= tot_mx).
  __device__ __forceinline__ void fold() {
    const float alpha = __expf(tot_mx - mx);
    tot_den = fmaf(tot_den, alpha, den);
#pragma unroll
    for (int d = 0; d < D; ++d) {
      tot[d] = fmaf(tot[d], alpha, acc[d]);
      acc[d] = 0.f;
    }
    tot_mx = mx;
    den = 0.f;
  }
};

// Encode. Grid (ceil(M / ENC_THREADS), B*H, splits); thread = latent row m of
// group g = b*H + h over tokens [split*split_len, min(N, (split+1)*split_len)).
// D is the padded width, Dr the head dim in device memory (D itself where
// EXACT, else d_run).
// splits == 1: writes z[g, m, :] = num/den (and mx/den when given); `raw`
// writes num itself, against mx, the flash statistics a rank merges.
// splits > 1: writes the partial (max, den, num[Dr]) to part[split, g, m, :].
template <typename T, typename TZ, int D, bool EXACT>
__global__ void __launch_bounds__(ENC_THREADS)
encode_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              TZ* __restrict__ z, float* __restrict__ mx_out, float* __restrict__ den_out,
              float* __restrict__ part, int H, int M, int N, int d_run, Strides ks,
              Strides vs, int split_len, bool raw) {
  constexpr int TN = TILE_FLOATS / D;
  const int Dr = EXACT ? D : d_run;
  __shared__ float k_s[TILE_FLOATS];
  __shared__ float v_s[TILE_FLOATS];
  const int g = blockIdx.y, b = g / H, h = g % H;
  const int m = blockIdx.x * ENC_THREADS + threadIdx.x;
  const int n0 = blockIdx.z * split_len;
  const int n1 = min(N, n0 + split_len);
  const T* kg = k + b * ks.b + h * ks.h;
  const T* vg = v + b * vs.b + h * vs.h;

  float x[D];
#pragma unroll
  for (int d = 0; d < D; ++d)
    x[d] = (m < M && d < Dr) ? to_f(q[((long long)h * M + m) * Dr + d]) : 0.f;
  Online<D> st;
  for (int t0 = n0; t0 < n1; t0 += TN) {
    const int tn = min(TN, n1 - t0);
    __syncthreads();
    stage<T, D>(k_s, kg, ks.n, t0, tn, TN, Dr);
    stage<T, D>(v_s, vg, vs.n, t0, tn, TN, Dr);
    __syncthreads();
    for (int c0 = 0; c0 < tn; c0 += CH)
      st.chunk(x, k_s + c0 * D, v_s + c0 * D, min(CH, tn - c0));
    st.fold();
  }
  if (m >= M) return;
  const long long row = (long long)g * M + m;
  if (part == nullptr) {
    const float inv = raw ? 1.f : 1.f / st.tot_den;
#pragma unroll
    for (int d = 0; d < D; ++d)
      if (d < Dr) z[row * Dr + d] = from_f<TZ>(st.tot[d] * inv);
    if (mx_out != nullptr) {
      mx_out[row] = st.tot_mx;
      den_out[row] = st.tot_den;
    }
  } else {
    const long long rows = (long long)gridDim.y * M;
    float* p = part + ((long long)blockIdx.z * rows + row) * (Dr + 2);
    p[0] = st.tot_mx;
    p[1] = st.tot_den;
#pragma unroll
    for (int d = 0; d < D; ++d)
      if (d < Dr) p[2 + d] = st.tot[d];
  }
}

// Merge the N-split partials of the encode: one thread per (g, m) row; `raw`
// writes the merged numerator against the merged max, as the unsplit grid does.
template <typename TZ, int D, bool EXACT>
__global__ void combine_kernel(const float* __restrict__ part, TZ* __restrict__ z,
                               float* __restrict__ mx_out, float* __restrict__ den_out,
                               long long rows, int splits, int d_run, bool raw) {
  const int Dr = EXACT ? D : d_run;
  const long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= rows) return;
  float mx = NEG_INF;
  for (int s = 0; s < splits; ++s) mx = fmaxf(mx, part[(s * rows + row) * (Dr + 2)]);
  float den = 0.f, acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;
  for (int s = 0; s < splits; ++s) {
    const float* p = part + (s * rows + row) * (Dr + 2);
    const float w = __expf(p[0] - mx);
    den = fmaf(w, p[1], den);
#pragma unroll
    for (int d = 0; d < D; ++d)
      if (d < Dr) acc[d] = fmaf(w, p[2 + d], acc[d]);
  }
  const float inv = raw ? 1.f : 1.f / den;
#pragma unroll
  for (int d = 0; d < D; ++d)
    if (d < Dr) z[row * Dr + d] = from_f<TZ>(acc[d] * inv);
  if (mx_out != nullptr) {
    mx_out[row] = mx;
    den_out[row] = den;
  }
}

// Decode. Grid (ceil(N / DEC_THREADS), B*H); thread = token n of group g:
// y[b, h, n, :] = softmax_m(k_n . q_m) z[g, m, :], online over latent tiles
// of the head's Q and the group's Z staged in shared memory.
template <typename T, typename TZ, int D, bool EXACT>
__global__ void __launch_bounds__(DEC_THREADS)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k, const TZ* __restrict__ z,
              T* __restrict__ y, float* __restrict__ lse_out, int H, int M, int N, int d_run,
              Strides ks, Strides ys) {
  constexpr int TM = TILE_FLOATS / D;
  const int Dr = EXACT ? D : d_run;
  __shared__ float q_s[TILE_FLOATS];
  __shared__ float z_s[TILE_FLOATS];
  const int g = blockIdx.y, b = g / H, h = g % H;
  const int n = blockIdx.x * DEC_THREADS + threadIdx.x;
  const T* qh = q + (long long)h * M * Dr;
  const TZ* zg = z + (long long)g * M * Dr;

  float x[D];
  const T* kn = k + b * ks.b + h * ks.h + (long long)n * ks.n;
#pragma unroll
  for (int d = 0; d < D; ++d) x[d] = (n < N && d < Dr) ? to_f(kn[d]) : 0.f;
  Online<D> st;
  for (int m0 = 0; m0 < M; m0 += TM) {
    const int tm = min(TM, M - m0);
    __syncthreads();
    stage<T, D>(q_s, qh, Dr, m0, tm, TM, Dr);
    stage<TZ, D>(z_s, zg, Dr, m0, tm, TM, Dr);
    __syncthreads();
    for (int c0 = 0; c0 < tm; c0 += CH)
      st.chunk(x, q_s + c0 * D, z_s + c0 * D, min(CH, tm - c0));
    st.fold();
  }
  if (n >= N) return;
  const float inv = 1.f / st.tot_den;
  T* yn = y + b * ys.b + h * ys.h + (long long)n * ys.n;
#pragma unroll
  for (int d = 0; d < D; ++d)
    if (d < Dr) yn[d] = from_f<T>(st.tot[d] * inv);
  if (lse_out != nullptr) lse_out[(long long)g * N + n] = st.tot_mx + logf(st.tot_den);
}

template <typename T, typename TZ, int D, bool EXACT>
cudaError_t encode_launch(const void* q, const void* k, const void* v, void* z, float* mx,
                          float* den, float* part, int B, int H, int M, int N, int Dr,
                          Strides ks, Strides vs, int splits, bool raw, cudaStream_t stream) {
  const int split_len = cdiv(N, splits);
  dim3 grid(cdiv(M, ENC_THREADS), B * H, splits);
  encode_kernel<T, TZ, D, EXACT><<<grid, ENC_THREADS, 0, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (TZ*)z, mx, den, splits > 1 ? part : nullptr,
      H, M, N, Dr, ks, vs, split_len, raw);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const long long rows = (long long)B * H * M;
  combine_kernel<TZ, D, EXACT><<<cdiv(rows, 256), 256, 0, stream>>>(part, (TZ*)z, mx, den,
                                                                     rows, splits, Dr, raw);
  return cudaGetLastError();
}

template <typename T, typename TZ, int D, bool EXACT>
cudaError_t decode_launch(const void* q, const void* k, const void* z, void* y, float* lse,
                          int B, int H, int M, int N, int Dr, Strides ks, Strides ys,
                          cudaStream_t stream) {
  dim3 grid(cdiv(N, DEC_THREADS), B * H);
  decode_kernel<T, TZ, D, EXACT><<<grid, DEC_THREADS, 0, stream>>>(
      (const T*)q, (const T*)k, (const TZ*)z, (T*)y, lse, H, M, N, Dr, ks, ys);
  return cudaGetLastError();
}

// Any D from 1 to 64, at its padded width (flare_common.cuh).
template <typename T, typename TZ>
cudaError_t encode_d(int D, const void* q, const void* k, const void* v, void* z, float* mx,
                     float* den, float* part, int B, int H, int M, int N, Strides ks,
                     Strides vs, int splits, bool raw, cudaStream_t s) {
  return at_width(D, [&](auto w, auto exact) {
    return encode_launch<T, TZ, decltype(w)::value, decltype(exact)::value>(
        q, k, v, z, mx, den, part, B, H, M, N, D, ks, vs, splits, raw, s);
  });
}

template <typename T, typename TZ>
cudaError_t decode_d(int D, const void* q, const void* k, const void* z, void* y, float* lse,
                     int B, int H, int M, int N, Strides ks, Strides ys, cudaStream_t s) {
  return at_width(D, [&](auto w, auto exact) {
    return decode_launch<T, TZ, decltype(w)::value, decltype(exact)::value>(
        q, k, z, y, lse, B, H, M, N, D, ks, ys, s);
  });
}

}  // namespace

extern "C" {

// N-split of the encode for `sms` multiprocessors: enough blocks for about
// one wave of resident threads (taken as 1024 per SM), each split keeping
// at least 1024 tokens. The caller sizes the partials' scratch from it.
int flare_encode_splits(int groups, int M, int N, int sms) {
  const long long blocks = (long long)groups * cdiv(M, ENC_THREADS);
  const long long wave = (long long)sms * 1024 / ENC_THREADS;
  const long long splits = wave / blocks < N / 1024 ? wave / blocks : N / 1024;
  return splits > 1 ? (int)splits : 1;
}

// q [H, M, D] contiguous; k, v [B, H, N, D] with strides (D stride 1);
// z [B, H, M, D] contiguous of zdtype; mx, den [B, H, M] fp32 or null;
// part fp32 scratch of splits * B*H*M * (D + 2) when splits > 1.
int flare_encode(const void* q, const void* k, const void* v, void* z, float* mx, float* den,
                 float* part, int B, int H, int M, int N, int D, long long ksb, long long ksh,
                 long long ksn, long long vsb, long long vsh, long long vsn, int splits,
                 int dtype, int zdtype, void* stream) {
  if (splits < 1 || (splits > 1 && part == nullptr)) return cudaErrorInvalidValue;
  const Strides ks{ksb, ksh, ksn}, vs{vsb, vsh, vsn};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == F32 && zdtype == F32)
    return encode_d<float, float>(D, q, k, v, z, mx, den, part, B, H, M, N, ks, vs, splits,
                                  false, s);
  if (dtype == BF16 && zdtype == BF16)
    return encode_d<__nv_bfloat16, __nv_bfloat16>(D, q, k, v, z, mx, den, part, B, H, M, N,
                                                  ks, vs, splits, false, s);
  if (dtype == BF16 && zdtype == F32)
    return encode_d<__nv_bfloat16, float>(D, q, k, v, z, mx, den, part, B, H, M, N, ks, vs,
                                          splits, false, s);
  return cudaErrorInvalidValue;
}

// A rank's encode statistics (the sharded forward's first kernel): as
// flare_encode with fp32 output, but num [B, H, M, D] holds the numerator
// sum_n exp(s - mx) v_n before the normalisation, with mx and den [B, H, M]
// (all required, fp32, contiguous). The same grid, splits and scratch.
int flare_enc_stats(const void* q, const void* k, const void* v, float* num, float* mx,
                    float* den, float* part, int B, int H, int M, int N, int D, long long ksb,
                    long long ksh, long long ksn, long long vsb, long long vsh, long long vsn,
                    int splits, int dtype, void* stream) {
  if (splits < 1 || (splits > 1 && part == nullptr) || mx == nullptr || den == nullptr)
    return cudaErrorInvalidValue;
  const Strides ks{ksb, ksh, ksn}, vs{vsb, vsh, vsn};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == F32)
    return encode_d<float, float>(D, q, k, v, num, mx, den, part, B, H, M, N, ks, vs, splits,
                                  true, s);
  if (dtype == BF16)
    return encode_d<__nv_bfloat16, float>(D, q, k, v, num, mx, den, part, B, H, M, N, ks, vs,
                                          splits, true, s);
  return cudaErrorInvalidValue;
}

// q [H, M, D] contiguous; k, y [B, H, N, D] with strides; z [B, H, M, D]
// contiguous of zdtype; y takes dtype; lse [B, H, N] fp32 or null: each
// token's log-sum-exp over the latents, the backward's decode statistic.
int flare_decode(const void* q, const void* k, const void* z, void* y, float* lse, int B, int H,
                 int M, int N, int D, long long ksb, long long ksh, long long ksn, long long ysb,
                 long long ysh, long long ysn, int dtype, int zdtype, void* stream) {
  const Strides ks{ksb, ksh, ksn}, ys{ysb, ysh, ysn};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == F32 && zdtype == F32)
    return decode_d<float, float>(D, q, k, z, y, lse, B, H, M, N, ks, ys, s);
  if (dtype == BF16 && zdtype == BF16)
    return decode_d<__nv_bfloat16, __nv_bfloat16>(D, q, k, z, y, lse, B, H, M, N, ks, ys, s);
  if (dtype == BF16 && zdtype == F32)
    return decode_d<__nv_bfloat16, float>(D, q, k, z, y, lse, B, H, M, N, ks, ys, s);
  return cudaErrorInvalidValue;
}

const char* flare_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
