// FLARE fused backward for Hopper (sm_90a), CUDA C++.
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
// bound by fp32 arithmetic on the CUDA cores (67 TFLOP/s on an H100 SXM), as
// the forward is. D = 8 is below a tensor-core tile; this version stays on
// the CUDA cores.
//
// What the design does about it. The TPU kernel runs two sweeps over token
// tiles of one sequential grid, holding every latent's dZ and dq in VMEM
// and all M scores of a token tile at once. Blocks on Hopper run in no
// order, and a thread can hold one row. So the backward is three passes,
// each with one thread per output row, as in the forward:
//   (a) dz_kernel, a thread per latent over the tokens: dZ_m;
//   (b) dkv_kernel, a thread per token over the latents: dk_n and dv_n
//       (delta_e is formed from the staged dZ and Z, delta_d in registers);
//   (c) dq_kernel, a thread per latent over the tokens: dq_m per (b, h).
// Since the softmax statistics are known, no pass needs an online rescale:
// each weight is one exp. The streamed operands are staged in shared memory
// and read as broadcasts; sums run in two levels (per shared tile, then
// across tiles), as the encode's do. Where B*H leaves the card underfilled
// (pde_1m: 128 per-latent blocks for 132 SMs), (a) and (c) split the tokens
// over blockIdx.z into fp32 partial sums, which sum_kernel adds (no rescale
// is needed). (c) always writes per-(b, h) partials; sum_kernel adds them
// over the splits and the batch into dq [H, M, D]. Inputs are taken by
// strides (unit D stride), dk and dv are written through strides (the
// [B, H, N, D] views of [B, N, H, D] memory the wrapper allocates), ragged N
// and M are loop bounds, and nothing is padded in device memory: any head
// dim D from 1 to 64 runs at its padded width (4, 8, 16, 32 or 64), the
// lanes d >= D zero in registers and shared memory, as in flare.cu, and
// D = 4 and D = 8 have instances of their own with D known at compile time
// (flare_common.cuh::at_width). At 64 the per-row arrays spill.
//
// Every entry point launches on the given stream, allocates nothing, and
// returns cudaGetLastError() so the caller can raise.

#include "flare_common.cuh"

namespace {

using namespace flare;

// (a) Grid (ceil(M / ENC_THREADS), B*H, splits); thread = latent m of group
// g over tokens [split*split_len, min(N, (split+1)*split_len)):
// out[split, g, m, :] = sum_n W[m, n] dy_n.
template <typename T, int D, bool EXACT>
__global__ void __launch_bounds__(ENC_THREADS)
dz_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ dy,
          const float* __restrict__ lse, float* __restrict__ out, int H, int M, int N,
          int d_run, Strides ks, Strides dys, int split_len) {
  constexpr int TN = TILE_FLOATS / D;
  const int Dr = EXACT ? D : d_run;
  __shared__ float k_s[TILE_FLOATS];
  __shared__ float dy_s[TILE_FLOATS];
  __shared__ float l_s[TN];
  const int g = blockIdx.y, b = g / H, h = g % H;
  const int m = blockIdx.x * ENC_THREADS + threadIdx.x;
  const int n0 = blockIdx.z * split_len;
  const int n1 = min(N, n0 + split_len);
  const T* kg = k + b * ks.b + h * ks.h;
  const T* dyg = dy + b * dys.b + h * dys.h;
  const float* lg = lse + (long long)g * N;

  float x[D], tot[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    x[d] = (m < M && d < Dr) ? to_f(q[((long long)h * M + m) * Dr + d]) : 0.f;
    tot[d] = 0.f;
  }
  for (int t0 = n0; t0 < n1; t0 += TN) {
    const int tn = min(TN, n1 - t0);
    __syncthreads();
    stage<T, D>(k_s, kg, ks.n, t0, tn, TN, Dr);
    stage<T, D>(dy_s, dyg, dys.n, t0, tn, TN, Dr);
    for (int i = threadIdx.x; i < tn; i += blockDim.x) l_s[i] = lg[t0 + i];
    __syncthreads();
    float acc[D];
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] = 0.f;
#pragma unroll 4
    for (int j = 0; j < tn; ++j) {
      const float w = __expf(dot<D>(x, k_s + j * D) - l_s[j]);
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] = fmaf(w, dy_s[j * D + d], acc[d]);
    }
#pragma unroll
    for (int d = 0; d < D; ++d) tot[d] += acc[d];
  }
  if (m >= M) return;
  float* o = out + (((long long)blockIdx.z * gridDim.y + g) * M + m) * Dr;
#pragma unroll
  for (int d = 0; d < D; ++d)
    if (d < Dr) o[d] = tot[d];
}

// (b) Grid (ceil(N / DEC_THREADS), B*H); thread = token n of group g:
// dk_n = sum_m dS[m, n] q_m and dv_n = sum_m A[m, n] dZ_m, over latent
// tiles of the head's q and the group's Z, dZ and statistics.
template <typename T, int D, bool EXACT>
__global__ void __launch_bounds__(DEC_THREADS)
dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           const float* __restrict__ z, const float* __restrict__ dz,
           const float* __restrict__ mx, const float* __restrict__ den,
           const float* __restrict__ lse, const T* __restrict__ y, const T* __restrict__ dy,
           T* __restrict__ dk, T* __restrict__ dv, int H, int M, int N, int d_run, Strides ks,
           Strides vs, Strides ys, Strides dys, Strides dks, Strides dvs) {
  constexpr int TM = TILE_FLOATS / D;
  const int Dr = EXACT ? D : d_run;
  __shared__ float q_s[TILE_FLOATS];
  __shared__ float z_s[TILE_FLOATS];
  __shared__ float dz_s[TILE_FLOATS];
  __shared__ float le_s[TM];   // encode log-sum-exp per latent: max + log den
  __shared__ float de_s[TM];   // delta_e = dZ . Z per latent
  const int g = blockIdx.y, b = g / H, h = g % H;
  const int n = blockIdx.x * DEC_THREADS + threadIdx.x;
  const bool live = n < N;
  const T* qh = q + (long long)h * M * Dr;
  const float* zg = z + (long long)g * M * Dr;
  const float* dzg = dz + (long long)g * M * Dr;

  float kx[D], vx[D], dyx[D], dk_tot[D], dv_tot[D];
  const long long nn = live ? n : 0;
  const T* kn = k + b * ks.b + h * ks.h + nn * ks.n;
  const T* vn = v + b * vs.b + h * vs.h + nn * vs.n;
  const T* yn = y + b * ys.b + h * ys.h + nn * ys.n;
  const T* dyn = dy + b * dys.b + h * dys.h + nn * dys.n;
  float dd = 0.f;   // delta_d = dy . y
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const bool on = live && d < Dr;
    kx[d] = on ? to_f(kn[d]) : 0.f;
    vx[d] = on ? to_f(vn[d]) : 0.f;
    dyx[d] = on ? to_f(dyn[d]) : 0.f;
    dd = fmaf(dyx[d], on ? to_f(yn[d]) : 0.f, dd);
    dk_tot[d] = dv_tot[d] = 0.f;
  }
  const float ld = live ? lse[(long long)g * N + n] : 0.f;

  for (int m0 = 0; m0 < M; m0 += TM) {
    const int tm = min(TM, M - m0);
    __syncthreads();
    stage<T, D>(q_s, qh, Dr, m0, tm, TM, Dr);
    stage<float, D>(z_s, zg, Dr, m0, tm, TM, Dr);
    stage<float, D>(dz_s, dzg, Dr, m0, tm, TM, Dr);
    for (int i = threadIdx.x; i < tm; i += blockDim.x) {
      const long long r = (long long)g * M + m0 + i;
      le_s[i] = mx[r] + logf(den[r]);
      float de = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d)
        if (d < Dr) de = fmaf(dzg[(m0 + i) * Dr + d], zg[(m0 + i) * Dr + d], de);
      de_s[i] = de;
    }
    __syncthreads();
    float dk_acc[D], dv_acc[D];
#pragma unroll
    for (int d = 0; d < D; ++d) dk_acc[d] = dv_acc[d] = 0.f;
#pragma unroll 2
    for (int j = 0; j < tm; ++j) {
      const float* qj = q_s + j * D;
      const float* zj = z_s + j * D;
      const float* dzj = dz_s + j * D;
      const float s = dot<D>(kx, qj);
      const float a = __expf(s - le_s[j]);
      const float w = __expf(s - ld);
      const float ds = a * (dot<D>(vx, dzj) - de_s[j]) + w * (dot<D>(dyx, zj) - dd);
#pragma unroll
      for (int d = 0; d < D; ++d) {
        dk_acc[d] = fmaf(ds, qj[d], dk_acc[d]);
        dv_acc[d] = fmaf(a, dzj[d], dv_acc[d]);
      }
    }
#pragma unroll
    for (int d = 0; d < D; ++d) {
      dk_tot[d] += dk_acc[d];
      dv_tot[d] += dv_acc[d];
    }
  }
  if (!live) return;
  T* dkn = dk + b * dks.b + h * dks.h + (long long)n * dks.n;
  T* dvn = dv + b * dvs.b + h * dvs.h + (long long)n * dvs.n;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    if (d < Dr) {
      dkn[d] = from_f<T>(dk_tot[d]);
      dvn[d] = from_f<T>(dv_tot[d]);
    }
  }
}

// (c) Grid (ceil(M / ENC_THREADS), B*H, splits); thread = latent m of group
// g over a token split: part[split, b, h, m, :] = sum_n dS[m, n] k_n.
template <typename T, int D, bool EXACT>
__global__ void __launch_bounds__(ENC_THREADS)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          const float* __restrict__ z, const float* __restrict__ dz,
          const float* __restrict__ mx, const float* __restrict__ den,
          const float* __restrict__ lse, const T* __restrict__ y, const T* __restrict__ dy,
          float* __restrict__ part, int H, int M, int N, int d_run, Strides ks, Strides vs,
          Strides ys, Strides dys, int split_len) {
  constexpr int TN = TILE_FLOATS / D;
  const int Dr = EXACT ? D : d_run;
  __shared__ float k_s[TILE_FLOATS];
  __shared__ float v_s[TILE_FLOATS];
  __shared__ float dy_s[TILE_FLOATS];
  __shared__ float l_s[TN];    // decode log-sum-exp per token
  __shared__ float dd_s[TN];   // delta_d = dy . y per token
  const int g = blockIdx.y, b = g / H, h = g % H;
  const int m = blockIdx.x * ENC_THREADS + threadIdx.x;
  const int n0 = blockIdx.z * split_len;
  const int n1 = min(N, n0 + split_len);
  const T* kg = k + b * ks.b + h * ks.h;
  const T* vg = v + b * vs.b + h * vs.h;
  const T* yg = y + b * ys.b + h * ys.h;
  const T* dyg = dy + b * dys.b + h * dys.h;
  const float* lg = lse + (long long)g * N;

  const bool live = m < M;
  const long long row = (long long)g * M + (live ? m : 0);
  float qx[D], zx[D], dzx[D], tot[D];
  float de = 0.f;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const bool on = live && d < Dr;
    qx[d] = on ? to_f(q[((long long)h * M + m) * Dr + d]) : 0.f;
    zx[d] = on ? z[row * Dr + d] : 0.f;
    dzx[d] = on ? dz[row * Dr + d] : 0.f;
    de = fmaf(dzx[d], zx[d], de);
    tot[d] = 0.f;
  }
  const float le = live ? mx[row] + logf(den[row]) : 0.f;

  for (int t0 = n0; t0 < n1; t0 += TN) {
    const int tn = min(TN, n1 - t0);
    __syncthreads();
    stage<T, D>(k_s, kg, ks.n, t0, tn, TN, Dr);
    stage<T, D>(v_s, vg, vs.n, t0, tn, TN, Dr);
    stage<T, D>(dy_s, dyg, dys.n, t0, tn, TN, Dr);
    for (int i = threadIdx.x; i < tn; i += blockDim.x) {
      l_s[i] = lg[t0 + i];
      const T* yi = yg + (long long)(t0 + i) * ys.n;
      const T* dyi = dyg + (long long)(t0 + i) * dys.n;
      float dd = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d)
        if (d < Dr) dd = fmaf(to_f(dyi[d]), to_f(yi[d]), dd);
      dd_s[i] = dd;
    }
    __syncthreads();
    float acc[D];
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] = 0.f;
#pragma unroll 2
    for (int j = 0; j < tn; ++j) {
      const float* kj = k_s + j * D;
      const float s = dot<D>(qx, kj);
      const float a = __expf(s - le);
      const float w = __expf(s - l_s[j]);
      const float ds = a * (dot<D>(dzx, v_s + j * D) - de) + w * (dot<D>(zx, dy_s + j * D) - dd_s[j]);
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] = fmaf(ds, kj[d], acc[d]);
    }
#pragma unroll
    for (int d = 0; d < D; ++d) tot[d] += acc[d];
  }
  if (!live) return;
  float* o = part + (((long long)blockIdx.z * gridDim.y + g) * M + m) * Dr;
#pragma unroll
  for (int d = 0; d < D; ++d)
    if (d < Dr) o[d] = tot[d];
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

// Pass (a) into dz [B, H, M, D], with its split sum.
template <typename T, int D, bool EXACT>
cudaError_t dz_launch(const void* q, const void* k, const void* dy, const float* lse, float* dz,
                      float* part, int B, int H, int M, int N, int Dr, const Strides* st,
                      int splits, cudaStream_t s) {
  const int G = B * H;
  const dim3 lat_grid(cdiv(M, ENC_THREADS), G, splits);
  dz_kernel<T, D, EXACT><<<lat_grid, ENC_THREADS, 0, s>>>(
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
  const dim3 lat_grid(cdiv(M, ENC_THREADS), G, splits);
  const T *qt = (const T*)q, *kt = (const T*)k, *vt = (const T*)v, *yt = (const T*)y,
          *dyt = (const T*)dy;
  dkv_kernel<T, D, EXACT><<<dim3(cdiv(N, DEC_THREADS), G), DEC_THREADS, 0, s>>>(
      qt, kt, vt, z, dz, mx, den, lse, yt, dyt, (T*)dk, (T*)dv, H, M, N, Dr, st[K], st[V],
      st[Y], st[DY], st[DK], st[DV]);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dq_kernel<T, D, EXACT><<<lat_grid, ENC_THREADS, 0, s>>>(qt, kt, vt, z, dz, mx, den, lse, yt,
                                                          dyt, part, H, M, N, Dr, st[K], st[V],
                                                          st[Y], st[DY], cdiv(N, splits));
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  // part is [splits, B, H, M, D]: add the splits and the batch per (h, m, d)
  return sum_launch<T>(part, (T*)dq, (long long)H * M * Dr, splits * B, s);
}

template <typename T>
cudaError_t dz_d(int D, const void* q, const void* k, const void* dy, const float* lse,
                 float* dz, float* part, int B, int H, int M, int N, const Strides* st,
                 int splits, cudaStream_t s) {
  return at_width(D, [&](auto w, auto exact) {
    return dz_launch<T, decltype(w)::value, decltype(exact)::value>(q, k, dy, lse, dz, part, B,
                                                                    H, M, N, D, st, splits, s);
  });
}

template <typename T>
cudaError_t grads_d(int D, const void* q, const void* k, const void* v, const float* z,
                    const float* mx, const float* den, const float* lse, const void* y,
                    const void* dy, const float* dz, void* dq, void* dk, void* dv, float* part,
                    int B, int H, int M, int N, const Strides* st, int splits, cudaStream_t s) {
  return at_width(D, [&](auto w, auto exact) {
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
