// FLARE fused backward for Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernel of the JAX package:
//   repro/kernels/flare_packed.py::_fused_bwd_kernel (_bwd_launch), the
//   backward of the packed mixer's custom VJP, with the batch sum of dq
//   that _packed_core_bwd does after it.
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
// and M are loop bounds, and nothing is padded.
//
// The entry point launches on the given stream, allocates nothing, and
// returns cudaGetLastError() so the caller can raise.

#include "flare_common.cuh"

namespace {

using namespace flare;

// (a) Grid (ceil(M / ENC_THREADS), B*H, splits); thread = latent m of group
// g over tokens [split*split_len, min(N, (split+1)*split_len)):
// out[split, g, m, :] = sum_n W[m, n] dy_n.
template <typename T, int D>
__global__ void __launch_bounds__(ENC_THREADS)
dz_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ dy,
          const float* __restrict__ lse, float* __restrict__ out, int H, int M, int N,
          Strides ks, Strides dys, int split_len) {
  constexpr int TN = TILE_FLOATS / D;
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
    x[d] = m < M ? to_f(q[((long long)h * M + m) * D + d]) : 0.f;
    tot[d] = 0.f;
  }
  for (int t0 = n0; t0 < n1; t0 += TN) {
    const int tn = min(TN, n1 - t0);
    __syncthreads();
    stage<T, D>(k_s, kg, ks.n, t0, tn, TN);
    stage<T, D>(dy_s, dyg, dys.n, t0, tn, TN);
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
  float* o = out + (((long long)blockIdx.z * gridDim.y + g) * M + m) * D;
#pragma unroll
  for (int d = 0; d < D; ++d) o[d] = tot[d];
}

// (b) Grid (ceil(N / DEC_THREADS), B*H); thread = token n of group g:
// dk_n = sum_m dS[m, n] q_m and dv_n = sum_m A[m, n] dZ_m, over latent
// tiles of the head's q and the group's Z, dZ and statistics.
template <typename T, int D>
__global__ void __launch_bounds__(DEC_THREADS)
dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           const float* __restrict__ z, const float* __restrict__ dz,
           const float* __restrict__ mx, const float* __restrict__ den,
           const float* __restrict__ lse, const T* __restrict__ y, const T* __restrict__ dy,
           T* __restrict__ dk, T* __restrict__ dv, int H, int M, int N, Strides ks, Strides vs,
           Strides ys, Strides dys, Strides dks, Strides dvs) {
  constexpr int TM = TILE_FLOATS / D;
  __shared__ float q_s[TILE_FLOATS];
  __shared__ float z_s[TILE_FLOATS];
  __shared__ float dz_s[TILE_FLOATS];
  __shared__ float le_s[TM];   // encode log-sum-exp per latent: max + log den
  __shared__ float de_s[TM];   // delta_e = dZ . Z per latent
  const int g = blockIdx.y, b = g / H, h = g % H;
  const int n = blockIdx.x * DEC_THREADS + threadIdx.x;
  const bool live = n < N;
  const T* qh = q + (long long)h * M * D;
  const float* zg = z + (long long)g * M * D;
  const float* dzg = dz + (long long)g * M * D;

  float kx[D], vx[D], dyx[D], dk_tot[D], dv_tot[D];
  const long long nn = live ? n : 0;
  const T* kn = k + b * ks.b + h * ks.h + nn * ks.n;
  const T* vn = v + b * vs.b + h * vs.h + nn * vs.n;
  const T* yn = y + b * ys.b + h * ys.h + nn * ys.n;
  const T* dyn = dy + b * dys.b + h * dys.h + nn * dys.n;
  float dd = 0.f;   // delta_d = dy . y
#pragma unroll
  for (int d = 0; d < D; ++d) {
    kx[d] = live ? to_f(kn[d]) : 0.f;
    vx[d] = live ? to_f(vn[d]) : 0.f;
    dyx[d] = live ? to_f(dyn[d]) : 0.f;
    dd = fmaf(dyx[d], live ? to_f(yn[d]) : 0.f, dd);
    dk_tot[d] = dv_tot[d] = 0.f;
  }
  const float ld = live ? lse[(long long)g * N + n] : 0.f;

  for (int m0 = 0; m0 < M; m0 += TM) {
    const int tm = min(TM, M - m0);
    __syncthreads();
    stage<T, D>(q_s, qh, D, m0, tm, TM);
    stage<float, D>(z_s, zg, D, m0, tm, TM);
    stage<float, D>(dz_s, dzg, D, m0, tm, TM);
    for (int i = threadIdx.x; i < tm; i += blockDim.x) {
      const long long r = (long long)g * M + m0 + i;
      le_s[i] = mx[r] + logf(den[r]);
      float de = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) de = fmaf(dzg[(m0 + i) * D + d], zg[(m0 + i) * D + d], de);
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
    dkn[d] = from_f<T>(dk_tot[d]);
    dvn[d] = from_f<T>(dv_tot[d]);
  }
}

// (c) Grid (ceil(M / ENC_THREADS), B*H, splits); thread = latent m of group
// g over a token split: part[split, b, h, m, :] = sum_n dS[m, n] k_n.
template <typename T, int D>
__global__ void __launch_bounds__(ENC_THREADS)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          const float* __restrict__ z, const float* __restrict__ dz,
          const float* __restrict__ mx, const float* __restrict__ den,
          const float* __restrict__ lse, const T* __restrict__ y, const T* __restrict__ dy,
          float* __restrict__ part, int H, int M, int N, Strides ks, Strides vs, Strides ys,
          Strides dys, int split_len) {
  constexpr int TN = TILE_FLOATS / D;
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
    qx[d] = live ? to_f(q[((long long)h * M + m) * D + d]) : 0.f;
    zx[d] = live ? z[row * D + d] : 0.f;
    dzx[d] = live ? dz[row * D + d] : 0.f;
    de = fmaf(dzx[d], zx[d], de);
    tot[d] = 0.f;
  }
  const float le = live ? mx[row] + logf(den[row]) : 0.f;

  for (int t0 = n0; t0 < n1; t0 += TN) {
    const int tn = min(TN, n1 - t0);
    __syncthreads();
    stage<T, D>(k_s, kg, ks.n, t0, tn, TN);
    stage<T, D>(v_s, vg, vs.n, t0, tn, TN);
    stage<T, D>(dy_s, dyg, dys.n, t0, tn, TN);
    for (int i = threadIdx.x; i < tn; i += blockDim.x) {
      l_s[i] = lg[t0 + i];
      const T* yi = yg + (long long)(t0 + i) * ys.n;
      const T* dyi = dyg + (long long)(t0 + i) * dys.n;
      float dd = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) dd = fmaf(to_f(dyi[d]), to_f(yi[d]), dd);
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
  float* o = part + (((long long)blockIdx.z * gridDim.y + g) * M + m) * D;
#pragma unroll
  for (int d = 0; d < D; ++d) o[d] = tot[d];
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

template <typename T, int D>
cudaError_t bwd_launch(const void* q, const void* k, const void* v, const float* z,
                       const float* mx, const float* den, const float* lse, const void* y,
                       const void* dy, void* dq, void* dk, void* dv, float* dz, float* part,
                       int B, int H, int M, int N, const Strides* st, int splits,
                       cudaStream_t s) {
  const int G = B * H;
  const long long rows = (long long)G * M * D;
  const int split_len = cdiv(N, splits);
  const dim3 lat_grid(cdiv(M, ENC_THREADS), G, splits);
  const T *qt = (const T*)q, *kt = (const T*)k, *vt = (const T*)v, *yt = (const T*)y,
          *dyt = (const T*)dy;

  dz_kernel<T, D><<<lat_grid, ENC_THREADS, 0, s>>>(qt, kt, dyt, lse, splits > 1 ? part : dz,
                                                   H, M, N, st[K], st[DY], split_len);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (splits > 1 && (err = sum_launch<float>(part, dz, rows, splits, s)) != cudaSuccess)
    return err;

  dkv_kernel<T, D><<<dim3(cdiv(N, DEC_THREADS), G), DEC_THREADS, 0, s>>>(
      qt, kt, vt, z, dz, mx, den, lse, yt, dyt, (T*)dk, (T*)dv, H, M, N, st[K], st[V], st[Y],
      st[DY], st[DK], st[DV]);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  dq_kernel<T, D><<<lat_grid, ENC_THREADS, 0, s>>>(qt, kt, vt, z, dz, mx, den, lse, yt, dyt,
                                                   part, H, M, N, st[K], st[V], st[Y], st[DY],
                                                   split_len);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  // part is [splits, B, H, M, D]: add the splits and the batch per (h, m, d)
  return sum_launch<T>(part, (T*)dq, (long long)H * M * D, splits * B, s);
}

template <typename T>
cudaError_t bwd_d(int D, const void* q, const void* k, const void* v, const float* z,
                  const float* mx, const float* den, const float* lse, const void* y,
                  const void* dy, void* dq, void* dk, void* dv, float* dz, float* part, int B,
                  int H, int M, int N, const Strides* st, int splits, cudaStream_t s) {
  switch (D) {
    case 4: return bwd_launch<T, 4>(q, k, v, z, mx, den, lse, y, dy, dq, dk, dv, dz, part, B, H,
                                    M, N, st, splits, s);
    case 8: return bwd_launch<T, 8>(q, k, v, z, mx, den, lse, y, dy, dq, dk, dv, dz, part, B, H,
                                    M, N, st, splits, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q [H, M, D] contiguous; k, v, y, dy [B, H, N, D] and dk, dv (outputs) by
// strides: `strides` holds (b, h, n) element strides of k, v, y, dy, dk, dv
// in that order, each with a unit D stride. z [B, H, M, D], mx, den
// [B, H, M] and lse [B, H, N] are the forward's fp32 residuals, contiguous.
// dq [H, M, D] contiguous of dtype. Scratch, fp32: dz of B*H*M*D, and part
// of splits*B*H*M*D (splits from flare_encode_splits: the per-latent passes
// have the encode's geometry).
int flare_fused_bwd(const void* q, const void* k, const void* v, const float* z,
                    const float* mx, const float* den, const float* lse, const void* y,
                    const void* dy, void* dq, void* dk, void* dv, float* dz, float* part, int B,
                    int H, int M, int N, int D, const long long* strides, int splits, int dtype,
                    void* stream) {
  if (splits < 1 || strides == nullptr) return cudaErrorInvalidValue;
  Strides st[N_STRIDED];
  for (int i = 0; i < N_STRIDED; ++i)
    st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == F32)
    return bwd_d<float>(D, q, k, v, z, mx, den, lse, y, dy, dq, dk, dv, dz, part, B, H, M, N,
                        st, splits, s);
  if (dtype == BF16)
    return bwd_d<__nv_bfloat16>(D, q, k, v, z, mx, den, lse, y, dy, dq, dk, dv, dz, part, B, H,
                                M, N, st, splits, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
