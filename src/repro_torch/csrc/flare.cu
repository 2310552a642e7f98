// FLARE encode, decode and fused forward for Hopper (sm_90a), CUDA C++ on
// the tensor cores.
//
// Replaces the TPU kernels of the JAX package:
//   encode_tc_kernel  <- repro/kernels/flare.py::_encode_kernel (flare_encode_pallas)
//   decode_tc_kernel  <- repro/kernels/flare.py::_decode_kernel (flare_decode_pallas)
//   the fused forward: repro_torch/kernels/flare_packed.py calls the
//   flare_encode entry point with statistics, then flare_decode over fp32 Z
//                  <- repro/kernels/flare_packed.py::_fused_fwd_kernel (_fwd_launch)
//   the sharded forward's two kernels, in repro_torch/kernels/flare_packed_shard.py:
//   flare_enc_stats, the encode writing its numerator before the normalisation
//                  <- repro/kernels/flare_packed_shard.py::_enc_stats_kernel
//   flare_decode against the merged Z, with each token's log-sum-exp
//                  <- repro/kernels/flare_packed_shard.py::_decode_kernel
//
// What bounds them. Every (latent, token) pair costs two products of D
// FMAs each (score and weighted sum) and one exp, against 2*D*4 bytes of K
// and V per token that every latent row reuses: at pde_40k the encode does
// 1.7e11 FLOP on 164 MB, about 1000 FLOP per byte, bound by arithmetic:
// 2.504 ms at fp32's 67 TFLOP/s on an H100 SXM. The previous version ran
// every product as an fp32 FMA on the CUDA cores, one thread an output row:
// the fused forward took 17.030 ms at pde_40k and 56.851 at pde_1m on an
// NVIDIA H100 80GB HBM3 at 700 W (PERF.md section 6, row 3). D = 8 is below
// a bf16 tensor-core tile (16 deep), not below a TF32 one: mma.sync m16n8k8
// takes k = 8 = D for the scores, and n = 8 = D with k = 8 tokens (encode)
// or latents (decode) for the weighted sums. The design's own floors at
// pde_40k: one exp a pair in each kernel at 16 a clock an SM, 2.508 ms for
// the two; four products, each three TF32 MMAs, 2.034 ms at 495 TFLOP/s.
//
// The design, one device routine (sweep) for both kernels, as pass (a) of
// flare_bwd.cu streams tokens against a warp's latent rows:
//   * a warp owns 16 * MT output rows (latents in the encode, tokens in the
//     decode; by default MT = 4 at D = 8, 2 up to 16, 1 above) and holds
//     them as split A fragments for the whole sweep; the streamed score operand (k, or
//     the head's q) and value operand (v, or the group's Z) are staged in
//     shared memory in each lane's B-fragment order, split: one 16-byte
//     read a lane (flare_mma.cuh); the next tile's rows come in by
//     cp.async while this tile computes and are split in shared memory
//     (where their rows are whole aligned 16-byte units: every D that is a
//     multiple of 4 in fp32 or of 8 in bf16, the model's strided views
//     included), so the tile's loads are off the critical path;
//   * scores S = x s^T are three MMAs a step of 8 columns; CH = 4 steps
//     form a chunk, whose per-row max is taken in registers and across the
//     quad with two shuffles, so the running max rescales the sums once a
//     chunk, not once a column; P = e^{S - max} then becomes the A fragment
//     of P v with no data movement (the C fragment's columns 2t, 2t + 1 as
//     k = t, t + 4, the value operand staged with its rows in that order),
//     split: three MMAs, two for a bf16 value operand (exact in TF32);
//   * each step's MMAs start from zero and are added to fp32 sums in
//     registers (the tensor core truncates its additions), and the sums run
//     in two levels: per staged tile (256 columns at D = 8), then across
//     tiles. On the model's own operands at N = 40,000 one running sum was
//     7.8e-4 off fp64, two levels 7.2e-6;
//   * each thread keeps the den of its own two columns of a row; the quad's
//     four are added at the end, in a fixed order;
//   * the TPU's sequential-grid scratch carry becomes the loop inside the
//     block; where a batch of one leaves the card underfilled (pde_1m: 64
//     encode blocks for 132 SMs) the encode splits N over blockIdx.z and a
//     combine kernel merges the partial (max, den, num) in fp32;
//   * the two launch parameters are the caller's, as the TPU kernels' tiles
//     are: a block's rows (16 * WARPS * MT; at D <= 16 smaller row tiles
//     than the default are built too, at_row_tiles) and the encode's token
//     splits. repro_torch/backends/autotune.py picks them per shape, by
//     default the MT above and the split of flare_encode_splits;
//   * the decode cannot hold all M scores per token as the TPU's VMEM does,
//     so it runs the same online softmax over latent chunks;
//   * no padding: ragged N and M are bounds in the loops, the staged
//     fragments are zero past the edge, and scores past it are -1e30, whose
//     exp is exactly 0, so no row comes out NaN;
//   * K, V and Y are taken with strides ([B, H, N, D] views of [B, N, H*D]
//     activations), so the model never copies a transposed tensor;
//   * for training, the fused forward also has the decode write each token's
//     log-sum-exp over the latents (an O(N) fp32 residual): the backward
//     kernels in flare_bwd.cu recompute the decode weights from it. The
//     pallas path passes null and writes nothing;
//   * a sharded forward splits the tokens over ranks, and a rank's encode is
//     only part of the sum over N: flare_enc_stats writes the numerator
//     against the rank's own max with that max and den (from the unsplit
//     grid directly, or from combine_kernel), so the ranks can merge them
//     before the normalisation; the decode then runs against the merged Z.
//     The fused forward normalises as num * (1 / den), as the merge does,
//     so on one rank the two give equal bits;
//   * any head dim D from 1 to 64 runs at its MMA width 8, 16, 32 or 64
//     (flare_mma.cuh::at_mma_width), lanes d >= D zero where operands are
//     loaded or staged; in device memory every tensor keeps its own D.
//     D = 8 has an instance of its own with D known at compile time. At 64
//     a warp's fragments exceed the register file and spill; ptxas's spill
//     bytes are printed by chip_smoke.py.
//
// Every entry point launches on the given stream, allocates nothing, and
// returns cudaGetLastError() so the caller can raise.

#include <initializer_list>

#include "flare_mma.cuh"

namespace {

using namespace flare;

constexpr int WARPS = MMA_WARPS;
constexpr int THREADS = MMA_THREADS;
constexpr int STAGE_FLOATS = 8192;   // floats of staged fragments a tile, two operands (32 KB)
constexpr int CH = 4;                // 8-wide steps a chunk: one running-max rescale each
constexpr int WAVE_BLOCKS = 4;       // blocks of THREADS resident an SM, for the N-split

// 16-row tiles a warp by default: four at D = 8, two up to 16, one above
// (registers). The row tile is a template parameter of the encode and the
// decode, and a launch parameter of their entry points (`rows`, a block's
// rows: 16 * WARPS * MT); at_row_tiles lists the instances built.
template <int D> __host__ __device__ constexpr int row_tiles() {
  return D <= 8 ? 4 : D <= 16 ? 2 : 1;
}
template <int D> __host__ __device__ constexpr int rows_a_block() {
  return WARPS * 16 * row_tiles<D>();
}
// 8-wide steps a staged tile: 32 (256 columns) at D = 8
template <int D> __host__ __device__ constexpr int tile_steps() {
  return STAGE_FLOATS / (2 * (D / 8) * 128);
}

// What a sweep leaves a thread: for rows gi and gi + 8 (h = 0, 1) of each
// of the warp's MT tiles, the max of the row's scores, their den (the
// quad's sum) and num, the C fragment of sum_c e^{s_c - mx} v_c.
template <int D, int MT>
struct Rows {
  static constexpr int KS = D / 8;
  float mx[MT][2], den[MT][2], num[MT][KS][4];
};

// Online softmax of the warp's rows [r0, r0 + 16 MT) of X (row stride xs,
// `rows` valid) over the columns [c0, c1) of the streamed score operand S
// (row stride ss), weighting the value operand V (row stride vs). Every
// warp of the block takes part in the staging; a warp whose rows all lie
// past `rows` computes nothing. `async`: the rows of S and V are whole
// 16-byte units at 16-byte aligned addresses, and the next tile's come in
// by cp.async into a raw buffer while this tile computes; else each tile is
// read from device memory as it is staged.
template <typename T, typename TV, int D, int MT>
__device__ __forceinline__ void sweep(Rows<D, MT>& out, const T* X, long long xs, int r0,
                                      int rows, const T* S, long long ss, const TV* V,
                                      long long vs, int c0, int c1, int Dr, bool async) {
  constexpr int KS = D / 8, NS = tile_steps<D>();
  constexpr bool EX = std::is_same<T, __nv_bfloat16>::value;    // x and s exact in TF32
  constexpr bool EV = std::is_same<TV, __nv_bfloat16>::value;   // v exact in TF32
  static_assert(NS % CH == 0, "a staged tile holds whole chunks");
  __shared__ uint4 sf_s[NS * KS * 32];   // the score operand, KDIM
  __shared__ uint4 vf_s[NS * KS * 32];   // the value operand, !KDIM
  __shared__ __align__(16) T sr_s[NS * 8 * D];    // the next tile's rows as they are
  __shared__ __align__(16) TV vr_s[NS * 8 * D];
  const int lane = threadIdx.x & 31, ti = lane & 3;
  auto fetch = [&](int t0) {   // rows [t0, t0 + NS * 8) of S and V into the raw buffers
    const int tn = min(NS * 8, c1 - t0);
    constexpr int US = 16 / sizeof(T), UV = 16 / sizeof(TV);   // elements a unit
    for (int i = threadIdx.x; i < tn * (Dr / US); i += THREADS) {
      const int r = i / (Dr / US), c = i % (Dr / US) * US;
      cp_async16(sr_s + r * D + c, S + (long long)(t0 + r) * ss + c);
    }
    for (int i = threadIdx.x; i < tn * (Dr / UV); i += THREADS) {
      const int r = i / (Dr / UV), c = i % (Dr / UV) * UV;
      cp_async16(vr_s + r * D + c, V + (long long)(t0 + r) * vs + c);
    }
    asm volatile("cp.async.commit_group;");
  };

  FragA xa[MT][KS];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) load_a(xa[i][kk], X, xs, r0 + 16 * i, rows, kk, Dr);
  // this tile's sums against the running max mx; the finished tiles' against tmx
  float mx[MT][2], den[MT][2], acc[MT][KS][4] = {}, tden[MT][2];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[i][h] = out.mx[i][h] = NEG_INF;
      den[i][h] = tden[i][h] = 0.f;
#pragma unroll
      for (int j = 0; j < KS; ++j) out.num[i][j][2 * h] = out.num[i][j][2 * h + 1] = 0.f;
    }
  if (async) fetch(c0);
  for (int t0 = c0; t0 < c1; t0 += NS * 8) {
    const int tn = min(NS * 8, c1 - t0), steps = (tn + 7) / 8;
    if (async) asm volatile("cp.async.wait_all;" ::: "memory");
    __syncthreads();
    if (async) {
      stage_b<T, KS, true>(sf_s, sr_s, D, 0, tn, steps, Dr);
      stage_b<TV, KS, false>(vf_s, vr_s, D, 0, tn, steps, Dr);
    } else {
      stage_b<T, KS, true>(sf_s, S, ss, t0, tn, steps, Dr);
      stage_b<TV, KS, false>(vf_s, V, vs, t0, tn, steps, Dr);
    }
    __syncthreads();
    if (async && t0 + NS * 8 < c1) fetch(t0 + NS * 8);
    if (r0 >= rows) continue;
    for (int s0 = 0; s0 < steps; s0 += CH) {
      float sc[MT][CH][4] = {};
#pragma unroll
      for (int s = 0; s < CH; ++s) {
        if (s0 + s >= steps) break;
        uint4 sb[KS];
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) sb[kk] = sf_s[((s0 + s) * KS + kk) * 32 + lane];
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int kk = 0; kk < KS; ++kk) mma3<EX, EX>(sc[i][s], xa[i][kk], sb[kk]);
      }
      // c0 (row gi, column 2t), c1 (gi, 2t+1), c2 (gi+8, 2t), c3 (gi+8, 2t+1); columns
      // past the edge (of a ragged last tile only) score -1e30
      if (tn < NS * 8) {
#pragma unroll
        for (int s = 0; s < CH; ++s)
#pragma unroll
          for (int r = 0; r < 4; ++r)
            if (8 * (s0 + s) + 2 * ti + (r & 1) >= tn)
#pragma unroll
              for (int i = 0; i < MT; ++i) sc[i][s][r] = NEG_INF;
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float cm = NEG_INF;
#pragma unroll
          for (int s = 0; s < CH; ++s) cm = fmaxf(cm, fmaxf(sc[i][s][2 * h], sc[i][s][2 * h + 1]));
          const float mnew = fmaxf(mx[i][h], quad_max(cm));
          const float alpha = __expf(mx[i][h] - mnew);
          mx[i][h] = mnew;
          den[i][h] *= alpha;
#pragma unroll
          for (int j = 0; j < KS; ++j) acc[i][j][2 * h] *= alpha, acc[i][j][2 * h + 1] *= alpha;
        }
#pragma unroll
      for (int s = 0; s < CH; ++s) {
        if (s0 + s >= steps) break;
        uint4 vb[KS];
#pragma unroll
        for (int j = 0; j < KS; ++j) vb[j] = vf_s[((s0 + s) * KS + j) * 32 + lane];
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          float p[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) p[r] = __expf(sc[i][s][r] - mx[i][r >> 1]);
          den[i][0] += p[0] + p[1];
          den[i][1] += p[2] + p[3];
          FragA pa;   // the accumulator as an A fragment: columns 2t, 2t+1 as k = t, t+4
          split_a(pa, p[0], p[2], p[1], p[3]);
#pragma unroll
          for (int j = 0; j < KS; ++j) {
            float o[4] = {};
            mma3<false, EV>(o, pa, vb[j]);
#pragma unroll
            for (int r = 0; r < 4; ++r) acc[i][j][r] += o[r];
          }
        }
      }
    }
    // fold the tile's sums into the totals (mx >= out.mx)
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float alpha = __expf(out.mx[i][h] - mx[i][h]);
        tden[i][h] = fmaf(tden[i][h], alpha, den[i][h]);
        den[i][h] = 0.f;
#pragma unroll
        for (int j = 0; j < KS; ++j)
#pragma unroll
          for (int c = 2 * h; c < 2 * h + 2; ++c) {
            out.num[i][j][c] = fmaf(out.num[i][j][c], alpha, acc[i][j][c]);
            acc[i][j][c] = 0.f;
          }
        out.mx[i][h] = mx[i][h];
      }
  }
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) out.den[i][h] = quad_sum(tden[i][h]);
}

// Encode. Grid (ceil(M / (16 * WARPS * MT)), B*H, splits); warp = 16 * MT latent
// rows of group g = b*H + h over tokens [split*split_len,
// min(N, (split+1)*split_len)). D is the MMA width, Dr the head dim in
// device memory (D itself where EXACT, else d_run).
// splits == 1: writes z[g, m, :] = num * (1 / den) (and mx, den when
// given); `raw` writes num itself, against mx, the flash statistics a rank
// merges. splits > 1: writes the partial (max, den, num[Dr]) to
// part[split, g, m, :].
template <typename T, typename TZ, int D, bool EXACT, int MT>
__global__ void __launch_bounds__(THREADS)
encode_tc_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 TZ* __restrict__ z, float* __restrict__ mx_out, float* __restrict__ den_out,
                 float* __restrict__ part, int H, int M, int N, int d_run, Strides ks,
                 Strides vs, int split_len, bool raw, bool async) {
  constexpr int KS = D / 8;
  const int Dr = EXACT ? D : d_run;
  const int g = blockIdx.y, b = g / H, h = g % H;
  const int lane = threadIdx.x & 31, gi = lane >> 2, ti = lane & 3;
  const int m0 = (blockIdx.x * WARPS + (threadIdx.x >> 5)) * 16 * MT;
  const int n0 = blockIdx.z * split_len, n1 = min(N, n0 + split_len);
  Rows<D, MT> st;
  sweep<T, T, D, MT>(st, q + (long long)h * M * Dr, Dr, m0, M, k + b * ks.b + h * ks.h, ks.n,
                     v + b * vs.b + h * vs.h, vs.n, n0, n1, Dr, async);
  const long long rows = (long long)gridDim.y * M;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int m = m0 + 16 * i + gi + 8 * hh;
      if (m >= M) continue;
      const long long row = (long long)g * M + m;
      const float inv = raw ? 1.f : 1.f / st.den[i][hh];
      float* p = part == nullptr ? nullptr
                                 : part + ((long long)blockIdx.z * rows + row) * (Dr + 2);
#pragma unroll
      for (int j = 0; j < KS; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int d = 8 * j + 2 * ti + c;
          if (d >= Dr) continue;
          const float x = st.num[i][j][2 * hh + c];
          if (p == nullptr) z[row * Dr + d] = from_f<TZ>(x * inv);
          else p[2 + d] = x;
        }
      if (ti != 0) continue;
      if (p != nullptr) {
        p[0] = st.mx[i][hh];
        p[1] = st.den[i][hh];
      } else if (mx_out != nullptr) {
        mx_out[row] = st.mx[i][hh];
        den_out[row] = st.den[i][hh];
      }
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

// Decode. Grid (ceil(N / (16 * WARPS * MT)), B*H); warp = 16 * MT tokens of
// group g: y[b, h, n, :] = softmax_m(k_n . q_m) z[g, m, :], online over the
// head's q and the group's Z streamed as the columns.
template <typename T, typename TZ, int D, bool EXACT, int MT>
__global__ void __launch_bounds__(THREADS)
decode_tc_kernel(const T* __restrict__ q, const T* __restrict__ k, const TZ* __restrict__ z,
                 T* __restrict__ y, float* __restrict__ lse_out, int H, int M, int N, int d_run,
                 Strides ks, Strides ys, bool async) {
  constexpr int KS = D / 8;
  const int Dr = EXACT ? D : d_run;
  const int g = blockIdx.y, b = g / H, h = g % H;
  const int lane = threadIdx.x & 31, gi = lane >> 2, ti = lane & 3;
  const int n0 = (blockIdx.x * WARPS + (threadIdx.x >> 5)) * 16 * MT;
  Rows<D, MT> st;
  sweep<T, TZ, D, MT>(st, k + b * ks.b + h * ks.h, ks.n, n0, N, q + (long long)h * M * Dr, Dr,
                      z + (long long)g * M * Dr, Dr, 0, M, Dr, async);
  T* yg = y + b * ys.b + h * ys.h;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int n = n0 + 16 * i + gi + 8 * hh;
      if (n >= N) continue;
      const float inv = 1.f / st.den[i][hh];
#pragma unroll
      for (int j = 0; j < KS; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int d = 8 * j + 2 * ti + c;
          if (d < Dr) yg[(long long)n * ys.n + d] = from_f<T>(st.num[i][j][2 * hh + c] * inv);
        }
      if (lse_out != nullptr && ti == 0)
        lse_out[(long long)g * N + n] = st.mx[i][hh] + logf(st.den[i][hh]);
    }
}

// Whether rows of Dr elements of T at these element strides from this base
// are whole 16-byte units at 16-byte aligned addresses (sweep's `async`).
template <typename T>
bool units16(const void* base, int Dr, std::initializer_list<long long> strides) {
  constexpr long long E = 16 / sizeof(T);
  bool ok = reinterpret_cast<uintptr_t>(base) % 16 == 0 && Dr % E == 0;
  for (long long st : strides) ok = ok && st % E == 0;
  return ok;
}

template <typename T, typename TZ, int D, bool EXACT, int MT>
cudaError_t encode_launch(const void* q, const void* k, const void* v, void* z, float* mx,
                          float* den, float* part, int B, int H, int M, int N, int Dr,
                          Strides ks, Strides vs, int splits, bool raw, cudaStream_t stream) {
  const int split_len = cdiv(N, splits);
  dim3 grid(cdiv(M, WARPS * 16 * MT), B * H, splits);
  const bool async = units16<T>(k, Dr, {ks.b, ks.h, ks.n}) && units16<T>(v, Dr, {vs.b, vs.h, vs.n});
  encode_tc_kernel<T, TZ, D, EXACT, MT><<<grid, THREADS, 0, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (TZ*)z, mx, den, splits > 1 ? part : nullptr,
      H, M, N, Dr, ks, vs, split_len, raw, async);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const long long rows = (long long)B * H * M;
  combine_kernel<TZ, D, EXACT><<<cdiv(rows, 256), 256, 0, stream>>>(part, (TZ*)z, mx, den,
                                                                     rows, splits, Dr, raw);
  return cudaGetLastError();
}

template <typename T, typename TZ, int D, bool EXACT, int MT>
cudaError_t decode_launch(const void* q, const void* k, const void* z, void* y, float* lse,
                          int B, int H, int M, int N, int Dr, Strides ks, Strides ys,
                          cudaStream_t stream) {
  dim3 grid(cdiv(N, WARPS * 16 * MT), B * H);
  const long long head = (long long)M * Dr;   // q and z: heads and groups contiguous
  const bool async = units16<T>(q, Dr, {head}) && units16<TZ>(z, Dr, {head});
  decode_tc_kernel<T, TZ, D, EXACT, MT><<<grid, THREADS, 0, stream>>>(
      (const T*)q, (const T*)k, (const TZ*)z, (T*)y, lse, H, M, N, Dr, ks, ys, async);
  return cudaGetLastError();
}

// The row tiles a warp built at MMA width D, for a block of `rows` rows
// (16 * WARPS * MT): row_tiles<D>() and, at D <= 16, the smaller ones (at
// D = 8 two, at 16 one). Larger tiles, and any second tile above 16, would
// spill: the default instances already use 231-244 registers in fp32. Any
// other `rows` is refused before a launch.
template <int D, typename F>
cudaError_t at_row_tiles(int rows, F&& f) {
  using std::integral_constant;
  if (rows == WARPS * 16 * row_tiles<D>()) return f(integral_constant<int, row_tiles<D>()>{});
  if constexpr (D <= 16) {
    if (rows == WARPS * 16) return f(integral_constant<int, 1>{});
  }
  if constexpr (D <= 8) {
    if (rows == WARPS * 32) return f(integral_constant<int, 2>{});
  }
  return cudaErrorInvalidValue;
}

// Any D from 1 to 64, at its MMA width (flare_mma.cuh), and a built row tile.
template <typename T, typename TZ>
cudaError_t encode_d(int D, int rows, const void* q, const void* k, const void* v, void* z,
                     float* mx, float* den, float* part, int B, int H, int M, int N,
                     Strides ks, Strides vs, int splits, bool raw, cudaStream_t s) {
  return at_mma_width(D, [&](auto w, auto exact) {
    return at_row_tiles<decltype(w)::value>(rows, [&](auto mt) {
      return encode_launch<T, TZ, decltype(w)::value, decltype(exact)::value,
                           decltype(mt)::value>(
          q, k, v, z, mx, den, part, B, H, M, N, D, ks, vs, splits, raw, s);
    });
  });
}

template <typename T, typename TZ>
cudaError_t decode_d(int D, int rows, const void* q, const void* k, const void* z, void* y,
                     float* lse, int B, int H, int M, int N, Strides ks, Strides ys,
                     cudaStream_t s) {
  return at_mma_width(D, [&](auto w, auto exact) {
    return at_row_tiles<decltype(w)::value>(rows, [&](auto mt) {
      return decode_launch<T, TZ, decltype(w)::value, decltype(exact)::value,
                           decltype(mt)::value>(
          q, k, z, y, lse, B, H, M, N, D, ks, ys, s);
    });
  });
}

}  // namespace

extern "C" {

// The default N-split of the encode (and of the backward's per-latent
// passes, which have its geometry: 256 latent rows a block of 128 threads
// at D = 8) for `sms` multiprocessors: enough blocks for WAVE_BLOCKS a
// multiprocessor, each split keeping at least 1024 tokens. The wrappers
// take it from kernels/flare.py::default_splits, the same rule in Python
// (a GPU test holds the two equal); a plan may name another split.
int flare_encode_splits(int groups, int M, int N, int sms) {
  const long long blocks = (long long)groups * cdiv(M, rows_a_block<8>());
  const long long wave = (long long)sms * WAVE_BLOCKS;
  const long long splits = wave / blocks < N / 1024 ? wave / blocks : N / 1024;
  return splits > 1 ? (int)splits : 1;
}

// q [H, M, D] contiguous; k, v [B, H, N, D] with strides (D stride 1);
// z [B, H, M, D] contiguous of zdtype; mx, den [B, H, M] fp32 or null;
// part fp32 scratch of splits * B*H*M * (D + 2) when splits > 1. `rows`:
// latent rows a block, one at_row_tiles built at D's MMA width; `splits`
// at most 65535 (gridDim.z). Anything else is refused before a launch.
int flare_encode(const void* q, const void* k, const void* v, void* z, float* mx, float* den,
                 float* part, int B, int H, int M, int N, int D, long long ksb, long long ksh,
                 long long ksn, long long vsb, long long vsh, long long vsn, int splits,
                 int rows, int dtype, int zdtype, void* stream) {
  if (splits < 1 || splits > 65535 || (splits > 1 && part == nullptr))
    return cudaErrorInvalidValue;
  const Strides ks{ksb, ksh, ksn}, vs{vsb, vsh, vsn};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == F32 && zdtype == F32)
    return encode_d<float, float>(D, rows, q, k, v, z, mx, den, part, B, H, M, N, ks, vs,
                                  splits, false, s);
  if (dtype == BF16 && zdtype == BF16)
    return encode_d<__nv_bfloat16, __nv_bfloat16>(D, rows, q, k, v, z, mx, den, part, B, H, M,
                                                  N, ks, vs, splits, false, s);
  if (dtype == BF16 && zdtype == F32)
    return encode_d<__nv_bfloat16, float>(D, rows, q, k, v, z, mx, den, part, B, H, M, N, ks,
                                          vs, splits, false, s);
  return cudaErrorInvalidValue;
}

// A rank's encode statistics (the sharded forward's first kernel): as
// flare_encode with fp32 output, but num [B, H, M, D] holds the numerator
// sum_n exp(s - mx) v_n before the normalisation, with mx and den [B, H, M]
// (all required, fp32, contiguous). The same grid, splits, rows and scratch.
int flare_enc_stats(const void* q, const void* k, const void* v, float* num, float* mx,
                    float* den, float* part, int B, int H, int M, int N, int D, long long ksb,
                    long long ksh, long long ksn, long long vsb, long long vsh, long long vsn,
                    int splits, int rows, int dtype, void* stream) {
  if (splits < 1 || splits > 65535 || (splits > 1 && part == nullptr) || mx == nullptr ||
      den == nullptr)
    return cudaErrorInvalidValue;
  const Strides ks{ksb, ksh, ksn}, vs{vsb, vsh, vsn};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == F32)
    return encode_d<float, float>(D, rows, q, k, v, num, mx, den, part, B, H, M, N, ks, vs,
                                  splits, true, s);
  if (dtype == BF16)
    return encode_d<__nv_bfloat16, float>(D, rows, q, k, v, num, mx, den, part, B, H, M, N, ks,
                                          vs, splits, true, s);
  return cudaErrorInvalidValue;
}

// q [H, M, D] contiguous; k, y [B, H, N, D] with strides; z [B, H, M, D]
// contiguous of zdtype; y takes dtype; lse [B, H, N] fp32 or null: each
// token's log-sum-exp over the latents, the backward's decode statistic.
// `rows`: token rows a block, as the encode's.
int flare_decode(const void* q, const void* k, const void* z, void* y, float* lse, int B, int H,
                 int M, int N, int D, long long ksb, long long ksh, long long ksn, long long ysb,
                 long long ysh, long long ysn, int rows, int dtype, int zdtype, void* stream) {
  const Strides ks{ksb, ksh, ksn}, ys{ysb, ysh, ysn};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == F32 && zdtype == F32)
    return decode_d<float, float>(D, rows, q, k, z, y, lse, B, H, M, N, ks, ys, s);
  if (dtype == BF16 && zdtype == BF16)
    return decode_d<__nv_bfloat16, __nv_bfloat16>(D, rows, q, k, z, y, lse, B, H, M, N, ks, ys,
                                                  s);
  if (dtype == BF16 && zdtype == F32)
    return decode_d<__nv_bfloat16, float>(D, rows, q, k, z, y, lse, B, H, M, N, ks, ys, s);
  return cudaErrorInvalidValue;
}

const char* flare_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
