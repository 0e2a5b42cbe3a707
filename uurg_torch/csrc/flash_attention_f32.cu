// Attention in float32: o = softmax(q k^T * scale) v on (B*H, T, D), and its
// gradient.
//
// Replaces the float32 configuration of uurg_tpu/ops/flash_attention.py::
// _attn_kernel (launched by _fused_attention_fwd_impl) and ::_attn_bwd_kernel
// (launched by _fused_attention_bwd_impl). The Pallas kernels are
// dtype-generic: with float32 q, k, v they cast p to float32 before PV and run
// in float32 throughout, which is what the ViT classifiers (fp32 by default)
// give them. The bf16 designs of flash_attention_{fwd,bwd}.cu take bf16 only.
//
// Precision: true float32 FFMA on the CUDA cores. No TF32 and no tensor
// cores: wgmma takes no float32 operands, and TF32 would leave ~1e-3 relative
// error against a reference that is exact float32. Sums are taken in another
// order than torch.matmul's, so results agree to float32 rounding, not bits.
//
// Bound: operations. A head does 4 T^2 D flops forward (10 T^2 D backward) on
// 16 T D bytes (28 T D): at T = 197, D = 64 that is ~49 flops a byte forward,
// above the H100's 67e12 / 3.35e12 = 20 float32 flops a byte. So the kernels
// must keep the FFMA pipes fed from registers: every product is a register
// micro-tile (4 x 4 outputs a thread from 2 x 16-byte shared-memory loads
// each 16 FFMAs), and the T x T scores never leave the SM.
//
// Design (simple, not yet fast; no TMA, no pipelining):
// - Blocks of 256 threads as a 16 x 16 grid (ty, tx). A block owns 64 rows of
//   one head (the "resident" operand: q rows forward and for dq, k rows for
//   dk/dv) and walks the other operand in inner tiles of BI rows (64 for
//   D <= 128, 32 above, so that the shared memory fits 227 KB). Tiles sit in
//   shared memory row-major with a row stride of D + 4 floats: a thread's
//   inner rows are tx, tx + 16, ..., so the 16-byte loads of eight
//   neighbouring threads fall on eight disjoint bank quads.
// - Scores: thread (ty, tx) computes rows ty + 16 i (i < 4) against inner
//   rows tx + 16 j (j < BI / 16). Row statistics are reduced across the 16
//   lanes of a half warp with shuffles.
// - Products with the probabilities (O += P V, dv += P^T g, dk += dS^T q,
//   dq += dS k) go through a transposed tile in shared memory; the thread
//   then owns resident rows 4 ty .. 4 ty + 3 and the 16-byte column chunks
//   4 tx + 64 c, so each step is one 16-byte load of the weights and one of
//   the other operand a chunk.
// - Forward: online softmax in base 2 (the scale folded with log2 e), fp32 O
//   accumulators rescaled by a per-row factor passed through shared memory,
//   O divided by the row sum at the end; the natural log-sum-exp of the
//   scaled scores is written when asked for.
// - Backward: delta = rowsum(g o) by a warp a row (exact to float32 rounding
//   here, where the bf16 design reads it off a rounded o); then one kernel
//   over key tiles (P and dS rebuilt from the log-sum-exp, dk and dv in
//   registers over all query tiles) and one over query tiles (dq), with no
//   atomics.
// - Registers: at D = 64 two blocks of each kernel fit an SM's shared
//   memory, so each kernel is held to 128 registers a thread (the scores'
//   D loop is not unrolled, which keeps the backward's two score tiles and
//   two accumulators from spilling); above, one block an SM, up to 255.
// - Any T: rows past T are loaded as zeros, keys past T are masked out of the
//   softmax (-inf) and out of the gradients (P = 0), and nothing past T is
//   stored. D is one of 64, 128, 192, 256 (the wrapper pads other widths
//   with zeros and passes the true D^-0.5 scale).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;            // 16 x 16
constexpr int kRows = 64;                // resident rows a block owns
constexpr int kLdW = kRows + 4;          // row stride of a transposed weight tile
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <int D>
struct Shape {
  static constexpr int BI = D <= 128 ? 64 : 32;   // inner tile rows
  static constexpr int NJ = BI / 16;               // inner rows a thread
  static constexpr int LD = D + 4;                 // row stride of a D-wide tile
  // blocks an SM: at D = 64 the shared memory holds two of every kernel, so
  // their registers must fit 128 a thread; above, one block fills it
  static constexpr int MIN_BLOCKS = D == 64 ? 2 : 1;
};

// rows [row0, row0 + ROWS) of a (T, D) head into shared memory (stride D + 4),
// zeros past T
template <int D, int ROWS>
__device__ __forceinline__ void load_rows(float* dst,
                                          const float* __restrict__ src,
                                          int row0, int T) {
  constexpr int V = D / 4;
  for (int i = threadIdx.x; i < ROWS * V; i += kThreads) {
    const int r = i / V, c = (i % V) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < T)
      val = __ldg(reinterpret_cast<const float4*>(
          src + static_cast<size_t>(row0 + r) * D + c));
    *reinterpret_cast<float4*>(dst + r * (D + 4) + c) = val;
  }
}

// s[i][j] = A[ty + 16 i] . B[tx + 16 j] over D; A has kRows rows, B NJ * 16
template <int D, int NJ>
__device__ __forceinline__ void dot_tile(float (&s)[4][NJ],
                                         const float* A, const float* B,
                                         int ty, int tx) {
  constexpr int LD = D + 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) s[i][j] = 0.f;
#pragma unroll 1
  for (int d = 0; d < D; d += 4) {
    float4 a[4], b[NJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const float4*>(A + (ty + 16 * i) * LD + d);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      b[j] = *reinterpret_cast<const float4*>(B + (tx + 16 * j) * LD + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        float t = s[i][j];
        t = fmaf(a[i].x, b[j].x, t);
        t = fmaf(a[i].y, b[j].y, t);
        t = fmaf(a[i].z, b[j].z, t);
        t = fmaf(a[i].w, b[j].w, t);
        s[i][j] = t;
      }
  }
}

__device__ __forceinline__ void fma4(float4& acc, float w, const float4& x) {
  acc.x = fmaf(w, x.x, acc.x);
  acc.y = fmaf(w, x.y, acc.y);
  acc.z = fmaf(w, x.z, acc.z);
  acc.w = fmaf(w, x.w, acc.w);
}

// acc[i][c] (resident row 4 ty + i, columns 4 tx + 64 c .. + 3) +=
//   sum_b Wt[b][4 ty + i] * X[b][4 tx + 64 c ..], b over NB inner rows
template <int D, int NB>
__device__ __forceinline__ void acc_tile(float4 (&acc)[4][D / 64],
                                         const float* Wt, const float* X,
                                         int ty, int tx) {
  constexpr int LD = D + 4;
#pragma unroll 4
  for (int b = 0; b < NB; ++b) {
    const float4 w = *reinterpret_cast<const float4*>(Wt + b * kLdW + 4 * ty);
#pragma unroll
    for (int c = 0; c < D / 64; ++c) {
      const float4 x =
          *reinterpret_cast<const float4*>(X + b * LD + 4 * tx + 64 * c);
      fma4(acc[0][c], w.x, x);
      fma4(acc[1][c], w.y, x);
      fma4(acc[2][c], w.z, x);
      fma4(acc[3][c], w.w, x);
    }
  }
}

// the 16 lanes of a half warp hold one row group
__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// store resident rows 4 ty + i of acc (divided by div[i] when given) to
// rows row0 + 4 ty + i of a (T, D) head, those below T
template <int D>
__device__ __forceinline__ void store_rows(float* __restrict__ dst,
                                           const float4 (&acc)[4][D / 64],
                                           const float* div, int row0, int T,
                                           int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + 4 * ty + i;
    if (r >= T) continue;
#pragma unroll
    for (int c = 0; c < D / 64; ++c) {
      float4 x = acc[i][c];
      if (div != nullptr) {
        const float l = div[4 * ty + i];
        x = make_float4(x.x / l, x.y / l, x.z / l, x.w / l);
      }
      *reinterpret_cast<float4*>(dst + static_cast<size_t>(r) * D + 4 * tx +
                                 64 * c) = x;
    }
  }
}

template <int D>
constexpr size_t fwd_smem() {
  using S = Shape<D>;
  return sizeof(float) *
         ((kRows + 2 * S::BI) * S::LD + S::BI * kLdW + 2 * kRows);
}

// grid: BH * n_tiles blocks; block b is query tile b % n_tiles of head
// b / n_tiles
template <int D>
__global__ void __launch_bounds__(kThreads, Shape<D>::MIN_BLOCKS)
attn_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ o,
             float* __restrict__ lse, int T, int n_tiles, float scale_log2) {
  using S = Shape<D>;
  constexpr int BI = S::BI, NJ = S::NJ, LD = S::LD;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + kRows * LD;
  float* Vs = Ks + BI * LD;
  float* Pt = Vs + BI * LD;                 // [key][query]
  float* row_alpha = Pt + BI * kLdW;
  float* row_l = row_alpha + kRows;

  const int bh = blockIdx.x / n_tiles;
  const int q0 = (blockIdx.x % n_tiles) * kRows;
  const size_t base = static_cast<size_t>(bh) * T * D;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  load_rows<D, kRows>(Qs, q + base, q0, T);
  float m[4], l[4];
  float4 acc[4][D / 64];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < D / 64; ++c) acc[i][c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  for (int k0 = 0; k0 < T; k0 += BI) {
    __syncthreads();                        // the last tile's readers are done
    load_rows<D, BI>(Ks, k + base, k0, T);
    load_rows<D, BI>(Vs, v + base, k0, T);
    __syncthreads();
    float s[4][NJ];
    dot_tile<D, NJ>(s, Qs, Ks, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        s[i][j] = k0 + tx + 16 * j < T ? s[i][j] * scale_log2 : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      // key k0 < T is in every tile, so m_new is finite
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const float alpha = exp2f(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float p = exp2f(s[i][j] - m_new);
        sum += p;
        Pt[(tx + 16 * j) * kLdW + ty + 16 * i] = p;
      }
      l[i] = l[i] * alpha + half_warp_sum(sum);
      m[i] = m_new;
      if (tx == 0) row_alpha[ty + 16 * i] = alpha;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = row_alpha[4 * ty + i];
#pragma unroll
      for (int c = 0; c < D / 64; ++c) {
        acc[i][c].x *= a;
        acc[i][c].y *= a;
        acc[i][c].z *= a;
        acc[i][c].w *= a;
      }
    }
    acc_tile<D, BI>(acc, Pt, Vs, ty, tx);
  }

  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      row_l[r] = l[i];
      if (lse != nullptr && q0 + r < T)
        lse[static_cast<size_t>(bh) * T + q0 + r] = (m[i] + log2f(l[i])) * kLn2;
    }
  }
  __syncthreads();
  store_rows<D>(o + base, acc, row_l, q0, T, ty, tx);
}

// delta[r] = sum_d g[r][d] o[r][d], a warp a row
template <int D>
__global__ void __launch_bounds__(kThreads)
attn_delta_f32(const float* __restrict__ o, const float* __restrict__ g,
               float* __restrict__ delta, long long rows) {
  const long long r = static_cast<long long>(blockIdx.x) * (kThreads / 32) +
                      threadIdx.x / 32;
  if (r >= rows) return;
  const int lane = threadIdx.x % 32;
  float sum = 0.f;
  for (int d = lane; d < D; d += 32)
    sum = fmaf(g[r * D + d], o[r * D + d], sum);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (lane == 0) delta[r] = sum;
}

template <int D>
constexpr size_t dkdv_smem() {
  using S = Shape<D>;
  return sizeof(float) *
         (2 * (kRows + S::BI) * S::LD + 2 * S::BI * kLdW + 2 * S::BI);
}

// grid: BH * n_tiles blocks, block b owns key tile b % n_tiles of head
// b / n_tiles and walks every query tile
template <int D>
__global__ void __launch_bounds__(kThreads, Shape<D>::MIN_BLOCKS)
attn_bwd_dkdv_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ g,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, float* __restrict__ dk,
                  float* __restrict__ dv, int T, int n_tiles, float scale,
                  float scale_log2) {
  using S = Shape<D>;
  constexpr int BI = S::BI, NJ = S::NJ, LD = S::LD;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + kRows * LD;
  float* Qs = Vs + kRows * LD;
  float* Gs = Qs + BI * LD;
  float* Pt = Gs + BI * LD;                 // [query][key]
  float* Dt = Pt + BI * kLdW;               // dS, [query][key]
  float* lse_s = Dt + BI * kLdW;            // log2 units
  float* delta_s = lse_s + BI;

  const int bh = blockIdx.x / n_tiles;
  const int k0 = (blockIdx.x % n_tiles) * kRows;
  const size_t base = static_cast<size_t>(bh) * T * D;
  const float* lse_h = lse + static_cast<size_t>(bh) * T;
  const float* delta_h = delta + static_cast<size_t>(bh) * T;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  load_rows<D, kRows>(Ks, k + base, k0, T);
  load_rows<D, kRows>(Vs, v + base, k0, T);
  float4 acc_dk[4][D / 64], acc_dv[4][D / 64];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < D / 64; ++c) {
      acc_dk[i][c] = make_float4(0.f, 0.f, 0.f, 0.f);
      acc_dv[i][c] = make_float4(0.f, 0.f, 0.f, 0.f);
    }

  for (int q0 = 0; q0 < T; q0 += BI) {
    __syncthreads();
    load_rows<D, BI>(Qs, q + base, q0, T);
    load_rows<D, BI>(Gs, g + base, q0, T);
    if (threadIdx.x < BI) {
      const int r = q0 + threadIdx.x;
      lse_s[threadIdx.x] = r < T ? lse_h[r] * kLog2e : 0.f;
      delta_s[threadIdx.x] = r < T ? delta_h[r] : 0.f;
    }
    __syncthreads();
    float s[4][NJ], dp[4][NJ];
    dot_tile<D, NJ>(s, Ks, Qs, ty, tx);     // [key ty + 16 i][query tx + 16 j]
    dot_tile<D, NJ>(dp, Vs, Gs, ty, tx);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int qr = tx + 16 * j;
      const bool live = q0 + qr < T;
      const float ls = lse_s[qr], dl = delta_s[qr];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = live ? exp2f(s[i][j] * scale_log2 - ls) : 0.f;
        Pt[qr * kLdW + ty + 16 * i] = p;
        Dt[qr * kLdW + ty + 16 * i] = p * (dp[i][j] - dl) * scale;
      }
    }
    __syncthreads();
    acc_tile<D, BI>(acc_dv, Pt, Gs, ty, tx);
    acc_tile<D, BI>(acc_dk, Dt, Qs, ty, tx);
  }
  store_rows<D>(dk + base, acc_dk, nullptr, k0, T, ty, tx);
  store_rows<D>(dv + base, acc_dv, nullptr, k0, T, ty, tx);
}

template <int D>
constexpr size_t dq_smem() {
  using S = Shape<D>;
  return sizeof(float) * (2 * (kRows + S::BI) * S::LD + S::BI * kLdW);
}

// grid: BH * n_tiles blocks, block b owns query tile b % n_tiles of head
// b / n_tiles and walks every key tile
template <int D>
__global__ void __launch_bounds__(kThreads, Shape<D>::MIN_BLOCKS)
attn_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ g,
                const float* __restrict__ lse, const float* __restrict__ delta,
                float* __restrict__ dq, int T, int n_tiles, float scale,
                float scale_log2) {
  using S = Shape<D>;
  constexpr int BI = S::BI, NJ = S::NJ, LD = S::LD;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Gs = Qs + kRows * LD;
  float* Ks = Gs + kRows * LD;
  float* Vs = Ks + BI * LD;
  float* Dt = Vs + BI * LD;                 // dS, [key][query]

  const int bh = blockIdx.x / n_tiles;
  const int q0 = (blockIdx.x % n_tiles) * kRows;
  const size_t base = static_cast<size_t>(bh) * T * D;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  load_rows<D, kRows>(Qs, q + base, q0, T);
  load_rows<D, kRows>(Gs, g + base, q0, T);
  float ls[4], dl[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    ls[i] = r < T ? lse[static_cast<size_t>(bh) * T + r] * kLog2e : 0.f;
    dl[i] = r < T ? delta[static_cast<size_t>(bh) * T + r] : 0.f;
  }
  float4 acc[4][D / 64];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < D / 64; ++c) acc[i][c] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int k0 = 0; k0 < T; k0 += BI) {
    __syncthreads();
    load_rows<D, BI>(Ks, k + base, k0, T);
    load_rows<D, BI>(Vs, v + base, k0, T);
    __syncthreads();
    float s[4][NJ], dp[4][NJ];
    dot_tile<D, NJ>(s, Qs, Ks, ty, tx);     // [query ty + 16 i][key tx + 16 j]
    dot_tile<D, NJ>(dp, Gs, Vs, ty, tx);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int kr = tx + 16 * j;
      const bool live = k0 + kr < T;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = live ? exp2f(s[i][j] * scale_log2 - ls[i]) : 0.f;
        Dt[kr * kLdW + ty + 16 * i] = p * (dp[i][j] - dl[i]) * scale;
      }
    }
    __syncthreads();
    acc_tile<D, BI>(acc, Dt, Ks, ty, tx);
  }
  store_rows<D>(dq + base, acc, nullptr, q0, T, ty, tx);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <int D>
int launch_fwd(const float* q, const float* k, const float* v, float* o,
               float* lse, int BH, int T, float scale, cudaStream_t stream) {
  constexpr size_t smem = fwd_smem<D>();
  cudaError_t err = allow_smem(attn_fwd_f32<D>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_tiles = (T + kRows - 1) / kRows;
  attn_fwd_f32<D><<<BH * n_tiles, kThreads, smem, stream>>>(
      q, k, v, o, lse, T, n_tiles, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_bwd(const float* q, const float* k, const float* v, const float* o,
               const float* g, const float* lse, float* delta, float* dq,
               float* dk, float* dv, int BH, int T, float scale,
               cudaStream_t stream) {
  const long long rows = static_cast<long long>(BH) * T;
  const int per_block = kThreads / 32;
  attn_delta_f32<D><<<static_cast<unsigned>((rows + per_block - 1) / per_block),
                      kThreads, 0, stream>>>(o, g, delta, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_tiles = (T + kRows - 1) / kRows;
  constexpr size_t smem_kv = dkdv_smem<D>();
  err = allow_smem(attn_bwd_dkdv_f32<D>, smem_kv);
  if (err != cudaSuccess) return static_cast<int>(err);
  attn_bwd_dkdv_f32<D><<<BH * n_tiles, kThreads, smem_kv, stream>>>(
      q, k, v, g, lse, delta, dk, dv, T, n_tiles, scale, scale * kLog2e);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr size_t smem_q = dq_smem<D>();
  err = allow_smem(attn_bwd_dq_f32<D>, smem_q);
  if (err != cudaSuccess) return static_cast<int>(err);
  attn_bwd_dq_f32<D><<<BH * n_tiles, kThreads, smem_q, stream>>>(
      q, k, v, g, lse, delta, dq, T, n_tiles, scale, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, o: contiguous float32 (BH, T, D), 16-byte aligned; lse: float32
// (BH, T) or null. Returns the CUDA error code of the launch (0 on success).
extern "C" int uurg_attention_fwd_f32(const void* q, const void* k,
                                      const void* v, void* o, void* lse,
                                      int BH, int T, int D, float scale,
                                      void* stream) {
  const float *qf = static_cast<const float*>(q),
              *kf = static_cast<const float*>(k),
              *vf = static_cast<const float*>(v);
  float* of = static_cast<float*>(o);
  float* lf = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return launch_fwd<64>(qf, kf, vf, of, lf, BH, T, scale, s);
    case 128: return launch_fwd<128>(qf, kf, vf, of, lf, BH, T, scale, s);
    case 192: return launch_fwd<192>(qf, kf, vf, of, lf, BH, T, scale, s);
    case 256: return launch_fwd<256>(qf, kf, vf, of, lf, BH, T, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// q, k, v, o, g, dq, dk, dv: contiguous float32 (BH, T, D); lse (the
// forward's) and delta (scratch): float32 (BH, T). Three launches in stream
// order: delta, dk/dv, dq.
extern "C" int uurg_attention_bwd_f32(const void* q, const void* k,
                                      const void* v, const void* o,
                                      const void* g, const void* lse,
                                      void* delta, void* dq, void* dk,
                                      void* dv, int BH, int T, int D,
                                      float scale, void* stream) {
  const float *qf = static_cast<const float*>(q),
              *kf = static_cast<const float*>(k),
              *vf = static_cast<const float*>(v),
              *of = static_cast<const float*>(o),
              *gf = static_cast<const float*>(g),
              *lf = static_cast<const float*>(lse);
  float *df = static_cast<float*>(delta), *dqf = static_cast<float*>(dq),
        *dkf = static_cast<float*>(dk), *dvf = static_cast<float*>(dv);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch_bwd<64>(qf, kf, vf, of, gf, lf, df, dqf, dkf, dvf, BH, T,
                            scale, s);
    case 128:
      return launch_bwd<128>(qf, kf, vf, of, gf, lf, df, dqf, dkf, dvf, BH, T,
                             scale, s);
    case 192:
      return launch_bwd<192>(qf, kf, vf, of, gf, lf, df, dqf, dkf, dvf, BH, T,
                             scale, s);
    case 256:
      return launch_bwd<256>(qf, kf, vf, of, gf, lf, df, dqf, dkf, dvf, BH, T,
                             scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
