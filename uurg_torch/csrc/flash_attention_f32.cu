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
// Precision: float32 throughout. The routes up to width 256 are FFMA on the
// CUDA cores; the xwide route splits each operand into two TF32 halves and
// runs three TF32 tensor-core products a float32 product (plain TF32 would
// leave ~1e-3 relative error against a reference that is exact float32).
// Sums are taken in another order than torch.matmul's, so results agree to
// float32 rounding, not bits; no atomics, so a launch repeats its bits.
//
// Bound. At ViT-B/16's shape (T = 197, D = 64) operations: a head does
// 4 T^2 D flops forward (10 T^2 D backward) on 16 T D bytes (28 T D), ~49
// flops a byte forward, above the H100's 67e12 / 3.35e12 = 20 float32 flops
// a byte. At main_random's 32 px ViT (T = 5) bytes: 1.25 flops a byte.
//
// Four routes, chosen by the caller (uurg_torch/ops/flash_attention.py,
// _f32_plan) and checked here:
// - tiled (D = 64, T > 16) and packed (D = 64, T <= 16): the designs below.
// - wide (D = 128, 192, 256): the first design (register-tiled 4 x 4 FFMA,
//   blocks of 256 threads owning 64 rows, loads and products alternating
//   under __syncthreads, dq recomputing S and dP in a third kernel). No ViT
//   or Swin configuration of the repository has heads wider than 64.
// - xwide (D = 320, 384, 448, 512): the VAE's one head of width 512, which
//   no tile of the wide route fits; the forward 3xTF32 on the tensor cores
//   (see its section). The xwide forward in bfloat16 is
//   flash_attention_xwide_fwd.cu, the xwide backward, in both dtypes,
//   flash_attention_xwide_bwd.cu.
//
// What the first design lost at T = 197 and what the D = 64 routes do:
// - Padding. 64-row tiles on both sides and a thread map that spread every
//   16-row group over all 256 threads computed 256 x 256 scores a head for
//   197 x 197. Here a block is four warps and a warp owns 16 whole rows
//   (forward: queries; backward: keys), so a warp whose rows all lie past T
//   skips the products, and the last tile of the other side is multiplied
//   only over its live 16-row groups (a template per group count): 208 x 208
//   scores a head. Heads of T <= 16 are packed: floor(16 / T) heads share a
//   warp's 16 rows (the heads lie back to back in (B*H, T, D), so a chunk of
//   them is one run of rows) with a block-diagonal mask, and a block takes
//   four such chunks (two in the backward); at T = 5 a block holds 60 live
//   rows of 64 where the first design held 5.
// - Seven products backward where five are needed: one kernel owns 64 keys
//   and walks the query tiles of 32; it forms S^T and dP^T, then
//   dV += P^T dO and dK += dS^T Q, and writes dS^T to float32 scratch
//   (B*H, Tp, Tp), T padded to Tp (a multiple of 64); a second kernel sums
//   dq = dS K from it over 32-key tiles. dS through HBM (154 MB written and
//   read at ViT's shape) beat both a dq share per key tile summed by a
//   third pass and a dq kernel that rebuilds S and dP (timed in turns by
//   scripts/profile_torch_attention_f32_variants.py). Packed heads need no
//   scratch: a chunk holds all keys of its queries, so the key-tile kernel
//   writes their dq itself. Deterministic, no atomics.
// - Loads and products alternating: the streamed operand (K and V forward;
//   Q, dO, the log-sum-exp and delta backward; dS^T and K for dq) runs
//   through a two-stage ring in shared memory filled by cp.async 16-byte
//   copies (4-byte for the row vectors), committed and waited by group, so
//   tile j + 1 arrives while tile j is multiplied; rows past T arrive as
//   zeros (src-size 0).
// - Shared-memory feed: a lane holds a 4 x 4 score tile from 16-byte loads
//   of 4 and 4 rows (rows lr + 4 i against lk + 8 j) and a 4-row x 8-column
//   accumulator; D-wide tiles have a row stride of 68 floats and the P and
//   dS tiles 40, which keeps every load and store of a warp on distinct
//   bank quads (4 distinct addresses broadcast to 8 lanes each, or 8
//   consecutive 16-byte chunks).
// - Occupancy: 128 threads a block; the forward walks keys in tiles of 32
//   (61 KB of shared memory, three blocks an SM, ~5% faster on the card
//   than tiles of 64 at two), the key-tile kernel takes 89 KB (two blocks
//   an SM, 255 registers a thread allowed).
//
// Forward: online softmax in base 2 (the scale folded with log2 e), fp32 O
// rescaled per row, divided by the row sum at the end; the natural
// log-sum-exp of the scaled scores is written when asked for. Backward:
// delta = rowsum(dO o) by a warp a row (exact to float32 rounding), then the
// key-tile kernel, then (tiled) the dq kernel. Keys past T are masked (-inf
// forward, P = 0 backward), rows past T are computed on zeros and not
// stored. D is one of 64, 128, 192, 256, 320, 384, 448, 512 (the wrapper
// pads other widths with zeros and passes the true D^-0.5 scale).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// The wide route (D = 128, 192, 256; the variants script's first_design
// patches D = 64 back in to time the first design against the tiled route)
// ---------------------------------------------------------------------------

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

// ---------------------------------------------------------------------------
// The tiled and packed routes (D = 64)
// ---------------------------------------------------------------------------

constexpr int kD = 64;                   // head width of these routes
constexpr int kLd = kD + 4;              // row stride of a D-wide tile
constexpr int kChunks = kD / 4;          // 16-byte chunks a row
constexpr int kWarps = 4;
constexpr int kNT = 32 * kWarps;         // threads a block
constexpr int kFwdMI = 4;                // query rows of a forward lane
constexpr int kFwdWarpRows = 4 * kFwdMI; // of a forward warp
constexpr int kFwdRows = kWarps * kFwdWarpRows;  // of a forward block
constexpr int kDqRows = 64;              // queries of a dq block; T pads to it
constexpr int kFwdKeys = 32;             // keys of a forward tile
constexpr int kFwdNJ = kFwdKeys / 8;     // of them a lane's, at most
constexpr int kKeyTile = 64;             // keys of a backward block
constexpr int kBwdQ = 32;                // queries of a backward tile
constexpr int kPackT = 16;               // heads of T <= kPackT are packed
constexpr int kPld = kFwdKeys + 8;       // row stride, a warp's forward P
constexpr int kTld = 40;                 // row stride, backward P^T and dS^T
constexpr unsigned kFull = 0xffffffffu;

// -- asynchronous copies (cp.async) --

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, or 16 zero bytes when !live
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool live) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(smem_u32(dst)), "l"(src), "r"(live ? 16 : 0)
               : "memory");
}

// 4 bytes from global to shared memory, or a zero when !live
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool live) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               ::"r"(smem_u32(dst)), "l"(src), "r"(live ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// -- tiles --

// tile rows [0, ROWS) (stride kLd) <- rows row0 + r of a (rows, 64) array,
// zeros from tile row `live` on; every thread of the block takes part
template <int ROWS>
__device__ __forceinline__ void async_tile(float* dst,
                                           const float* __restrict__ src,
                                           long long row0, int live) {
  static_assert(ROWS * kChunks % kNT == 0, "whole copies a thread");
#pragma unroll
  for (int n = 0; n < ROWS * kChunks / kNT; ++n) {
    const int i = threadIdx.x + n * kNT;
    const int r = i / kChunks, c = (i % kChunks) * 4;
    const bool ok = r < live;
    cp_async16(dst + r * kLd + c, ok ? src + (row0 + r) * kD + c : src, ok);
  }
}

// dst[0, ROWS) <- src[row0 + i], zeros from `live` on (threads 0 .. ROWS-1)
template <int ROWS>
__device__ __forceinline__ void async_vec(float* dst,
                                          const float* __restrict__ src,
                                          long long row0, int live) {
  const int i = threadIdx.x;
  if (i < ROWS) cp_async4(dst + i, i < live ? src + row0 + i : src, i < live);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float dot4(const float4& a, const float4& b,
                                      float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// acc += w.x x0 + w.y x1 + w.z x2 + w.w x3
__device__ __forceinline__ void axpy4(float4& acc, const float4& w,
                                      const float4& x0, const float4& x1,
                                      const float4& x2, const float4& x3) {
  fma4(acc, w.x, x0);
  fma4(acc, w.y, x1);
  fma4(acc, w.z, x2);
  fma4(acc, w.w, x3);
}

// the 8 lanes of a row group (lane bits 0-2) hold one row
__device__ __forceinline__ float oct_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(kFull, v, 1));
  v = fmaxf(v, __shfl_xor_sync(kFull, v, 2));
  return fmaxf(v, __shfl_xor_sync(kFull, v, 4));
}

__device__ __forceinline__ float oct_sum(float v) {
  v += __shfl_xor_sync(kFull, v, 1);
  v += __shfl_xor_sync(kFull, v, 2);
  return v + __shfl_xor_sync(kFull, v, 4);
}

// bit 8 i + j: row lr + 4 i and column lc + 8 j of a packed chunk belong to
// one head (all bits for unpacked heads, group == 0)
__device__ __forceinline__ unsigned head_mask(int lr, int lc, int T,
                                              int group) {
  if (group == 0) return kFull;
  unsigned m = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if ((lr + 4 * i) / T == (lc + 8 * j) / T) m |= 1u << (8 * i + j);
  return m;
}

// live rows of chunk c (group heads of T rows back to back, rows in all)
__device__ __forceinline__ int chunk_live(long long c, int L, long long rows) {
  const long long left = rows - c * L;
  return left <= 0 ? 0 : (left < L ? static_cast<int>(left) : L);
}

// A warp's share of a forward tile: MI query rows a lane (rows lr + 4 i of
// Qw, i < MI) against the 8 NJ keys lk + 8 j of Kw (live below nkeys, and
// for MI = 4 where hmask says), S = Q K^T, the online softmax, then
// O += P V through the warp's P tile in shared memory. Lane (lr, lk) holds
// O columns 4 lk + 32 c.
template <int MI, int NJ>
__device__ __forceinline__ void fwd_tile(const float* Qw, const float* Kw,
                                         const float* Vw, float* Pw, int lr,
                                         int lk, int nkeys, unsigned hmask,
                                         float scale_log2, float (&m)[kFwdMI],
                                         float (&l)[kFwdMI],
                                         float4 (&acc)[kFwdMI][2]) {
  static_assert(MI == 4 || MI == 8, "4 or 8 rows a lane");
  float s[MI][NJ];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) s[i][j] = 0.f;
#pragma unroll 2
  for (int d = 0; d < kD; d += 4) {
    float4 a[MI], b[NJ];
#pragma unroll
    for (int i = 0; i < MI; ++i) a[i] = ld4(Qw + (lr + 4 * i) * kLd + d);
#pragma unroll
    for (int j = 0; j < NJ; ++j) b[j] = ld4(Kw + (lk + 8 * j) * kLd + d);
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) s[i][j] = dot4(a[i], b[j], s[i][j]);
  }
  const int jlim = nkeys > lk ? (nkeys - lk + 7) / 8 : 0;
#pragma unroll
  for (int i = 0; i < MI; ++i) {
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const bool ok =
          j < jlim && (MI == 8 || ((hmask >> (8 * i + j)) & 1u));
      s[i][j] = ok ? s[i][j] * scale_log2 : -INFINITY;
      mx = fmaxf(mx, s[i][j]);
    }
    const float m_new = fmaxf(m[i], oct_max(mx));
    // a row with no live key so far (a packed chunk's dead rows) stays at 0
    const float m_use = m_new == -INFINITY ? 0.f : m_new;
    const float alpha = exp2f(m[i] - m_use);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float p = exp2f(s[i][j] - m_use);
      sum += p;
      Pw[(lr + 4 * i) * kPld + lk + 8 * j] = p;
    }
    l[i] = l[i] * alpha + oct_sum(sum);
    m[i] = m_new;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      acc[i][c].x *= alpha;
      acc[i][c].y *= alpha;
      acc[i][c].z *= alpha;
      acc[i][c].w *= alpha;
    }
  }
  __syncwarp();
#pragma unroll 2
  for (int kk = 0; kk < 8 * NJ; kk += 4) {
    float4 p[MI], x[4][2];
#pragma unroll
    for (int i = 0; i < MI; ++i) p[i] = ld4(Pw + (lr + 4 * i) * kPld + kk);
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int c = 0; c < 2; ++c)
        x[u][c] = ld4(Vw + (kk + u) * kLd + 4 * lk + 32 * c);
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int c = 0; c < 2; ++c)
        axpy4(acc[i][c], p[i], x[0][c], x[1][c], x[2][c], x[3][c]);
  }
  __syncwarp();                           // P is rewritten by the next tile
}

// fwd_tile over a tile of nkeys live keys: its live 16-key groups only
template <int MI>
__device__ __forceinline__ void fwd_keys(const float* Qw, const float* Kw,
                                         const float* Vw, float* Pw, int lr,
                                         int lk, int nkeys, unsigned hmask,
                                         float scale_log2, float (&m)[kFwdMI],
                                         float (&l)[kFwdMI],
                                         float4 (&acc)[kFwdMI][2]) {
  switch ((nkeys + 15) / 16) {
    case 1:
      fwd_tile<MI, 2>(Qw, Kw, Vw, Pw, lr, lk, nkeys, hmask, scale_log2, m, l,
                      acc);
      break;
    case 2:
      fwd_tile<MI, 4>(Qw, Kw, Vw, Pw, lr, lk, nkeys, hmask, scale_log2, m, l,
                      acc);
      break;
    case 3:
      fwd_tile<MI, kFwdNJ < 6 ? kFwdNJ : 6>(Qw, Kw, Vw, Pw, lr, lk, nkeys,
                                            hmask, scale_log2, m, l, acc);
      break;
    default:
      fwd_tile<MI, kFwdNJ>(Qw, Kw, Vw, Pw, lr, lk, nkeys, hmask, scale_log2,
                           m, l, acc);
      break;
  }
}

constexpr size_t fwd_d64_smem() {
  return sizeof(float) *
         ((kFwdRows + 4 * kFwdKeys) * kLd + kFwdRows * kPld);
}

// Tiled (group == 0): block b is query tile b % n_tiles of head b / n_tiles
// (kFwdWarpRows rows a warp; with eight rows a lane, a variant, a warp with
// 16 live rows or fewer takes them four a lane), and walks the head's key
// tiles. Packed (group > 0): block b takes chunks 4 b .. 4 b + 3 of `group`
// heads each, 16 rows, one a warp, and one key tile.
__global__ void __launch_bounds__(kNT, 3)
attn_fwd_d64(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ o,
             float* __restrict__ lse, int T, int n_tiles, int group,
             long long rows, float scale_log2) {
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + kFwdRows * kLd;        // two stages
  float* Vs = Ks + 2 * kFwdKeys * kLd;    // two stages
  float* Ps = Vs + 2 * kFwdKeys * kLd;    // kFwdWarpRows x kPld a warp
  constexpr int kStage = kFwdKeys * kLd;
  static_assert(2 * kFwdKeys >= 16 * kWarps, "packed chunks fill the ring");
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int lr = lane / 8, lk = lane % 8;

  long long my_row0 = 0, head_row0 = 0;   // flat rows
  int my_live = 0, n_kt = 1, key_off = 0;
  if (group > 0) {
    const int L = group * T;
    for (int c = 0; c < kWarps; ++c) {
      const long long chunk = static_cast<long long>(kWarps) * blockIdx.x + c;
      const long long r0 = chunk * L;
      const int live = chunk_live(chunk, L, rows);
      async_tile<16>(Qs + 16 * c * kLd, q, r0, live);
      async_tile<16>(Ks + 16 * c * kLd, k, r0, live);
      async_tile<16>(Vs + 16 * c * kLd, v, r0, live);
      if (c == w) {
        my_row0 = r0;
        my_live = live;
      }
    }
    key_off = 16 * w;
  } else {
    const long long bh = blockIdx.x / n_tiles;
    const int q0 = (blockIdx.x % n_tiles) * kFwdRows;
    head_row0 = bh * T;
    async_tile<kFwdRows>(Qs, q, head_row0 + q0, min(kFwdRows, T - q0));
    async_tile<kFwdKeys>(Ks, k, head_row0, min(kFwdKeys, T));
    async_tile<kFwdKeys>(Vs, v, head_row0, min(kFwdKeys, T));
    n_kt = (T + kFwdKeys - 1) / kFwdKeys;
    my_row0 = head_row0 + q0 + kFwdWarpRows * w;
    my_live = min(kFwdWarpRows, T - q0 - kFwdWarpRows * w);
  }
  cp_async_commit();
  if (n_kt > 1) {
    async_tile<kFwdKeys>(Ks + kStage, k, head_row0 + kFwdKeys,
                         min(kFwdKeys, T - kFwdKeys));
    async_tile<kFwdKeys>(Vs + kStage, v, head_row0 + kFwdKeys,
                         min(kFwdKeys, T - kFwdKeys));
    cp_async_commit();
  }

  const unsigned hmask = head_mask(lr, lk, T, group);
  const int warp_row0 = group > 0 ? 16 * w : kFwdWarpRows * w;
  const float* Qw = Qs + warp_row0 * kLd;
  float* Pw = Ps + kFwdWarpRows * w * kPld;
  float m[kFwdMI], l[kFwdMI];
  float4 acc[kFwdMI][2];
#pragma unroll
  for (int i = 0; i < kFwdMI; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
    acc[i][0] = acc[i][1] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  for (int t = 0; t < n_kt; ++t) {
    if (t + 1 < n_kt)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();                      // tile t is in for every thread
    if (my_live > 0) {
      const int nkeys =
          group > 0 ? my_live : min(kFwdKeys, T - t * kFwdKeys);
      const float* Kw = Ks + (t & 1) * kStage + key_off * kLd;
      const float* Vw = Vs + (t & 1) * kStage + key_off * kLd;
      if (my_live > 16)
        fwd_keys<kFwdMI>(Qw, Kw, Vw, Pw, lr, lk, nkeys, hmask, scale_log2, m,
                         l, acc);
      else
        fwd_keys<4>(Qw, Kw, Vw, Pw, lr, lk, nkeys, hmask, scale_log2, m, l,
                    acc);
    }
    if (t + 2 < n_kt) {
      __syncthreads();                    // stage t & 1 is read by all
      const long long r0 =
          head_row0 + static_cast<long long>(t + 2) * kFwdKeys;
      const int live = min(kFwdKeys, T - (t + 2) * kFwdKeys);
      async_tile<kFwdKeys>(Ks + (t & 1) * kStage, k, r0, live);
      async_tile<kFwdKeys>(Vs + (t & 1) * kStage, v, r0, live);
      cp_async_commit();
    }
  }

#pragma unroll
  for (int i = 0; i < kFwdMI; ++i) {
    const int rl = lr + 4 * i;
    if (rl >= my_live) continue;
    const long long r = my_row0 + rl;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const float4 x = acc[i][c];
      *reinterpret_cast<float4*>(o + r * kD + 4 * lk + 32 * c) =
          make_float4(x.x / l[i], x.y / l[i], x.z / l[i], x.w / l[i]);
    }
    if (lse != nullptr && lk == 0) lse[r] = (m[i] + log2f(l[i])) * kLn2;
  }
}

// A warp's share of a backward tile: its 16 keys (rows lr + 4 i of Kw, Vw;
// nk live) against the 8 NJ queries lq + 8 j of Qw, Gw (nq live; ls, dl
// their log-sum-exp and delta): S^T and dP^T, then P^T and dS^T into the
// warp's rows of Ptw, Dtw, then dv += P^T dO and dk += dS^T Q. Lane
// (lr, lq) holds dk, dv columns 4 lq + 32 c.
template <int NJ>
__device__ __forceinline__ void bwd_tile(const float* Kw, const float* Vw,
                                         const float* Qw, const float* Gw,
                                         const float* ls, const float* dl,
                                         float* Ptw, float* Dtw, int lr,
                                         int lq, int nk, int nq,
                                         unsigned hmask, float scale,
                                         float scale_log2,
                                         float4 (&dk)[4][2],
                                         float4 (&dv)[4][2]) {
  float s[4][NJ], dp[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
  for (int d = 0; d < kD; d += 4) {
    float4 a[4], b[NJ];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = ld4(Kw + (lr + 4 * i) * kLd + d);
#pragma unroll
    for (int j = 0; j < NJ; ++j) b[j] = ld4(Qw + (lq + 8 * j) * kLd + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) s[i][j] = dot4(a[i], b[j], s[i][j]);
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = ld4(Vw + (lr + 4 * i) * kLd + d);
#pragma unroll
    for (int j = 0; j < NJ; ++j) b[j] = ld4(Gw + (lq + 8 * j) * kLd + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) dp[i][j] = dot4(a[i], b[j], dp[i][j]);
  }
  const int ilim = nk > lr ? (nk - lr + 3) / 4 : 0;
  const int jlim = nq > lq ? (nq - lq + 7) / 8 : 0;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int qc = lq + 8 * j;
    const float lj = ls[qc] * kLog2e, dj = dl[qc];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const bool ok = i < ilim && j < jlim && ((hmask >> (8 * i + j)) & 1u);
      const float p = ok ? exp2f(s[i][j] * scale_log2 - lj) : 0.f;
      Ptw[(lr + 4 * i) * kTld + qc] = p;
      Dtw[(lr + 4 * i) * kTld + qc] = p * (dp[i][j] - dj) * scale;
    }
  }
  __syncwarp();
#pragma unroll 2
  for (int qq = 0; qq < 8 * NJ; qq += 4) {
    float4 p[4], x[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) p[i] = ld4(Ptw + (lr + 4 * i) * kTld + qq);
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int c = 0; c < 2; ++c)
        x[u][c] = ld4(Gw + (qq + u) * kLd + 4 * lq + 32 * c);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 2; ++c)
        axpy4(dv[i][c], p[i], x[0][c], x[1][c], x[2][c], x[3][c]);
  }
#pragma unroll 2
  for (int qq = 0; qq < 8 * NJ; qq += 4) {
    float4 p[4], x[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) p[i] = ld4(Dtw + (lr + 4 * i) * kTld + qq);
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int c = 0; c < 2; ++c)
        x[u][c] = ld4(Qw + (qq + u) * kLd + 4 * lq + 32 * c);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 2; ++c)
        axpy4(dk[i][c], p[i], x[0][c], x[1][c], x[2][c], x[3][c]);
  }
}

// Packed heads: dq of the block's two chunks, complete (a chunk holds all
// keys of its queries): thread (qd, dd) sums queries 4 qd .. 4 qd + 3 (of
// chunk qd / 4: Dt columns) against that chunk's 16 keys (Dt rows), columns
// 4 dd .. 4 dd + 3.
__device__ __forceinline__ void packed_dq(const float* Dt, const float* Ks,
                                          float* __restrict__ dq,
                                          long long row0_0, int rows_0,
                                          long long row0_1, int rows_1) {
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int qd = 4 * (w % 2) + lane / 8, dd = 8 * (w / 2) + lane % 8;
  const int h = qd / 4, first = 4 * qd - 16 * h;
  const int live = h ? rows_1 : rows_0;
  if (first >= live) return;
  float4 a[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) a[r] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
  for (int kk = 16 * h; kk < 16 * h + 16; ++kk) {
    const float4 ds = ld4(Dt + kk * kTld + 4 * qd);
    const float4 kv = ld4(Ks + kk * kLd + 4 * dd);
    fma4(a[0], ds.x, kv);
    fma4(a[1], ds.y, kv);
    fma4(a[2], ds.z, kv);
    fma4(a[3], ds.w, kv);
  }
  const long long row0 = (h ? row0_1 : row0_0) + first;
#pragma unroll
  for (int r = 0; r < 4; ++r)
    if (first + r < live)
      *reinterpret_cast<float4*>(dq + (row0 + r) * kD + 4 * dd) = a[r];
}

// Tiled heads: the block's dS^T (its keys below nk, the tile's kBwdQ query
// columns) to dst[key][column], rows Tp floats apart; eight threads a row
__device__ __forceinline__ void store_ds(const float* Dt,
                                         float* __restrict__ dst, int Tp,
                                         int nk) {
  constexpr int kRowVecs = kBwdQ / 4;
#pragma unroll
  for (int n = 0; n < kKeyTile * kRowVecs / kNT; ++n) {
    const int i = threadIdx.x + n * kNT;
    const int r = i / kRowVecs, c = (i % kRowVecs) * 4;
    if (r < nk)
      *reinterpret_cast<float4*>(dst + static_cast<long long>(r) * Tp + c) =
          ld4(Dt + r * kTld + c);
  }
}

constexpr size_t bwd_d64_smem() {
  return sizeof(float) * ((2 * kKeyTile + 4 * kBwdQ) * kLd +
                          2 * kKeyTile * kTld + 4 * kBwdQ);
}

// Tiled (group == 0): block b owns key tile b % n_tiles of head b / n_tiles,
// walks the head's query tiles and writes its rows of dS^T to dq_out, the
// (B*H, Tp, Tp) scratch. Packed (group > 0): block b takes chunks 2 b and
// 2 b + 1 (warps 0 and 1 their keys) and writes dq_out = dq itself.
__global__ void __launch_bounds__(kNT, 2)
attn_bwd_d64(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ g,
             const float* __restrict__ lse, const float* __restrict__ delta,
             float* __restrict__ dq_out, float* __restrict__ dk,
             float* __restrict__ dv, int T, int n_tiles, int group,
             long long rows, float scale, float scale_log2) {
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + kKeyTile * kLd;
  float* Qs = Vs + kKeyTile * kLd;        // two stages
  float* Gs = Qs + 2 * kBwdQ * kLd;       // two stages
  float* Pt = Gs + 2 * kBwdQ * kLd;       // [key][query]
  float* Dt = Pt + kKeyTile * kTld;       // [key][query]
  float* Ls = Dt + kKeyTile * kTld;       // two stages
  float* Es = Ls + 2 * kBwdQ;             // delta, two stages
  constexpr int kStage = kBwdQ * kLd;
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int lr = lane / 8, lq = lane % 8;

  // packed: the two chunks' first flat rows and live rows (scalars, not an
  // array indexed by a lane's chunk, which would live in local memory)
  long long head_row0 = 0, c0_row0 = 0, c1_row0 = 0;
  int nk = 0, n_qt = 1, c0_rows = 0, c1_rows = 0;
  const int Tp = (T + kDqRows - 1) / kDqRows * kDqRows;
  float* ds_blk = dq_out;                 // tiled: the block's dS^T rows
  int my_nk, qcol = 0;                    // the warp's keys, query column
  long long my_row0;                      // flat row of the warp's first key
  if (group > 0) {
    const int L = group * T;
    c0_row0 = 2LL * blockIdx.x * L;
    c1_row0 = c0_row0 + L;
    c0_rows = chunk_live(2LL * blockIdx.x, L, rows);
    c1_rows = chunk_live(2LL * blockIdx.x + 1, L, rows);
    for (int h = 0; h < 2; ++h) {
      const long long r0 = h ? c1_row0 : c0_row0;
      const int live = h ? c1_rows : c0_rows;
      async_tile<16>(Ks + 16 * h * kLd, k, r0, live);
      async_tile<16>(Vs + 16 * h * kLd, v, r0, live);
      async_tile<16>(Qs + 16 * h * kLd, q, r0, live);
      async_tile<16>(Gs + 16 * h * kLd, g, r0, live);
    }
    // threads 0-15 and 16-31 the two chunks' row vectors
    if (threadIdx.x < 32) {
      const int h = threadIdx.x / 16, i = threadIdx.x % 16;
      const long long r0 = h ? c1_row0 : c0_row0;
      const bool ok = i < (h ? c1_rows : c0_rows);
      cp_async4(Ls + 16 * h + i, ok ? lse + r0 + i : lse, ok);
      cp_async4(Es + 16 * h + i, ok ? delta + r0 + i : delta, ok);
    }
    my_nk = w == 0 ? c0_rows : (w == 1 ? c1_rows : 0);  // and queries
    my_row0 = w == 0 ? c0_row0 : c1_row0;
    qcol = 16 * w;
  } else {
    const long long bh = blockIdx.x / n_tiles;
    const int k0 = (blockIdx.x % n_tiles) * kKeyTile;
    head_row0 = bh * T;
    ds_blk = dq_out + (bh * Tp + k0) * Tp;
    nk = min(kKeyTile, T - k0);
    async_tile<kKeyTile>(Ks, k, head_row0 + k0, nk);
    async_tile<kKeyTile>(Vs, v, head_row0 + k0, nk);
    n_qt = (T + kBwdQ - 1) / kBwdQ;
    for (int t = 0; t < 2 && t < n_qt; ++t) {
      const int live = min(kBwdQ, T - t * kBwdQ);
      const long long r0 = head_row0 + t * kBwdQ;
      async_tile<kBwdQ>(Qs + t * kStage, q, r0, live);
      async_tile<kBwdQ>(Gs + t * kStage, g, r0, live);
      async_vec<kBwdQ>(Ls + t * kBwdQ, lse, r0, live);
      async_vec<kBwdQ>(Es + t * kBwdQ, delta, r0, live);
      cp_async_commit();                  // group t
    }
    my_nk = nk - 16 * w;
    my_row0 = head_row0 + k0 + 16 * w;
  }
  if (group > 0) cp_async_commit();

  const unsigned hmask = head_mask(lr, lq, T, group);
  const float* Kw = Ks + 16 * w * kLd;
  const float* Vw = Vs + 16 * w * kLd;
  float* Ptw = Pt + 16 * w * kTld + qcol;
  float* Dtw = Dt + 16 * w * kTld + qcol;
  float4 dkr[4][2], dvr[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 2; ++c)
      dkr[i][c] = dvr[i][c] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int t = 0; t < n_qt; ++t) {
    if (t + 1 < n_qt)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();                      // tile t is in; Dt is free
    const int st = t & 1;
    const int nq = group > 0 ? my_nk : min(kBwdQ, T - t * kBwdQ);
    const int nq16 = (nq + 15) / 16 * 16;
    if (my_nk > 0) {
      const float* Qw = Qs + st * kStage + qcol * kLd;
      const float* Gw = Gs + st * kStage + qcol * kLd;
      const float* ls = Ls + st * kBwdQ + qcol;
      const float* dl = Es + st * kBwdQ + qcol;
      if (nq16 <= 16)
        bwd_tile<2>(Kw, Vw, Qw, Gw, ls, dl, Ptw, Dtw, lr, lq, my_nk, nq,
                    hmask, scale, scale_log2, dkr, dvr);
      else
        bwd_tile<4>(Kw, Vw, Qw, Gw, ls, dl, Ptw, Dtw, lr, lq, my_nk, nq,
                    hmask, scale, scale_log2, dkr, dvr);
    }
    __syncthreads();                      // dS^T complete; stage st read
    if (t + 2 < n_qt) {
      const int live = min(kBwdQ, T - (t + 2) * kBwdQ);
      const long long r0 = head_row0 + static_cast<long long>(t + 2) * kBwdQ;
      async_tile<kBwdQ>(Qs + st * kStage, q, r0, live);
      async_tile<kBwdQ>(Gs + st * kStage, g, r0, live);
      async_vec<kBwdQ>(Ls + st * kBwdQ, lse, r0, live);
      async_vec<kBwdQ>(Es + st * kBwdQ, delta, r0, live);
      cp_async_commit();
    }
    if (group > 0)
      packed_dq(Dt, Ks, dq_out, c0_row0, c0_rows, c1_row0, c1_rows);
    else
      store_ds(Dt, ds_blk + t * kBwdQ, Tp, nk);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kl = lr + 4 * i;
    if (kl >= my_nk) continue;
    const long long r = my_row0 + kl;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      *reinterpret_cast<float4*>(dk + r * kD + 4 * lq + 32 * c) = dkr[i][c];
      *reinterpret_cast<float4*>(dv + r * kD + 4 * lq + 32 * c) = dvr[i][c];
    }
  }
}

constexpr int kDqKeys = 32;              // keys of a dq tile
constexpr size_t dq_d64_smem() { return sizeof(float) * 4 * kDqKeys * kLd; }

// Tiled heads: dq rows q0 .. q0 + 63 of head b / n_tiles (q0 = 64 (b %
// n_tiles)) = sum over keys of dS^T[key][query] K[key], the dS^T scratch's
// columns and K's rows streamed in kDqKeys-row tiles through a two-stage
// cp.async ring. Thread (qd, dd) holds queries 4 qd .. 4 qd + 3 and columns
// 4 dd + 32 c.
__global__ void __launch_bounds__(kNT)
attn_bwd_dq_d64(const float* __restrict__ ds, const float* __restrict__ k,
                float* __restrict__ dq, int T, int n_tiles) {
  extern __shared__ float4 smem4[];
  float* Ss = reinterpret_cast<float*>(smem4);   // two stages
  float* Ks = Ss + 2 * kDqKeys * kLd;            // two stages
  constexpr int kStage = kDqKeys * kLd;
  const int Tp = (T + kDqRows - 1) / kDqRows * kDqRows;
  const long long bh = blockIdx.x / n_tiles;
  const int q0 = (blockIdx.x % n_tiles) * kDqRows;
  const float* ds_h = ds + bh * Tp * Tp + q0;
  const int n_kt = (T + kDqKeys - 1) / kDqKeys;
  auto load = [&](int t, int st) {
    const int k0 = t * kDqKeys, live = min(kDqKeys, T - k0);
#pragma unroll
    for (int n = 0; n < kDqKeys * kChunks / kNT; ++n) {
      const int i = threadIdx.x + n * kNT;
      const int r = i / kChunks, c = (i % kChunks) * 4;
      const bool ok = r < live;
      cp_async16(Ss + st * kStage + r * kLd + c,
                 ok ? ds_h + static_cast<long long>(k0 + r) * Tp + c : ds, ok);
    }
    async_tile<kDqKeys>(Ks + st * kStage, k, bh * T + k0, live);
    cp_async_commit();
  };
  load(0, 0);
  if (n_kt > 1) load(1, 1);
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int qd = 4 * w + lane / 8, dd = lane % 8;
  float4 acc[4][2];
#pragma unroll
  for (int r = 0; r < 4; ++r)
    acc[r][0] = acc[r][1] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int t = 0; t < n_kt; ++t) {
    if (t + 1 < n_kt)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();
    const float* S = Ss + (t & 1) * kStage;
    const float* K = Ks + (t & 1) * kStage;
    // a warp holds queries q0 + 16 w ..: none past T, no products
    const int nk = q0 + 16 * w < T ? min(kDqKeys, T - t * kDqKeys) : 0;
#pragma unroll 4
    for (int kk = 0; kk < nk; ++kk) {
      const float4 s = ld4(S + kk * kLd + 4 * qd);
      const float4 k0 = ld4(K + kk * kLd + 4 * dd);
      const float4 k1 = ld4(K + kk * kLd + 4 * dd + 32);
      fma4(acc[0][0], s.x, k0);
      fma4(acc[0][1], s.x, k1);
      fma4(acc[1][0], s.y, k0);
      fma4(acc[1][1], s.y, k1);
      fma4(acc[2][0], s.z, k0);
      fma4(acc[2][1], s.z, k1);
      fma4(acc[3][0], s.w, k0);
      fma4(acc[3][1], s.w, k1);
    }
    if (t + 2 < n_kt) {
      __syncthreads();                    // stage t & 1 is read by all
      load(t + 2, t & 1);
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int qr = q0 + 4 * qd + r;
    if (qr >= T) continue;
#pragma unroll
    for (int c = 0; c < 2; ++c)
      *reinterpret_cast<float4*>(dq + (bh * T + qr) * kD + 4 * dd + 32 * c) =
          acc[r][c];
  }
}

// ---------------------------------------------------------------------------
// The extra-wide route (D = 320, 384, 448, 512; the forward only)
// ---------------------------------------------------------------------------
//
// The VAE's mid-block attention (uurg_torch/models/autoencoder_kl.py): one
// head of width 512 at T = 1024 (256 px images) or 4096 (512 px). Both
// products run on the tensor cores as three TF32 products a float32 product
// (mma.sync.m16n8k8.tf32, "3xTF32"): x = hi + lo with hi = tf32(x) (cvt.rna)
// and lo = x - hi, and a b ~ a_lo b_hi + a_hi b_lo + a_hi b_hi with
// fp32 accumulation. The dropped a_lo b_lo is ~2^-22 of a b, the TF32 part
// of lo ~2^-21 of x. The tensor cores' own accumulation truncates, which
// over D = 512 and T = 4096 keys biased the sums (relative L2 3.2e-5 at
// T = 4096 on an H100, against 1.5e-6 for an FFMA design): so S is summed
// by the tensor cores over a 64-column chunk only (24 steps) and the chunks
// by rounding fp32 adds, and each 8-key step's three products of O are
// formed in a fresh accumulator and added to O by rounding fp32 adds. The
// result keeps float32's accuracy (the gate: relative L2 1e-5 against the
// exact fp32 plain version), at a third of the TF32 rate: 2.5 times the
// FFMA rate. The online softmax (m, l, the rescale of O) stays in fp32 on
// the CUDA cores. The route's first design (FFMA, 32 rows a block of 8
// warps, one block an SM, a K chunk serving 32 rows, two barriers a chunk)
// took 1.8 times fp32 SDPA's time.
//
// A block of 256 threads (8 warps) owns 64 query rows, resident in shared
// memory (128 KB at D = 512), and walks the keys in tiles of 128:
//   - S = Q K^T over the tile: K streams in 128-key x 64-column chunks
//     (32 KB) through a two-buffer cp.async ring; warp w holds the scores of
//     rows 32 (w / 4) .. + 31 and keys 32 (w % 4) .. + 31 (2 x 4 m16n8
//     accumulators), summed over the D / 64 chunks;
//   - the online softmax in base 2: a row's max and sum are taken over a
//     quad's lanes by shuffles and over the four warps of its rows through
//     shared memory; P (64 x 128) and the rescale factors go to shared memory;
//   - O += P V: V streams in 16-key x D chunks (32 KB) through the same ring;
//     warp w holds O rows 32 (w / 4) .. + 31 and columns (w % 4) D / 4 ..
//     + D / 4 - 1 (2 x D / 32 m16n8 accumulators, 128 registers a thread at
//     D = 512).
// One block barrier a chunk (and one more a tile for the row maxima): a
// chunk's copy is issued right after the barrier that frees its buffer and
// lands while the chunk before it is multiplied. Shared memory: Q, two
// chunks, P and 640 floats, all 227 KB of a block at D = 512: one block an
// SM. Eight warps of up to 255 registers hold these tiles without spilling
// (16 warps of 128 spilled, and split each operand more often: a 32 x 32
// score tile splits 2 values a product where 16 x 32 split 3); the tensor
// cores' mma.sync TF32 rate (~313 TFLOP/s on the card, 63% of wgmma's) needs
// only a few independent products in flight a scheduler, which the 8 and 32
// accumulator tiles a warp give.
//
// Fragments. The sum over the inner index of an m16n8k8 product does not
// depend on which index pairs with which, so a lane's logical k = t and
// t + 4 (t = lane % 4) are the physical columns 2 t and 2 t + 1 of each
// 8-wide step, for A and B alike: a lane's two A values of a row (and its two
// B values of a key of K) are one 8-byte load, and the P tile written from
// the score accumulators (columns 2 t, 2 t + 1) is read back the same way; V
// gives the rows 2 t and 2 t + 1. Q, K and P are stored without padding
// under an XOR swizzle of their 16-byte chunks (row r's chunk c at
// c ^ 2 (r % 4)), V chunks with a row stride of D + 4: the fragment loads,
// the P stores and the cp.async stores are free of bank conflicts, and the
// addresses of the scores' and of V's fragments are linear in the loop
// indices (an XOR per load cost registers that ptxas spilled).
//
// Bound: operations, 4 T^2 D flops a head on 16 T D bytes (256 flops a byte
// at T = 1024), far above the card's 20 float32 flops a byte. The table's
// bound is the FFMA rate (67 TFLOP/s); this design's own floor is three TF32
// products at 495 TFLOP/s.

constexpr int kXThreads = 256;
constexpr int kXRows = 64;               // query rows of a block
constexpr int kMaxGridY = 65535;         // heads a launch: grid y's limit
constexpr int kXKeys = 128;              // keys of a tile
constexpr int kXKc = 64;                 // columns of a K chunk
constexpr int kXVKeys = 16;              // keys of a V chunk
constexpr int kXVChunks = kXKeys / kXVKeys;

template <int D>
struct XShape {
  static_assert(D % 64 == 0 && D > 256 && D <= 512, "widths 320 to 512");
  static constexpr int LDV = D + 4;                    // row stride of a V chunk
  static constexpr int NK = D / kXKc;                  // K chunks a tile
  static constexpr int NS = NK + kXVChunks;            // chunks a tile
  static constexpr int NJ = D / 32;                    // O n-blocks a warp
  static constexpr int BUF = kXKeys * kXKc > kXVKeys * LDV ? kXKeys * kXKc
                                                           : kXVKeys * LDV;
};

// Q, two ring buffers, P and the row vectors: 232,448 bytes at D = 512, all
// of a block's shared memory
template <int D>
constexpr size_t xwide_smem() {
  using S = XShape<D>;
  return sizeof(float) *
         (kXRows * D + 2 * S::BUF + kXRows * kXKeys + 10 * kXRows);
}

// float index of (r, c) in a swizzled tile of rows of ld floats (Q, K, P):
// row r's 16-byte chunk c / 4 at (c / 4) ^ 2 (r % 4)
__device__ __forceinline__ int xsw(int r, int c, int ld) {
  return r * ld + ((((c >> 2) ^ ((r & 3) << 1))) << 2) + (c & 3);
}

// x = hi + lo: hi = tf32(x) rounded to nearest, lo = x - hi exactly (an
// fp32 value; the tensor core reads its TF32 part, the low 13 bits ignored,
// as CUTLASS's fast 3xTF32 conversion relies on: ~2^-21 of x)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c = a b (first) or c += a b, issued in program order: volatile, and a
// memory clobber so that the loads around it stay where they are written
__device__ __forceinline__ void mma_tf32_seq(float (&c)[4], const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1, bool first) {
  if (first) {
    asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
                 "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
                 : "=f"(c[0]), "=f"(c[1]), "=f"(c[2]), "=f"(c[3])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
                   "f"(0.f)
                 : "memory");
  } else {
    asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
                 "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
                 : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1)
                 : "memory");
  }
}

// an A fragment, split, from its two 8-byte halves: rows g and g + 8 at
// logical columns t (.x) and t + 4 (.y)
__device__ __forceinline__ void split_a(float2 x0, float2 x1, uint32_t (&hi)[4],
                                        uint32_t (&lo)[4]) {
  split_tf32(x0.x, hi[0], lo[0]);
  split_tf32(x1.x, hi[1], lo[1]);
  split_tf32(x0.y, hi[2], lo[2]);
  split_tf32(x1.y, hi[3], lo[3]);
}

__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// chunk c of the key tile at k0 of head blockIdx.y into `buf`: K columns
// 64 c .. + 63 of keys k0 .. k0 + 127 for c < NK (swizzled), else V rows
// k0 + 16 (c - NK) .. + 15 (stride D + 4); zeros past T. The head's offset
// is recomputed here and no index is divided by a width that is not a power
// of two: registers held across the key walk, or that index arithmetic
// unrolled, cost spills
template <int D>
__device__ __forceinline__ void xwide_issue(float* buf,
                                            const float* __restrict__ k,
                                            const float* __restrict__ v,
                                            int c, int k0, int T) {
  using S = XShape<D>;
  const size_t head = static_cast<size_t>(blockIdx.y) * T * D;
  k += head;
  v += head;
  if (c < S::NK) {
    constexpr int V4 = kXKc / 4;
#pragma unroll
    for (int n = 0; n < kXKeys * V4 / kXThreads; ++n) {
      const int i = threadIdx.x + n * kXThreads;
      const int r = i / V4, col = (i % V4) * 4;
      const bool ok = k0 + r < T;
      cp_async16(buf + xsw(r, col, kXKc),
                 ok ? k + static_cast<long long>(k0 + r) * D + c * kXKc + col
                    : k,
                 ok);
    }
  } else {
    // two rows at a time, a thread a 16-byte column chunk of each
    constexpr int V4 = D / 4;
    const int kv0 = k0 + (c - S::NK) * kXVKeys;
    const int r0 = threadIdx.x / 128, col = (threadIdx.x % 128) * 4;
    if (col < D) {
#pragma unroll
      for (int r = r0; r < kXVKeys; r += kXThreads / 128) {
        const bool ok = kv0 + r < T;
        cp_async16(buf + r * S::LDV + col,
                   ok ? v + static_cast<long long>(kv0 + r) * D + col : v, ok);
      }
    }
    static_assert(V4 <= 128, "a V row in one pass of 128 threads");
  }
}

// grid: (ceil(T / 64), BH) blocks; block (x, y) owns query rows 64 x ..
// + 63 of head y
template <int D>
__global__ void __launch_bounds__(kXThreads, 1)
attn_fwd_xwide(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, float* __restrict__ o,
               float* __restrict__ lse, int T, float scale_log2) {
  using S = XShape<D>;
  constexpr int NK = S::NK, NS = S::NS, LDV = S::LDV, NJ = S::NJ;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* ring = Qs + kXRows * D;
  float* Ps = ring + 2 * S::BUF;            // [row][key]
  float* red_max = Ps + kXRows * kXKeys;    // [key quarter][row]
  float* red_sum = red_max + 4 * kXRows;    // [key quarter][row]
  float* row_alpha = red_sum + 4 * kXRows;
  float* row_l = row_alpha + kXRows;

  const int q0 = blockIdx.x * kXRows;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  // warp w's rows: 32 (w / 4) + 16 i + g (+ 8), i < 2, for the scores and
  // for O; its keys: 32 (w % 4) + 8 j + 2 t (+ 1), j < 4; its O columns:
  // (w % 4) D / 4 + 8 j + 2 t (+ 1), j < D / 32
  const int kq = warp % 4;
  const int row0 = (warp / 4) * 32 + g;
  const int skey = kq * 32;
  const int ocol = kq * (D / 4);
  // the scores' fragments: a lane's rows of Q and of K (row0 + 8 h,
  // skey + 8 j + g) are all g modulo 4, so one swizzled offset serves its
  // A and B loads of a k-step: logical columns 8 p + 2 t, + 1 lie at
  // 8 (p ^ (g % 4)) + 2 t, + 1
  const int gq = g & 3;
  const float* qa = Qs + row0 * D + 2 * t;
  const int kb = (skey + g) * kXKc + 2 * t;
  // this lane's scores in the P tile: row row0 + 16 i + 8 h, keys
  // skey + 8 j + 2 t, + 1 at srun + (16 i + 8 h) kXKeys + 8 (j ^ (g % 4))
  const int srun = row0 * kXKeys + skey + 2 * t;

  {
    // two rows at a time, as xwide_issue copies V
    const float* qh = q + static_cast<size_t>(blockIdx.y) * T * D;
    const int col = (tid % 128) * 4;
    if (col < D) {
      for (int r = tid / 128; r < kXRows; r += kXThreads / 128) {
        const bool ok = q0 + r < T;
        cp_async16(Qs + xsw(r, col, D),
                   ok ? qh + static_cast<size_t>(q0 + r) * D + col : q, ok);
      }
    }
  }
  if (tid < kXRows) row_l[tid] = 0.f;
  xwide_issue<D>(ring, k, v, 0, 0, T);
  cp_async_commit();

  float m[2][2] = {{-INFINITY, -INFINITY}, {-INFINITY, -INFINITY}};
  float oacc[2][NJ][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) oacc[i][j][e] = 0.f;

  const int n_ktiles = (T + kXKeys - 1) / kXKeys;
  // the chunk in flight: chunk nc of the tile at nk0, in buffer nb
  int nc = 0, nk0 = 0, nb = 0;
  // wait for the chunk in flight (every thread's copies), then start the
  // next one in the other buffer, which the chunk before held: the barrier
  // says every warp is done with it. Returns the arrived chunk's buffer.
  auto next_chunk = [&]() -> const float* {
    cp_async_wait<0>();
    __syncthreads();
    const float* buf = ring + nb * S::BUF;
    nb ^= 1;
    if (++nc == NS) {
      nc = 0;
      nk0 += kXKeys;
    }
    if (nk0 < T) {
      xwide_issue<D>(ring + nb * S::BUF, k, v, nc, nk0, T);
      cp_async_commit();
    }
    return buf;
  };

  for (int kt = 0; kt < n_ktiles; ++kt) {
    const int k0 = kt * kXKeys;
    // S = Q K^T over the tile. A chunk's products accumulate in the tensor
    // cores (24 steps); the running sum over the chunks is kept in fp32 in
    // the P tile's shared memory, each lane at the places of its own scores,
    // so that it costs no registers (O holds 128)
    float sacc[2][4][4];
#pragma unroll 1
    for (int c = 0; c < NK; ++c) {
      const float* B = next_chunk() + kb;
      const float* A = qa + c * kXKc;
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) sacc[i][j][e] = 0.f;
#pragma unroll 1
      for (int p = 0; p < kXKc / 8; ++p) {
        const int off = 8 * (p ^ gq);
        uint32_t ah[2][4], al[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          split_a(ld2(A + 16 * i * D + off), ld2(A + (16 * i + 8) * D + off),
                  ah[i], al[i]);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 b = ld2(B + 8 * j * kXKc + off);
          uint32_t bh0, bl0, bh1, bl1;
          split_tf32(b.x, bh0, bl0);
          split_tf32(b.y, bh1, bl1);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            mma_tf32(sacc[i][j], al[i], bh0, bh1);
            mma_tf32(sacc[i][j], ah[i], bl0, bl1);
            mma_tf32(sacc[i][j], ah[i], bh0, bh1);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float2* run = reinterpret_cast<float2*>(
                Ps + srun + (16 * i + 8 * h) * kXKeys + 8 * (j ^ gq));
            if (c > 0) {
              const float2 r = *run;
              sacc[i][j][2 * h] += r.x;
              sacc[i][j][2 * h + 1] += r.y;
            }
            if (c + 1 < NK) *run = make_float2(sacc[i][j][2 * h], sacc[i][j][2 * h + 1]);
          }
    }
    // the online softmax over this tile's keys; row r = row0 + 16 i + 8 h
    // of the lane, its values sacc[i][j][2 h], [2 h + 1]
    float mx[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[i][h] = -INFINITY;
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 2 * h; e < 2 * h + 2; ++e) {
            const int key = k0 + skey + 8 * j + 2 * t + (e & 1);
            sacc[i][j][e] = key < T ? sacc[i][j][e] * scale_log2 : -INFINITY;
            mx[i][h] = fmaxf(mx[i][h], sacc[i][j][e]);
          }
        mx[i][h] = fmaxf(mx[i][h], __shfl_xor_sync(kFull, mx[i][h], 1));
        mx[i][h] = fmaxf(mx[i][h], __shfl_xor_sync(kFull, mx[i][h], 2));
        if (t == 0) red_max[kq * kXRows + row0 + 16 * i + 8 * h] = mx[i][h];
      }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row0 + 16 * i + 8 * h;
        // key k0 < T lies in every tile, so m_new is finite
        const float m_new =
            fmaxf(fmaxf(m[i][h], fmaxf(red_max[r], red_max[kXRows + r])),
                  fmaxf(red_max[2 * kXRows + r], red_max[3 * kXRows + r]));
        if (kq == 0 && t == 0) row_alpha[r] = exp2f(m[i][h] - m_new);
        m[i][h] = m_new;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float p0 = exp2f(sacc[i][j][2 * h] - m_new);
          const float p1 = exp2f(sacc[i][j][2 * h + 1] - m_new);
          sum += p0 + p1;
          *reinterpret_cast<float2*>(Ps + xsw(r, skey + 8 * j + 2 * t, kXKeys)) =
              make_float2(p0, p1);
        }
        sum += __shfl_xor_sync(kFull, sum, 1);
        sum += __shfl_xor_sync(kFull, sum, 2);
        if (t == 0) red_sum[kq * kXRows + r] = sum;
      }

    // O += P V over the tile, V chunk by chunk
#pragma unroll 1
    for (int vc = 0; vc < kXVChunks; ++vc) {
      const float* B = next_chunk();
      if (vc == 0) {
        // the tile's P, row sums and rescale factors are visible now; row
        // r's sum is kept by the thread that wrote its rescale factor
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = row0 + 16 * i + 8 * h;
            const float a = row_alpha[r];
            if (kq == 0 && t == 0)
              row_l[r] = row_l[r] * a +
                         ((red_sum[r] + red_sum[kXRows + r]) +
                          (red_sum[2 * kXRows + r] + red_sum[3 * kXRows + r]));
#pragma unroll
            for (int j = 0; j < NJ; ++j) {
              oacc[i][j][2 * h] *= a;
              oacc[i][j][2 * h + 1] *= a;
            }
          }
      }
#pragma unroll 1
      for (int ks = 0; ks < kXVKeys / 8; ++ks) {
        const int key = vc * kXVKeys + 8 * ks + 2 * t;
        uint32_t ah[2][4], al[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = row0 + 16 * i;
          split_a(ld2(Ps + xsw(r, key, kXKeys)),
                  ld2(Ps + xsw(r + 8, key, kXKeys)), ah[i], al[i]);
        }
        // V rows 8 ks + 2 t and + 1 (logical k = t, t + 4), column
        // ocol + 8 j + g; two n-blocks at a time, the next two loaded while
        // these are multiplied. The products are issued in program order
        // (mma_tf32_seq): left to itself ptxas interleaved all 32 of a
        // k-step and spilled their accumulators.
        const float* vb = B + (8 * ks + 2 * t) * LDV + ocol + g;
        float x[2][2] = {{vb[0], vb[LDV]}, {vb[8], vb[LDV + 8]}};
#pragma unroll
        for (int j = 0; j < NJ; j += 2) {
          uint32_t bh[2][2], bl[2][2];
#pragma unroll
          for (int u = 0; u < 2; ++u)
#pragma unroll
            for (int w = 0; w < 2; ++w) split_tf32(x[u][w], bh[u][w], bl[u][w]);
          if (j + 2 < NJ) {
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              x[u][0] = vb[8 * (j + 2 + u)];
              x[u][1] = vb[LDV + 8 * (j + 2 + u)];
            }
          }
          float c4[2][2][4];
#pragma unroll
          for (int u = 0; u < 2; ++u)
#pragma unroll
            for (int i = 0; i < 2; ++i) mma_tf32_seq(c4[u][i], al[i], bh[u][0], bh[u][1], true);
#pragma unroll
          for (int u = 0; u < 2; ++u)
#pragma unroll
            for (int i = 0; i < 2; ++i) mma_tf32_seq(c4[u][i], ah[i], bl[u][0], bl[u][1], false);
#pragma unroll
          for (int u = 0; u < 2; ++u)
#pragma unroll
            for (int i = 0; i < 2; ++i) mma_tf32_seq(c4[u][i], ah[i], bh[u][0], bh[u][1], false);
#pragma unroll
          for (int u = 0; u < 2; ++u)
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
              for (int e = 0; e < 4; ++e) oacc[i][j + u][e] += c4[u][i][e];
        }
      }
    }
  }

  if (kq == 0 && t == 0 && lse != nullptr) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row0 + 16 * i + 8 * h;
        if (q0 + r < T)
          lse[static_cast<size_t>(blockIdx.y) * T + q0 + r] =
              (m[i][h] + log2f(row_l[r])) * kLn2;
      }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 16 * i + 8 * h;
      if (q0 + row >= T) continue;
      const float inv = 1.f / row_l[row];
      float* dst = o + (static_cast<size_t>(blockIdx.y) * T + q0 + row) * D +
                   ocol + 2 * t;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        *reinterpret_cast<float2*>(dst + 8 * j) =
            make_float2(oacc[i][j][2 * h] * inv, oacc[i][j][2 * h + 1] * inv);
    }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// the routes of uurg_torch/ops/flash_attention.py::_f32_plan
constexpr int kRouteWide = 0, kRouteTiled = 1, kRoutePacked = 2,
              kRouteXWide = 3;

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
int launch_fwd_xwide(const float* q, const float* k, const float* v, float* o,
                     float* lse, int BH, int T, float scale,
                     cudaStream_t stream) {
  constexpr size_t smem = xwide_smem<D>();
  cudaError_t err = allow_smem(attn_fwd_xwide<D>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // heads on blockIdx.y, whose limit is 65535: more heads take more launches
  for (int h0 = 0; h0 < BH; h0 += kMaxGridY) {
    const size_t at = static_cast<size_t>(h0) * T;
    const dim3 grid((T + kXRows - 1) / kXRows, min(BH - h0, kMaxGridY));
    attn_fwd_xwide<D><<<grid, kXThreads, smem, stream>>>(
        q + at * D, k + at * D, v + at * D, o + at * D,
        lse ? lse + at : nullptr, T, scale * kLog2e);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

int dispatch_fwd_xwide(const float* q, const float* k, const float* v,
                       float* o, float* lse, int BH, int T, int D, float scale,
                       cudaStream_t s) {
  switch (D) {
    case 320: return launch_fwd_xwide<320>(q, k, v, o, lse, BH, T, scale, s);
    case 384: return launch_fwd_xwide<384>(q, k, v, o, lse, BH, T, scale, s);
    case 448: return launch_fwd_xwide<448>(q, k, v, o, lse, BH, T, scale, s);
    default: return launch_fwd_xwide<512>(q, k, v, o, lse, BH, T, scale, s);
  }
}

int launch_fwd_d64(const float* q, const float* k, const float* v, float* o,
                   float* lse, int BH, int T, float scale, bool packed,
                   cudaStream_t stream) {
  constexpr size_t smem = fwd_d64_smem();
  cudaError_t err = allow_smem(attn_fwd_d64, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long rows = static_cast<long long>(BH) * T;
  const int group = packed ? kPackT / T : 0;
  const int n_tiles = packed ? 1 : (T + kDqRows - 1) / kDqRows;
  const int blocks = packed ? (BH + group * kWarps - 1) / (group * kWarps)
                            : BH * n_tiles;
  attn_fwd_d64<<<blocks, kNT, smem, stream>>>(
      q, k, v, o, lse, T, n_tiles, group, rows, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

int launch_delta(const float* o, const float* g, float* delta, int BH, int T,
                 int D, cudaStream_t stream) {
  const long long rows = static_cast<long long>(BH) * T;
  const int per_block = kThreads / 32;
  const unsigned blocks =
      static_cast<unsigned>((rows + per_block - 1) / per_block);
  switch (D) {
    case 64:
      attn_delta_f32<64><<<blocks, kThreads, 0, stream>>>(o, g, delta, rows);
      break;
    case 128:
      attn_delta_f32<128><<<blocks, kThreads, 0, stream>>>(o, g, delta, rows);
      break;
    case 192:
      attn_delta_f32<192><<<blocks, kThreads, 0, stream>>>(o, g, delta, rows);
      break;
    default:
      attn_delta_f32<256><<<blocks, kThreads, 0, stream>>>(o, g, delta, rows);
      break;
  }
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_bwd(const float* q, const float* k, const float* v, const float* g,
               const float* lse, const float* delta, float* dq, float* dk,
               float* dv, int BH, int T, float scale, cudaStream_t stream) {
  const int n_tiles = (T + kRows - 1) / kRows;
  constexpr size_t smem_kv = dkdv_smem<D>();
  cudaError_t err = allow_smem(attn_bwd_dkdv_f32<D>, smem_kv);
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

int launch_bwd_d64(const float* q, const float* k, const float* v,
                   const float* g, const float* lse, const float* delta,
                   float* scratch, float* dq, float* dk, float* dv, int BH,
                   int T, float scale, bool packed, cudaStream_t stream) {
  constexpr size_t smem = bwd_d64_smem();
  cudaError_t err = allow_smem(attn_bwd_d64, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long rows = static_cast<long long>(BH) * T;
  const int group = packed ? kPackT / T : 0;
  const int n_tiles = packed ? 1 : (T + kKeyTile - 1) / kKeyTile;
  const int blocks = packed ? (BH + 2 * group - 1) / (2 * group)
                            : BH * n_tiles;
  attn_bwd_d64<<<blocks, kNT, smem, stream>>>(
      q, k, v, g, lse, delta, packed ? dq : scratch, dk, dv, T, n_tiles,
      group, rows, scale, scale * kLog2e);
  err = cudaGetLastError();
  if (err != cudaSuccess || packed) return static_cast<int>(err);
  const int n_q = (T + kDqRows - 1) / kDqRows;
  err = allow_smem(attn_bwd_dq_d64, dq_d64_smem());
  if (err != cudaSuccess) return static_cast<int>(err);
  attn_bwd_dq_d64<<<BH * n_q, kNT, dq_d64_smem(), stream>>>(scratch, k, dq, T,
                                                           n_q);
  return static_cast<int>(cudaGetLastError());
}

// the route's own conditions
bool route_ok(int route, int T, int D) {
  if (T < 1) return false;
  if (route == kRouteWide) return D == 128 || D == 192 || D == 256;
  if (route == kRouteTiled) return D == kD;
  if (route == kRouteXWide) return D == 320 || D == 384 || D == 448 || D == 512;
  return route == kRoutePacked && D == kD && T <= kPackT;
}

}  // namespace

// q, k, v, o: contiguous float32 (BH, T, D), 16-byte aligned; lse: float32
// (BH, T) or null; route: 0 wide, 1 tiled, 2 packed, 3 xwide. Returns the
// CUDA error code of the launch (0 on success).
extern "C" int uurg_attention_fwd_f32(const void* q, const void* k,
                                      const void* v, void* o, void* lse,
                                      int BH, int T, int D, float scale,
                                      int route, void* stream) {
  const float *qf = static_cast<const float*>(q),
              *kf = static_cast<const float*>(k),
              *vf = static_cast<const float*>(v);
  float* of = static_cast<float*>(o);
  float* lf = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!route_ok(route, T, D)) return static_cast<int>(cudaErrorInvalidValue);
  if (route == kRouteXWide)
    return dispatch_fwd_xwide(qf, kf, vf, of, lf, BH, T, D, scale, s);
  if (route != kRouteWide)
    return launch_fwd_d64(qf, kf, vf, of, lf, BH, T, scale,
                          route == kRoutePacked, s);
  switch (D) {
    case 128: return launch_fwd<128>(qf, kf, vf, of, lf, BH, T, scale, s);
    case 192: return launch_fwd<192>(qf, kf, vf, of, lf, BH, T, scale, s);
    default: return launch_fwd<256>(qf, kf, vf, of, lf, BH, T, scale, s);
  }
}

// q, k, v, o, g, dq, dk, dv: contiguous float32 (BH, T, D); lse (the
// forward's) and delta (scratch): float32 (BH, T); scratch: float32
// (ceil(T / 64), BH, T, 64) for the tiled route, else unused; route 0, 1 or
// 2 (the xwide backward is flash_attention_xwide_bwd.cu's). Launches in
// stream order: delta, then dk/dv and dq (wide), the key-tile kernel and the
// dq sum (tiled), or the key-tile kernel alone (packed).
extern "C" int uurg_attention_bwd_f32(const void* q, const void* k,
                                      const void* v, const void* o,
                                      const void* g, const void* lse,
                                      void* delta, void* scratch, void* dq,
                                      void* dk, void* dv, int BH, int T,
                                      int D, float scale, int route,
                                      void* stream) {
  const float *qf = static_cast<const float*>(q),
              *kf = static_cast<const float*>(k),
              *vf = static_cast<const float*>(v),
              *of = static_cast<const float*>(o),
              *gf = static_cast<const float*>(g),
              *lf = static_cast<const float*>(lse);
  float *df = static_cast<float*>(delta), *sf = static_cast<float*>(scratch),
        *dqf = static_cast<float*>(dq), *dkf = static_cast<float*>(dk),
        *dvf = static_cast<float*>(dv);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!route_ok(route, T, D) || route == kRouteXWide ||
      (route == kRouteTiled && sf == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int err = launch_delta(of, gf, df, BH, T, D, s);
  if (err != 0) return err;
  if (route != kRouteWide)
    return launch_bwd_d64(qf, kf, vf, gf, lf, df, sf, dqf, dkf, dvf, BH, T,
                          scale, route == kRoutePacked, s);
  switch (D) {
    case 128:
      return launch_bwd<128>(qf, kf, vf, gf, lf, df, dqf, dkf, dvf, BH, T,
                             scale, s);
    case 192:
      return launch_bwd<192>(qf, kf, vf, gf, lf, df, dqf, dkf, dvf, BH, T,
                             scale, s);
    default:
      return launch_bwd<256>(qf, kf, vf, gf, lf, df, dqf, dkf, dvf, BH, T,
                             scale, s);
  }
}
