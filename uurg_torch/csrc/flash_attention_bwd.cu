// Attention backward on (B*H, T, D) bf16: given q, k, v, the forward's output
// o and per-row log-sum-exp, and the output gradient g, write dq, dk and dv.
//
// Replaces: uurg_tpu/ops/flash_attention.py::_attn_bwd_kernel (launched by
// _fused_attention_bwd_impl). Same arithmetic: P = softmax(q k^T * scale) in
// fp32, dP = g v^T in fp32, dS = P (dP - delta) * scale, dq = dS k and
// dk = dS^T q with dS rounded to bf16, dv = P^T g with P rounded to bf16,
// every product accumulated in fp32 and each gradient stored once in bf16.
//
// Bound: bytes at the training path's shapes. Five products of 2 * T * T * D
// flops each on 7 * T * D * 2 bytes per head (q, k, v, g read; dq, dk, dv
// written; o and the log-sum-exp are inputs of this design, not of the
// function): 10 * T * T * D / (14 * T * D) = 0.714 * T flops a byte, 183 at
// T = 256, under the H100's 295 bf16 flops a byte.
//
// Design. The TPU kernel walks q blocks in grid order and adds every block's
// share of dk and dv into one output block, which is race-free only because a
// TPU grid runs in sequence. Hopper runs blocks in parallel, so the work is
// split into passes that each own what they write, with no atomics, so that
// repeated runs give the same bits:
//   1. delta: delta_i = sum_d g_id o_id per row (fp32), one warp a row. This
//      equals the TPU kernel's rowsum(P * dP) in exact arithmetic (o = P v);
//      it is taken from the bf16 forward output, which the tests allow for.
//   2. dk/dv, key-tile major: a block owns 64 keys and walks the q tiles of
//      its head (32 rows each), holding its dk and dv sums in registers.
//   3. dq, q-tile major: a block owns 64 query rows and walks the key tiles
//      (32 keys each), holding its dq sum in registers.
// P is rebuilt tile by tile as exp(s - lse) from the forward's log-sum-exp.
//
// Registers: at D = 256 the dk and dv sums of a 16-key warp tile would be
// 2 * 16 * 256 fp32 = 256 registers a thread. So each pass has two phases
// per tile, split between 8 warps: phase 1 computes the score tile S and
// dP (each warp a 16 x 16 piece, contracting over all of D) and writes P and
// dS, rounded to bf16 as the products want them, to shared memory; phase 2
// multiplies them into the sums, each warp owning 16 rows by half of D, so a
// thread holds 64 (dq) or 128 (dk plus dv) fp32 sums. Tiles are stored in
// shared memory both row-major (A operands and the S / dP B operands) and
// transposed (B operands of phase 2), with rows padded by 8 bf16 so fragment
// loads are free of bank conflicts: 149 KB (dk/dv) and 125 KB (dq) at D = 256.
// Products are mma.sync m16n8k16, bf16 in and fp32 accumulate.
//
// Masking: rows and keys past T (ragged tiles, the T = 16 mid site) are
// zero-filled, their P is set to 0 and they are not stored. Padded head
// columns (D not a multiple of 64, zero-padded by the caller) are zero in q,
// k, v, o and g, so their gradients are zero and the caller slices them off.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kPad = 8;       // bf16 padding per shared-memory row
constexpr int kKV_BK = 64;    // keys per block, dk/dv pass
constexpr int kKV_BQ = 32;    // query rows per step, dk/dv pass
constexpr int kQ_BQ = 64;     // query rows per block, dq pass
constexpr int kQ_BK = 32;     // keys per step, dq pass
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ void mma_16816(float* c, const uint32_t* a,
                                          const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// two floats -> bf16x2, the first in the low half (the lower column index)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A fragment (16 x 16, row-major) at row r0, column c0 of a tile with row
// stride S (elements)
__device__ __forceinline__ void load_a(uint32_t* a, const __nv_bfloat16* t,
                                       int S, int r0, int c0, int g, int tq) {
  const __nv_bfloat16* p = t + (r0 + g) * S + c0 + tq * 2;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * S);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * S + 8);
}

// B fragment (16 x 8, column-major): the tile stores the 8 columns as rows
// n0..n0+7, the 16 contraction indices k0.. contiguous within each row
__device__ __forceinline__ void load_b(uint32_t* b, const __nv_bfloat16* t,
                                       int S, int n0, int k0, int g, int tq) {
  const __nv_bfloat16* p = t + (n0 + g) * S + k0 + tq * 2;
  b[0] = ld32(p);
  b[1] = ld32(p + 8);
}

// rows [r0, r0 + R) of a (T, D) head into a row-major tile (row stride
// D + kPad); rows past T are zero
template <int D, int R>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src, int r0,
                                          int T, int tid) {
  constexpr int CH = D / 8;
  for (int i = tid; i < R * CH; i += kThreads) {
    const int r = i / CH, c = (i % CH) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < T)
      val = *reinterpret_cast<const uint4*>(src + static_cast<size_t>(r0 + r) * D + c);
    *reinterpret_cast<uint4*>(dst + r * (D + kPad) + c) = val;
  }
}

// the same rows stored transposed: dst[d][r], row stride R + kPad.
// Neighbouring threads take neighbouring rows so the 2-byte stores into a
// row of dst fall in distinct banks.
template <int D, int R>
__device__ __forceinline__ void load_rows_t(__nv_bfloat16* dst,
                                            const __nv_bfloat16* src, int r0,
                                            int T, int tid) {
  for (int i = tid; i < R * (D / 8); i += kThreads) {
    const int r = i % R, c = (i / R) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < T)
      val = *reinterpret_cast<const uint4*>(src + static_cast<size_t>(r0 + r) * D + c);
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&val);
#pragma unroll
    for (int j = 0; j < 8; ++j) dst[(c + j) * (R + kPad) + r] = e[j];
  }
}

// grid: ceil(rows / kWarps); block: kThreads. delta[row] = sum_d g o.
template <int D>
__global__ void __launch_bounds__(kThreads)
attn_bwd_delta_kernel(const __nv_bfloat16* __restrict__ o,
                      const __nv_bfloat16* __restrict__ g,
                      float* __restrict__ delta, int rows) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + warp;
  if (row >= rows) return;
  const size_t base = static_cast<size_t>(row) * D;
  float s = 0.f;
  for (int c = lane * 8; c < D; c += 256) {
    uint4 uo = *reinterpret_cast<const uint4*>(o + base + c);
    uint4 ug = *reinterpret_cast<const uint4*>(g + base + c);
    const __nv_bfloat162* ho = reinterpret_cast<const __nv_bfloat162*>(&uo);
    const __nv_bfloat162* hg = reinterpret_cast<const __nv_bfloat162*>(&ug);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 a = __bfloat1622float2(ho[i]);
      const float2 b = __bfloat1622float2(hg[i]);
      s += a.x * b.x + a.y * b.y;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) delta[row] = s;
}

template <int D>
constexpr size_t kv_smem_bytes() {
  return (2 * static_cast<size_t>(kKV_BK) * (D + kPad) +      // K, V
          2 * static_cast<size_t>(kKV_BQ) * (D + kPad) +      // Q, G row-major
          2 * static_cast<size_t>(D) * (kKV_BQ + kPad) +      // Q, G transposed
          2 * static_cast<size_t>(kKV_BK) * (kKV_BQ + kPad))  // P^T, dS^T
             * sizeof(__nv_bfloat16) +
         2 * kKV_BQ * sizeof(float);                          // lse, delta
}

// grid: (ceil(T / kKV_BK), B*H); block: kThreads.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
attn_bwd_dkdv_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const __nv_bfloat16* __restrict__ g,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv, int T, float scale) {
  constexpr int S = D + kPad;         // row stride of K, V, Q, G
  constexpr int ST = kKV_BQ + kPad;   // row stride of Qt, Gt, Pt, dSt
  constexpr int NH = D / 16;          // n-tiles of 8 in half of D
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Vs = Ks + kKV_BK * S;
  __nv_bfloat16* Qs = Vs + kKV_BK * S;
  __nv_bfloat16* Gs = Qs + kKV_BQ * S;
  __nv_bfloat16* Qt = Gs + kKV_BQ * S;
  __nv_bfloat16* Gt = Qt + D * ST;
  __nv_bfloat16* Pt = Gt + D * ST;        // [key][query]
  __nv_bfloat16* dSt = Pt + kKV_BK * ST;  // [key][query]
  float* lse_s = reinterpret_cast<float*>(dSt + kKV_BK * ST);
  float* delta_s = lse_s + kKV_BQ;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, tq = lane & 3;   // mma fragment row / column pair
  const int wr = (warp & 3) * 16;            // this warp's 16 keys in the tile
  const int wh = warp >> 2;                  // phase 1: query half; phase 2: D half
  const int k0 = blockIdx.x * kKV_BK;
  const size_t head = static_cast<size_t>(blockIdx.y) * T * D;
  const float scale_log2 = scale * kLog2e;

  load_rows<D, kKV_BK>(Ks, k + head, k0, T, tid);
  load_rows<D, kKV_BK>(Vs, v + head, k0, T, tid);

  float acc_dk[NH][4], acc_dv[NH][4];
#pragma unroll
  for (int n = 0; n < NH; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_dk[n][e] = acc_dv[n][e] = 0.f;

  for (int q0 = 0; q0 < T; q0 += kKV_BQ) {
    __syncthreads();   // the previous tile is consumed (and K, V are stored)
    load_rows<D, kKV_BQ>(Qs, q + head, q0, T, tid);
    load_rows<D, kKV_BQ>(Gs, g + head, q0, T, tid);
    load_rows_t<D, kKV_BQ>(Qt, q + head, q0, T, tid);
    load_rows_t<D, kKV_BQ>(Gt, g + head, q0, T, tid);
    for (int i = tid; i < kKV_BQ; i += kThreads) {
      const int row = q0 + i;
      const size_t at = static_cast<size_t>(blockIdx.y) * T + row;
      lse_s[i] = row < T ? lse[at] * kLog2e : 0.f;
      delta_s[i] = row < T ? delta[at] : 0.f;
    }
    __syncthreads();

    // phase 1: S^T = K Q^T and dP^T = V G^T for 16 keys x 16 queries
    float st[2][4], dpt[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < D; kk += 16) {
      uint32_t ak[4], av[4];
      load_a(ak, Ks, S, wr, kk, gr, tq);
      load_a(av, Vs, S, wr, kk, gr, tq);
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        uint32_t b[2];
        load_b(b, Qs, S, wh * 16 + n * 8, kk, gr, tq);
        mma_16816(st[n], ak, b);
        load_b(b, Gs, S, wh * 16 + n * 8, kk, gr, tq);
        mma_16816(dpt[n], av, b);
      }
    }
    // P^T and dS^T, rounded to bf16 into shared memory
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int key_l = wr + gr + hr * 8;
        const int col = wh * 16 + n * 8 + tq * 2;   // query within the tile
        float p[2], ds[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const bool ok = (k0 + key_l < T) && (q0 + col + j < T);
          p[j] = ok ? exp2f(st[n][hr * 2 + j] * scale_log2 - lse_s[col + j]) : 0.f;
          ds[j] = p[j] * (dpt[n][hr * 2 + j] - delta_s[col + j]) * scale;
        }
        *reinterpret_cast<uint32_t*>(Pt + key_l * ST + col) = pack_bf16(p[0], p[1]);
        *reinterpret_cast<uint32_t*>(dSt + key_l * ST + col) = pack_bf16(ds[0], ds[1]);
      }
    __syncthreads();

    // phase 2: dV += P^T G and dK += dS^T Q for 16 keys x half of D
#pragma unroll
    for (int ks = 0; ks < kKV_BQ; ks += 16) {
      uint32_t ap[4], as[4];
      load_a(ap, Pt, ST, wr, ks, gr, tq);
      load_a(as, dSt, ST, wr, ks, gr, tq);
#pragma unroll
      for (int n = 0; n < NH; ++n) {
        uint32_t b[2];
        load_b(b, Gt, ST, wh * (D / 2) + n * 8, ks, gr, tq);
        mma_16816(acc_dv[n], ap, b);
        load_b(b, Qt, ST, wh * (D / 2) + n * 8, ks, gr, tq);
        mma_16816(acc_dk[n], as, b);
      }
    }
  }

  const int row0 = k0 + wr + gr, row1 = row0 + 8;
#pragma unroll
  for (int n = 0; n < NH; ++n) {
    const int col = wh * (D / 2) + n * 8 + tq * 2;
    if (row0 < T) {
      const size_t at = head + static_cast<size_t>(row0) * D + col;
      *reinterpret_cast<uint32_t*>(dk + at) = pack_bf16(acc_dk[n][0], acc_dk[n][1]);
      *reinterpret_cast<uint32_t*>(dv + at) = pack_bf16(acc_dv[n][0], acc_dv[n][1]);
    }
    if (row1 < T) {
      const size_t at = head + static_cast<size_t>(row1) * D + col;
      *reinterpret_cast<uint32_t*>(dk + at) = pack_bf16(acc_dk[n][2], acc_dk[n][3]);
      *reinterpret_cast<uint32_t*>(dv + at) = pack_bf16(acc_dv[n][2], acc_dv[n][3]);
    }
  }
}

template <int D>
constexpr size_t dq_smem_bytes() {
  return (2 * static_cast<size_t>(kQ_BQ) * (D + kPad) +      // Q, G
          2 * static_cast<size_t>(kQ_BK) * (D + kPad) +      // K, V row-major
          static_cast<size_t>(D) * (kQ_BK + kPad) +          // K transposed
          static_cast<size_t>(kQ_BQ) * (kQ_BK + kPad))       // dS
             * sizeof(__nv_bfloat16) +
         2 * kQ_BQ * sizeof(float);                          // lse, delta
}

// grid: (ceil(T / kQ_BQ), B*H); block: kThreads.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
attn_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v,
                   const __nv_bfloat16* __restrict__ g,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta,
                   __nv_bfloat16* __restrict__ dq, int T, float scale) {
  constexpr int S = D + kPad;        // row stride of Q, G, K, V
  constexpr int ST = kQ_BK + kPad;   // row stride of Kt, dS
  constexpr int NH = D / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Gs = Qs + kQ_BQ * S;
  __nv_bfloat16* Ks = Gs + kQ_BQ * S;
  __nv_bfloat16* Vs = Ks + kQ_BK * S;
  __nv_bfloat16* Kt = Vs + kQ_BK * S;
  __nv_bfloat16* dSs = Kt + D * ST;       // [query][key]
  float* lse_s = reinterpret_cast<float*>(dSs + kQ_BQ * ST);
  float* delta_s = lse_s + kQ_BQ;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, tq = lane & 3;
  const int wr = (warp & 3) * 16;            // this warp's 16 query rows
  const int wh = warp >> 2;                  // phase 1: key half; phase 2: D half
  const int q0 = blockIdx.x * kQ_BQ;
  const size_t head = static_cast<size_t>(blockIdx.y) * T * D;
  const float scale_log2 = scale * kLog2e;

  load_rows<D, kQ_BQ>(Qs, q + head, q0, T, tid);
  load_rows<D, kQ_BQ>(Gs, g + head, q0, T, tid);
  for (int i = tid; i < kQ_BQ; i += kThreads) {
    const int row = q0 + i;
    const size_t at = static_cast<size_t>(blockIdx.y) * T + row;
    lse_s[i] = row < T ? lse[at] * kLog2e : 0.f;
    delta_s[i] = row < T ? delta[at] : 0.f;
  }

  float acc[NH][4];
#pragma unroll
  for (int n = 0; n < NH; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int k0 = 0; k0 < T; k0 += kQ_BK) {
    __syncthreads();   // the previous tile is consumed (and Q, G are stored)
    load_rows<D, kQ_BK>(Ks, k + head, k0, T, tid);
    load_rows<D, kQ_BK>(Vs, v + head, k0, T, tid);
    load_rows_t<D, kQ_BK>(Kt, k + head, k0, T, tid);
    __syncthreads();

    // phase 1: S = Q K^T and dP = G V^T for 16 rows x 16 keys
    float s[2][4], dp[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < D; kk += 16) {
      uint32_t aq[4], ag[4];
      load_a(aq, Qs, S, wr, kk, gr, tq);
      load_a(ag, Gs, S, wr, kk, gr, tq);
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        uint32_t b[2];
        load_b(b, Ks, S, wh * 16 + n * 8, kk, gr, tq);
        mma_16816(s[n], aq, b);
        load_b(b, Vs, S, wh * 16 + n * 8, kk, gr, tq);
        mma_16816(dp[n], ag, b);
      }
    }
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row_l = wr + gr + hr * 8;
        const int col = wh * 16 + n * 8 + tq * 2;   // key within the tile
        float ds[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const bool ok = (q0 + row_l < T) && (k0 + col + j < T);
          const float p =
              ok ? exp2f(s[n][hr * 2 + j] * scale_log2 - lse_s[row_l]) : 0.f;
          ds[j] = p * (dp[n][hr * 2 + j] - delta_s[row_l]) * scale;
        }
        *reinterpret_cast<uint32_t*>(dSs + row_l * ST + col) = pack_bf16(ds[0], ds[1]);
      }
    __syncthreads();

    // phase 2: dQ += dS K for 16 rows x half of D
#pragma unroll
    for (int ks = 0; ks < kQ_BK; ks += 16) {
      uint32_t a[4];
      load_a(a, dSs, ST, wr, ks, gr, tq);
#pragma unroll
      for (int n = 0; n < NH; ++n) {
        uint32_t b[2];
        load_b(b, Kt, ST, wh * (D / 2) + n * 8, ks, gr, tq);
        mma_16816(acc[n], a, b);
      }
    }
  }

  const int row0 = q0 + wr + gr, row1 = row0 + 8;
#pragma unroll
  for (int n = 0; n < NH; ++n) {
    const int col = wh * (D / 2) + n * 8 + tq * 2;
    if (row0 < T)
      *reinterpret_cast<uint32_t*>(dq + head + static_cast<size_t>(row0) * D + col) =
          pack_bf16(acc[n][0], acc[n][1]);
    if (row1 < T)
      *reinterpret_cast<uint32_t*>(dq + head + static_cast<size_t>(row1) * D + col) =
          pack_bf16(acc[n][2], acc[n][3]);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* g, const void* lse, void* delta, void* dq, void* dk,
           void* dv, int BH, int T, float scale, cudaStream_t stream) {
  constexpr size_t kv_smem = kv_smem_bytes<D>();
  constexpr size_t dq_smem = dq_smem_bytes<D>();
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        attn_bwd_dkdv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kv_smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaFuncSetAttribute(
        attn_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(dq_smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  using bf = __nv_bfloat16;
  const bf* qp = static_cast<const bf*>(q);
  const bf* kp = static_cast<const bf*>(k);
  const bf* vp = static_cast<const bf*>(v);
  const bf* gp = static_cast<const bf*>(g);
  const float* lp = static_cast<const float*>(lse);
  float* dp = static_cast<float*>(delta);
  const int rows = BH * T;
  attn_bwd_delta_kernel<D><<<(rows + kWarps - 1) / kWarps, kThreads, 0, stream>>>(
      static_cast<const bf*>(o), gp, dp, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  attn_bwd_dkdv_kernel<D>
      <<<dim3((T + kKV_BK - 1) / kKV_BK, BH), kThreads, kv_smem, stream>>>(
          qp, kp, vp, gp, lp, dp, static_cast<bf*>(dk), static_cast<bf*>(dv),
          T, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  attn_bwd_dq_kernel<D>
      <<<dim3((T + kQ_BQ - 1) / kQ_BQ, BH), kThreads, dq_smem, stream>>>(
          qp, kp, vp, gp, lp, dp, static_cast<bf*>(dq), T, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, o, g, dq, dk, dv: contiguous (BH, T, D) bf16, 16-byte aligned, D in
// {64, 128, 192, 256} (the caller zero-pads other head widths and passes the
// true scale). lse: the forward's fp32 (BH, T) natural log-sum-exp; delta:
// fp32 (BH, T) scratch. Launches three kernels on the stream and returns the
// first launch error, or cudaGetLastError() after the last launch.
extern "C" int uurg_attention_bwd(const void* q, const void* k, const void* v,
                                  const void* o, const void* g, const void* lse,
                                  void* delta, void* dq, void* dk, void* dv,
                                  int BH, int T, int D, float scale,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return launch<64>(q, k, v, o, g, lse, delta, dq, dk, dv, BH, T, scale, s);
    case 128: return launch<128>(q, k, v, o, g, lse, delta, dq, dk, dv, BH, T, scale, s);
    case 192: return launch<192>(q, k, v, o, g, lse, delta, dq, dk, dv, BH, T, scale, s);
    case 256: return launch<256>(q, k, v, o, g, lse, delta, dq, dk, dv, BH, T, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
