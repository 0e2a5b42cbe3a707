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
// T = 256, under the H100's 295 bf16 flops a byte. This design runs seven
// products (S and dP in both passes) and re-reads tiles from L2 (a head's Q
// and g once for each of its key tiles), so what it has to keep small is the
// time the tensor cores and the SM's memory port stand idle: every product is
// a wgmma fed from swizzled shared memory or registers, loads run under the
// products, and blocks are persistent so that one item's output store and the
// next item's first loads overlap. Debug builds with cycle stamps showed the
// longest part of a 64-row step of the dk/dv pass to be the P^T hand-over
// between the warpgroups (one warp a scheduler runs its exponentials and
// stores at single-warp speed while the other warpgroup waits), and the SM's
// memory port to be busy between two items with the next tiles and the
// output, whatever way the output is stored.
//
// Design. The TPU kernel walks q blocks in grid order and adds every block's
// share of dk and dv into one output block, which is race-free only because a
// TPU grid runs in sequence. Hopper runs blocks in parallel, so the work is
// split into passes that each own what they write, with no atomics, so that
// repeated runs give the same bits:
//   1. delta: delta_i = sum_d g_id o_id per row (fp32), one warp a row. This
//      equals the TPU kernel's rowsum(P * dP) in exact arithmetic (o = P v);
//      it is taken from the bf16 forward output, which the tests allow for.
//   2. dk/dv, key-tile major: a work item is 64 keys of a head (K and V
//      resident), 64-row tiles of Q and g stream through a two-stage ring.
//   3. dq, q-tile major: a work item is 128 query rows of a head (Q and g
//      resident), 32-key tiles of K and V stream through a two-stage ring.
// P is rebuilt tile by tile as exp(s - lse) from the forward's log-sum-exp.
// Passes 2 and 3 run one persistent block on each SM (208 KB and 192 KB of
// shared memory at D = 256), which walks work items blockIdx.x, + gridDim.x,
// ...: the streaming ring runs on across items, and the resident tiles are
// handed back as soon as their last product is done, so the next item's
// loads run under this item's last products and its stores.
//
// Both passes are warp-specialised: a producer warp issues TMA loads (boxes of
// 64 columns in the 128-byte swizzle, completion counted on a "full" mbarrier
// a stage, the stage handed back on an "empty" one), gives its registers to
// two consumer warpgroups (setmaxnreg), and those run wgmma, bf16 in and fp32
// accumulate. Tiles are used as they lie in memory: the same tile of Q is the
// K-major operand of S^T = K Q^T and the MN-major operand of dK += dS^T Q, so
// no transposed copy exists and each tile is read from device memory once a
// step. The tensor maps have three dimensions (B*H, T, D): rows past T arrive
// as zeros, never as the next head's rows.
//
// dk/dv pass, per 64-row step: warpgroup A computes S^T = K Q^T, forms P^T in
// registers, hands it in fp32 to warpgroup B through shared memory (each
// thread's 32 values go to the thread of the same index, which holds the same
// elements of dP^T, so the copy is free of bank conflicts), rounds it to bf16
// in place as the A operand and owns dV += P^T g (64 x D fp32, D / 2
// registers a thread). Warpgroup B computes dP^T = V g^T meanwhile, takes
// P^T, forms dS^T in registers and owns dK += dS^T Q. Four products a step,
// none repeated. Two named barriers order the hand-over.
//
// dq pass, per 32-key step: each consumer warpgroup owns 64 query rows,
// computes S = Q K^T and dP = g V^T (64 x 32 each), forms dS in registers and
// adds dQ += dS K with dS as the A operand.
//
// Masking: rows and keys past T (ragged tiles, the T = 16 mid site) are
// zero-filled by TMA, their P is set to 0 and they are not stored. Padded head
// columns (D not a multiple of 64, zero-padded by the caller) are zero in q,
// k, v, o and g, so their gradients are zero and the caller slices them off.
#include <math.h>

#include "hopper_mma.cuh"

namespace {

using namespace hopper;

constexpr int kStages = 2;
constexpr int kThreads = 3 * 128;   // two consumer warpgroups and the producer's
constexpr int kKV_BK = 64;          // keys per block, dk/dv pass
constexpr int kKV_BQ = 64;          // query rows per step, dk/dv pass
constexpr int kQ_BQ = 128;          // query rows per block, dq pass
constexpr int kQ_BK = 32;           // keys per step, dq pass
constexpr int kDeltaWarps = 8;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kBarPReady = 1, kBarPFree = 2;   // named barriers, 256 threads

// grid: ceil(rows / kDeltaWarps); block: kDeltaWarps * 32. delta[row] = sum_d g o.
template <int D>
__global__ void __launch_bounds__(kDeltaWarps * 32)
attn_bwd_delta_kernel(const __nv_bfloat16* __restrict__ o,
                      const __nv_bfloat16* __restrict__ g,
                      float* __restrict__ delta, int rows) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * kDeltaWarps + warp;
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
  // K, V, kStages of (Q tile, g tile), the fp32 P^T hand-over, alignment room
  return static_cast<size_t>(2 * kKV_BK + kStages * 2 * kKV_BQ) * D * 2 +
         32 * 128 * sizeof(float) + 1024;
}

// grid: min(work items, SMs); block: kThreads. Work item w is key tile
// w % n_ktiles of head w / n_ktiles.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
attn_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const __grid_constant__ CUtensorMap tm_g,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv, int T, int n_ktiles,
                     int n_work, float scale) {
  constexpr int NC = D / kChunkCols;
  constexpr uint32_t kChunk = 64 * kRowBytes;        // every tile here has 64 rows
  constexpr uint32_t kTile = NC * kChunk;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 + 2 * kStages];

  const uint32_t k_s = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t v_s = k_s + kTile;
  const uint32_t st_s = v_s + kTile;                 // stage s: Q then g
  float* px = reinterpret_cast<float*>(
      smem_raw + (st_s + kStages * 2 * kTile - smem_u32(smem_raw)));
  const uint32_t kv_full = smem_u32(&bars[0]);
  const uint32_t kv_empty = smem_u32(&bars[1]);
  const uint32_t qg_full = smem_u32(&bars[2]);       // + 8 * stage
  const uint32_t qg_empty = smem_u32(&bars[2 + kStages]);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_tiles = (T + kKV_BQ - 1) / kKV_BQ;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    mbar_init(kv_empty, 8);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(qg_full + 8 * s, 1);
      mbar_init(qg_empty + 8 * s, 8);                // one arrival a consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= 8) {
    // ------------------------------------------------------------ producer
    reg_dealloc<40>();
    if (warp == 8 && lane == 0) {
      uint32_t it = 0;                               // Q/g tiles loaded so far
      for (int w = blockIdx.x, item = 0; w < n_work; w += gridDim.x, ++item) {
        const int head = w / n_ktiles, k0 = (w % n_ktiles) * kKV_BK;
        mbar_wait(kv_empty, (item & 1) ^ 1);
        mbar_expect_tx(kv_full, 2 * kTile);
        tma_load_tile<D>(k_s, &tm_k, kv_full, kKV_BK, k0, head);
        tma_load_tile<D>(v_s, &tm_v, kv_full, kKV_BK, k0, head);
        for (int j = 0; j < n_tiles; ++j, ++it) {
          const uint32_t s = it % kStages;
          mbar_wait(qg_empty + 8 * s, ((it / kStages) & 1) ^ 1);
          const uint32_t q_s = st_s + s * 2 * kTile;
          mbar_expect_tx(qg_full + 8 * s, 2 * kTile);
          tma_load_tile<D>(q_s, &tm_q, qg_full + 8 * s, kKV_BQ, j * kKV_BQ, head);
          tma_load_tile<D>(q_s + kTile, &tm_g, qg_full + 8 * s, kKV_BQ, j * kKV_BQ, head);
        }
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    reg_alloc<232>();
    const int wg = warp >> 2;                        // 0: S^T, P^T, dV; 1: dP^T, dS^T, dK
    const int tid = threadIdx.x & 127;
    const int g = lane >> 2, tq = lane & 3;          // accumulator row / column pair
    const float scale_log2 = scale * kLog2e;
    // the resident operand: K for warpgroup A, V for warpgroup B
    const uint64_t a_desc = mma_desc(wg == 0 ? k_s : v_s);
    uint32_t it = 0;                                 // Q/g tiles consumed so far
    if (wg == 1) bar_arrive(kBarPFree, 256);         // the hand-over starts free

    for (int w = blockIdx.x, item = 0; w < n_work; w += gridDim.x, ++item) {
      const int head = w / n_ktiles, k0 = (w % n_ktiles) * kKV_BK;
      const bool last_item = w + gridDim.x >= n_work;
      const int key0 = k0 + (warp & 3) * 16 + g, key1 = key0 + 8;
      const bool key_ok[2] = {key0 < T, key1 < T};
      const float* row_stat =
          (wg == 0 ? lse : delta) + static_cast<size_t>(head) * T;
      const float stat_mul = wg == 0 ? kLog2e : 1.f;   // A wants the lse in log2

      float acc[NC][32];                             // dV (A) or dK (B)
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;

      mbar_wait(kv_full, item & 1);

      for (int j = 0; j < n_tiles; ++j, ++it) {
        const uint32_t s = it % kStages;
        const int q0 = j * kKV_BQ;
        const uint64_t q_desc = mma_desc(st_s + s * 2 * kTile);
        const uint64_t g_desc = mma_desc(st_s + s * 2 * kTile + kTile);
        // A contracts K with Q and then multiplies into g's rows; B contracts
        // V with g and then multiplies into Q's rows
        const uint64_t b1_desc = wg == 0 ? q_desc : g_desc;
        const uint64_t b2_desc = wg == 0 ? g_desc : q_desc;
        mbar_wait(qg_full + 8 * s, (it / kStages) & 1);

        // S^T = K Q^T (A) or dP^T = V g^T (B): 64 keys x 64 query rows
        float t[32];
        wgmma_fence();
#pragma unroll
        for (int c = 0; c < NC; ++c)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const uint32_t off = (c * kChunk + kk * kStepKMajor) >> 4;
            wgmma_ss_n64(t, a_desc + off, b1_desc + off, (c | kk) != 0);
          }
        wgmma_commit();
        // this thread's 16 query columns: log-sum-exp (A) or delta (B)
        float stat[16];
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const int qi = q0 + (i >> 1) * 8 + tq * 2 + (i & 1);
          stat[i] = qi < T ? row_stat[qi] * stat_mul : 0.f;
        }
        wgmma_wait<0>();
        reg_fence(t);
        // K and V have been read for the last time: the next item's may come
        if (j == n_tiles - 1 && lane == 0) mbar_arrive(kv_empty);

        if (wg == 0) {
          // P = 0 past T. (Selects, not a branch around an unmasked copy of the
          // loop: with the branch ptxas adds a wgmma wait and fence of its own.)
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            const int col = (i >> 2) * 2 + (i & 1);
            const int qi = q0 + (i >> 2) * 8 + tq * 2 + (i & 1);
            t[i] = (key_ok[(i >> 1) & 1] && qi < T)
                       ? ex2(fmaf(t[i], scale_log2, -stat[col]))
                       : 0.f;
          }
          bar_sync(kBarPFree, 256);
#pragma unroll
          for (int i = 0; i < 32; ++i) px[i * 128 + tid] = t[i];
          __threadfence_block();
          bar_arrive(kBarPReady, 256);
        } else {
          bar_sync(kBarPReady, 256);
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            const int col = (i >> 2) * 2 + (i & 1);
            t[i] = px[i * 128 + tid] * (t[i] - stat[col]) * scale;
          }
          // no arrival is left pending when the block ends
          if (!(last_item && j == n_tiles - 1)) bar_arrive(kBarPFree, 256);
        }

        // dV += P^T g (A) or dK += dS^T Q (B): the query rows are the contraction
        uint32_t ta[4][4];
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) acc_to_a(ta[ks], t + 8 * ks);
#pragma unroll
        for (int c = 0; c < NC; ++c) reg_fence(acc[c]);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
#pragma unroll
          for (int c = 0; c < NC; ++c)
            wgmma_rs_n64(acc[c], ta[ks],
                         b2_desc + ((c * kChunk + ks * kStepMNMajor) >> 4));
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int c = 0; c < NC; ++c) reg_fence(acc[c]);
        if (lane == 0) mbar_arrive(qg_empty + 8 * s);
      }

      __nv_bfloat16* dst = (wg == 0 ? dv : dk) + static_cast<size_t>(head) * T * D;
      store_acc<NC>(dst, acc, key0, T, tq, 1.f, 1.f);
    }
  }
}

template <int D>
constexpr size_t dq_smem_bytes() {
  // Q, g, kStages of (K tile, V tile), alignment room
  return static_cast<size_t>(2 * kQ_BQ + kStages * 2 * kQ_BK) * D * 2 + 1024;
}

// grid: min(work items, SMs); block: kThreads. Work item w is q tile
// w % n_qtiles of head w / n_qtiles.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
attn_bwd_dq_kernel(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   const __grid_constant__ CUtensorMap tm_g,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta,
                   __nv_bfloat16* __restrict__ dq, int T, int n_qtiles,
                   int n_work, float scale) {
  constexpr int NC = D / kChunkCols;
  constexpr uint32_t kQChunk = kQ_BQ * kRowBytes;
  constexpr uint32_t kKVChunk = kQ_BK * kRowBytes;
  constexpr uint32_t kQBytes = NC * kQChunk;
  constexpr uint32_t kKVBytes = NC * kKVChunk;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 + 2 * kStages];

  const uint32_t q_s = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t g_s = q_s + kQBytes;
  const uint32_t st_s = g_s + kQBytes;               // stage s: K then V
  const uint32_t qg_full = smem_u32(&bars[0]);
  const uint32_t qg_empty = smem_u32(&bars[1]);
  const uint32_t kv_full = smem_u32(&bars[2]);       // + 8 * stage
  const uint32_t kv_empty = smem_u32(&bars[2 + kStages]);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_tiles = (T + kQ_BK - 1) / kQ_BK;

  if (threadIdx.x == 0) {
    mbar_init(qg_full, 1);
    mbar_init(qg_empty, 8);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(kv_full + 8 * s, 1);
      mbar_init(kv_empty + 8 * s, 8);                // one arrival a consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= 8) {
    // ------------------------------------------------------------ producer
    reg_dealloc<40>();
    if (warp == 8 && lane == 0) {
      uint32_t it = 0;                               // K/V tiles loaded so far
      for (int w = blockIdx.x, item = 0; w < n_work; w += gridDim.x, ++item) {
        const int head = w / n_qtiles, q0 = (w % n_qtiles) * kQ_BQ;
        for (int j = 0; j < n_tiles; ++j, ++it) {
          const uint32_t s = it % kStages;
          mbar_wait(kv_empty + 8 * s, ((it / kStages) & 1) ^ 1);
          const uint32_t k_s = st_s + s * 2 * kKVBytes;
          mbar_expect_tx(kv_full + 8 * s, 2 * kKVBytes);
          tma_load_tile<D>(k_s, &tm_k, kv_full + 8 * s, kQ_BK, j * kQ_BK, head);
          tma_load_tile<D>(k_s + kKVBytes, &tm_v, kv_full + 8 * s, kQ_BK, j * kQ_BK, head);
          if (j == 0) {
            // after the first K/V tile, which needs no free Q/g buffer
            mbar_wait(qg_empty, (item & 1) ^ 1);
            mbar_expect_tx(qg_full, 2 * kQBytes);
            tma_load_tile<D>(q_s, &tm_q, qg_full, kQ_BQ, q0, head);
            tma_load_tile<D>(g_s, &tm_g, qg_full, kQ_BQ, q0, head);
          }
        }
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    reg_alloc<232>();
    const int wg = warp >> 2;                        // which 64 query rows
    const int g = lane >> 2, tq = lane & 3;          // accumulator row / column pair
    const float scale_log2 = scale * kLog2e;
    const uint64_t q_desc = mma_desc(q_s + wg * 64 * kRowBytes);
    const uint64_t g_desc = mma_desc(g_s + wg * 64 * kRowBytes);
    uint32_t it = 0;                                 // K/V tiles consumed so far

    for (int w = blockIdx.x, item = 0; w < n_work; w += gridDim.x, ++item) {
      const int head = w / n_qtiles, q0 = (w % n_qtiles) * kQ_BQ;
      const int row0 = q0 + wg * 64 + (warp & 3) * 16 + g, row1 = row0 + 8;
      const bool row_ok[2] = {row0 < T, row1 < T};
      const float* lh = lse + static_cast<size_t>(head) * T;
      const float* dh = delta + static_cast<size_t>(head) * T;
      const float lse2[2] = {row_ok[0] ? lh[row0] * kLog2e : 0.f,
                             row_ok[1] ? lh[row1] * kLog2e : 0.f};
      const float dl[2] = {row_ok[0] ? dh[row0] : 0.f, row_ok[1] ? dh[row1] : 0.f};

      float acc[NC][32];
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;

      mbar_wait(qg_full, item & 1);

      for (int j = 0; j < n_tiles; ++j, ++it) {
        const uint32_t s = it % kStages;
        const int k0 = j * kQ_BK;
        const uint64_t k_desc = mma_desc(st_s + s * 2 * kKVBytes);
        const uint64_t v_desc = mma_desc(st_s + s * 2 * kKVBytes + kKVBytes);
        mbar_wait(kv_full + 8 * s, (it / kStages) & 1);

        // S = Q K^T and dP = g V^T for 64 rows x 32 keys
        float sc[16], dp[16];
        wgmma_fence();
#pragma unroll
        for (int c = 0; c < NC; ++c)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_ss_n32(sc, q_desc + ((c * kQChunk + kk * kStepKMajor) >> 4),
                         k_desc + ((c * kKVChunk + kk * kStepKMajor) >> 4),
                         (c | kk) != 0);
#pragma unroll
        for (int c = 0; c < NC; ++c)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_ss_n32(dp, g_desc + ((c * kQChunk + kk * kStepKMajor) >> 4),
                         v_desc + ((c * kKVChunk + kk * kStepKMajor) >> 4),
                         (c | kk) != 0);
        wgmma_commit();
        wgmma_wait<0>();
        reg_fence(sc);
        reg_fence(dp);
        // Q and g have been read for the last time: the next item's may come
        if (j == n_tiles - 1 && lane == 0) mbar_arrive(qg_empty);

        if (k0 + kQ_BK > T || q0 + kQ_BQ > T) {      // a ragged tile: P = 0 past T
#pragma unroll
          for (int i = 0; i < 16; ++i) {
            const int r = (i >> 1) & 1;
            const int key = k0 + (i >> 2) * 8 + tq * 2 + (i & 1);
            const float p = (row_ok[r] && key < T)
                                ? ex2(fmaf(sc[i], scale_log2, -lse2[r]))
                                : 0.f;
            sc[i] = p * (dp[i] - dl[r]) * scale;
          }
        } else {
#pragma unroll
          for (int i = 0; i < 16; ++i) {
            const int r = (i >> 1) & 1;
            sc[i] = ex2(fmaf(sc[i], scale_log2, -lse2[r])) * (dp[i] - dl[r]) * scale;
          }
        }

        // dQ += dS K: the keys are the contraction
        uint32_t da[2][4];
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) acc_to_a(da[ks], sc + 8 * ks);
#pragma unroll
        for (int c = 0; c < NC; ++c) reg_fence(acc[c]);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < 2; ++ks)
#pragma unroll
          for (int c = 0; c < NC; ++c)
            wgmma_rs_n64(acc[c], da[ks],
                         k_desc + ((c * kKVChunk + ks * kStepMNMajor) >> 4));
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int c = 0; c < NC; ++c) reg_fence(acc[c]);
        if (lane == 0) mbar_arrive(kv_empty + 8 * s);
      }

      store_acc<NC>(dq + static_cast<size_t>(head) * T * D, acc, row0, T, tq, 1.f, 1.f);
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* g, const void* lse, void* delta, void* dq, void* dk,
           void* dv, int BH, int T, float scale, cudaStream_t stream) {
  constexpr size_t kv_smem = kv_smem_bytes<D>();
  constexpr size_t dq_smem = dq_smem_bytes<D>();
  // at every call, not once: with the attribute set by an earlier call only, a
  // launch from autograd's thread after launches from the main thread was
  // refused (cudaErrorInvalidValue) on the card; setting it is cheap
  cudaError_t err = cudaFuncSetAttribute(
      attn_bwd_dkdv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kv_smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(
      attn_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(dq_smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int sms = 0;
  err = sm_count(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  // built at every call, since the pointers change; passed by value, so a
  // CUDA graph captures them with the launches
  CUtensorMap q64, k64, v64, g64, q128, k32, v32, g128;
  if (!make_tile_map(&q64, q, BH, T, D, kKV_BQ) ||
      !make_tile_map(&k64, k, BH, T, D, kKV_BK) ||
      !make_tile_map(&v64, v, BH, T, D, kKV_BK) ||
      !make_tile_map(&g64, g, BH, T, D, kKV_BQ) ||
      !make_tile_map(&q128, q, BH, T, D, kQ_BQ) ||
      !make_tile_map(&k32, k, BH, T, D, kQ_BK) ||
      !make_tile_map(&v32, v, BH, T, D, kQ_BK) ||
      !make_tile_map(&g128, g, BH, T, D, kQ_BQ))
    return kTensorMapFailed;
  using bf = __nv_bfloat16;
  const float* lp = static_cast<const float*>(lse);
  float* dp = static_cast<float*>(delta);
  const int rows = BH * T;
  attn_bwd_delta_kernel<D>
      <<<(rows + kDeltaWarps - 1) / kDeltaWarps, kDeltaWarps * 32, 0, stream>>>(
          static_cast<const bf*>(o), static_cast<const bf*>(g), dp, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_ktiles = (T + kKV_BK - 1) / kKV_BK, kv_work = BH * n_ktiles;
  attn_bwd_dkdv_kernel<D><<<kv_work < sms ? kv_work : sms, kThreads, kv_smem, stream>>>(
      q64, k64, v64, g64, lp, dp, static_cast<bf*>(dk), static_cast<bf*>(dv), T,
      n_ktiles, kv_work, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_qtiles = (T + kQ_BQ - 1) / kQ_BQ, q_work = BH * n_qtiles;
  attn_bwd_dq_kernel<D><<<q_work < sms ? q_work : sms, kThreads, dq_smem, stream>>>(
      q128, k32, v32, g128, lp, dp, static_cast<bf*>(dq), T, n_qtiles, q_work,
      scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, o, g, dq, dk, dv: contiguous (BH, T, D) bf16, 16-byte aligned, D in
// {64, 128, 192, 256} (the caller zero-pads other head widths and passes the
// true scale). lse: the forward's fp32 (BH, T) natural log-sum-exp; delta:
// fp32 (BH, T) scratch. Launches three kernels on the stream and returns the
// first launch error, or cudaGetLastError() after the last launch; -1 if a
// tensor map could not be encoded.
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
