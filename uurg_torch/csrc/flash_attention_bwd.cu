// Attention backward on (B, H, T, D) bf16: given q, k, v, the forward's output
// o and per-row log-sum-exp, and the output gradient g, each in any layout
// whose last dimension is contiguous, write dq, dk and dv (contiguous).
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
// Products over the head width. S and dP contract over it: KS steps. dV +=
// P^T g, dK += dS^T Q and dQ += dS K have it as their N: one n64 instruction
// a whole 64-column chunk and a narrower one over the last chunk's columns
// below 16 KS (D = 72: n64 + n16), so no product runs over the zero columns.
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
// loads run under this item's last products and its stores. Where the tiles
// are at most 128 columns wide the resident tiles have two buffers, so the
// next item's are loaded before this item's last step (dk/dv 0.1375 ->
// 0.1327 ms, dq 0.0612 -> 0.0595 at (32, 16, 256, 72);
// scripts/profile_torch_attention.py in turns, NVIDIA H100 80GB HBM3,
// 700 W).
//
// Both passes are warp-specialised: a producer warp issues TMA loads (boxes of
// 64 columns in the 128-byte swizzle, completion counted on a "full" mbarrier
// a stage, the stage handed back on an "empty" one), gives its registers to
// two consumer warpgroups (setmaxnreg), and those run wgmma, bf16 in and fp32
// accumulate. Tiles are used as they lie in memory: the same tile of Q is the
// K-major operand of S^T = K Q^T and the MN-major operand of dK += dS^T Q, so
// no transposed copy exists and each tile is read from device memory once a
// step. The tensor maps have four dimensions (D, T, H, B) with each tensor's
// own strides and the true width D as dimension 0 (hopper_mma.cuh,
// make_tile_map): rows past T and columns past D arrive as zeros, never as the
// next head's rows or columns, so a (B, H, T, D) view of a fused
// (B, T, 3, H, D) projection is read where it lies. The template argument
// KS = ceil(D / 16) is the number of 16-deep steps of the products that
// contract over the head width (S and dP: 5 at D = 72, not the 8 of the
// padded 128); the tiles are ceil(D / 64) chunks wide in shared memory.
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
// zero-filled by TMA, their P is set to 0 and they are not stored. Columns
// past D are zero-filled in shared memory, so the accumulators' columns past D
// are zero; dq, dk and dv are stored at the true width D, contiguous
// (B, H, T, D), and nothing is sliced afterwards.
#include <math.h>

#include "hopper_mma.cuh"

namespace {

using namespace hopper;

constexpr int kThreads = 3 * 128;   // two consumer warpgroups and the producer's
constexpr int kKV_BK = 64;          // keys per block, dk/dv pass
constexpr int kKV_BQ = 64;          // query rows per step, dk/dv pass
constexpr int kQ_BQ = 128;          // query rows per block, dq pass
constexpr int kQ_BK = 32;           // keys per step, dq pass
constexpr int kDeltaWarps = 8;
constexpr int kDeltaBlocksPerSM = 8;   // 2048 threads: a whole SM
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kBarPReady = 1, kBarPFree = 2;   // named barriers, 256 threads

// delta[row] = sum_d g o over the D columns of row (head, t) of o and g, each
// read through its own strides; head = b * H + h, row = head * T + t. LR
// lanes a row (8 columns a lane: LR = 8 up to D = 128, 32 above), 32 / LR
// rows a warp; a grid of a few blocks a SM walks the rows (one block a row
// group would spend more time being scheduled than loading at D = 72:
// 131,072 rows of 144 bytes). Fewer lanes a row make fewer passes of the
// index arithmetic and the shuffles, which bound the kernel at narrow
// widths.
// grid: min(row groups, kDeltaBlocksPerSM * SMs); block: kDeltaWarps * 32.
template <int LR>
__global__ void __launch_bounds__(kDeltaWarps * 32)
attn_bwd_delta_kernel(const __nv_bfloat16* __restrict__ o, const Strides os,
                      const __nv_bfloat16* __restrict__ g, const Strides gs,
                      float* __restrict__ delta, int rows, int T, int H, int D) {
  constexpr int kRows = 32 / LR;                   // rows a warp
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int col0 = (lane % LR) * 8;
  for (int r0 = (blockIdx.x * kDeltaWarps + warp) * kRows; r0 < rows;
       r0 += gridDim.x * kDeltaWarps * kRows) {
    const int row = r0 + lane / LR;
    float s = 0.f;
    if (row < rows) {
      const int head = row / T, t = row - head * T;
      const int b = head / H, h = head - b * H;
      const __nv_bfloat16* orow = o + b * os.b + h * os.h + t * os.t;
      const __nv_bfloat16* grow = g + b * gs.b + h * gs.h + t * gs.t;
      for (int c = col0; c < D; c += 8 * LR) {
        uint4 uo = *reinterpret_cast<const uint4*>(orow + c);
        uint4 ug = *reinterpret_cast<const uint4*>(grow + c);
        const __nv_bfloat162* ho = reinterpret_cast<const __nv_bfloat162*>(&uo);
        const __nv_bfloat162* hg = reinterpret_cast<const __nv_bfloat162*>(&ug);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 a = __bfloat1622float2(ho[i]);
          const float2 b2 = __bfloat1622float2(hg[i]);
          s += a.x * b2.x + a.y * b2.y;
        }
      }
    }
#pragma unroll
    for (int off = LR / 2; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (row < rows && lane % LR == 0) delta[row] = s;
  }
}

// stages of the dq pass's K/V ring: four at narrow widths (more loads in
// flight for the few products a 32-key tile of a narrow head gives: 0.0706
// -> 0.0620 ms at D = 72), two at 192 and 256 columns. The dk/dv pass keeps
// two (four were slower there: 0.1388 -> 0.1448 ms; scripts/
// profile_torch_attention.py in turns, NVIDIA H100 80GB HBM3, 700 W).
template <int KS>
constexpr int kDqRing = Width<KS>::kNarrow ? 4 : 2;
constexpr int kKVStages = 2;

// buffers of the resident tiles (K and V in the dk/dv pass, Q and g in the dq
// pass): two at narrow widths, so that the next work item's are loaded under
// this item's last steps, one at 192 and 256 columns (shared memory)
template <int KS>
constexpr int kResident = Width<KS>::kNarrow ? 2 : 1;

template <int KS>
constexpr size_t kv_smem_bytes() {
  // buffers of (K, V), kKVStages of (Q tile, g tile), the fp32 P^T hand-over,
  // alignment room
  return static_cast<size_t>(kResident<KS> * 2 * kKV_BK +
                             kKVStages * 2 * kKV_BQ) * Width<KS>::kCols * 2 +
         32 * 128 * sizeof(float) + 1024;
}

// grid: min(work items, SMs); block: kThreads. Work item w is key tile
// w % n_ktiles of head w / n_ktiles; head = b * H + h.
template <int KS>
__global__ void __launch_bounds__(kThreads, 1)
attn_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const __grid_constant__ CUtensorMap tm_g,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv, int T, int H, int D,
                     int n_ktiles, int n_work, float scale) {
  using W = Width<KS>;
  constexpr int NC = W::NC;
  constexpr int kStages = kKVStages;
  constexpr int kRes = kResident<KS>;
  constexpr uint32_t kChunk = 64 * kRowBytes;        // every tile here has 64 rows
  constexpr uint32_t kTile = NC * kChunk;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * kRes + 2 * kStages];

  const uint32_t k_s = (smem_u32(smem_raw) + 1023u) & ~1023u;  // buffer r: + r * 2 kTile
  const uint32_t st_s = k_s + kRes * 2 * kTile;      // stage s: Q then g
  float* px = reinterpret_cast<float*>(
      smem_raw + (st_s + kStages * 2 * kTile - smem_u32(smem_raw)));
  const uint32_t kv_full = smem_u32(&bars[0]);       // + 8 * buffer
  const uint32_t kv_empty = smem_u32(&bars[kRes]);
  const uint32_t qg_full = smem_u32(&bars[2 * kRes]);  // + 8 * stage
  const uint32_t qg_empty = smem_u32(&bars[2 * kRes + kStages]);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_tiles = (T + kKV_BQ - 1) / kKV_BQ;

  if (threadIdx.x == 0) {
    for (int r = 0; r < kRes; ++r) {
      mbar_init(kv_full + 8 * r, 1);
      mbar_init(kv_empty + 8 * r, 8);
    }
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
        const int hh = head % H, b = head / H;
        const int r = item % kRes;
        mbar_wait(kv_empty + 8 * r, ((item / kRes) & 1) ^ 1);
        mbar_expect_tx(kv_full + 8 * r, 2 * kTile);
        tma_load_tile<NC>(k_s + r * 2 * kTile, &tm_k, kv_full + 8 * r, kKV_BK, k0, hh, b);
        tma_load_tile<NC>(k_s + r * 2 * kTile + kTile, &tm_v, kv_full + 8 * r, kKV_BK, k0,
                          hh, b);
        for (int j = 0; j < n_tiles; ++j, ++it) {
          const uint32_t s = it % kStages;
          mbar_wait(qg_empty + 8 * s, ((it / kStages) & 1) ^ 1);
          const uint32_t q_s = st_s + s * 2 * kTile;
          mbar_expect_tx(qg_full + 8 * s, 2 * kTile);
          tma_load_tile<NC>(q_s, &tm_q, qg_full + 8 * s, kKV_BQ, j * kKV_BQ, hh, b);
          tma_load_tile<NC>(q_s + kTile, &tm_g, qg_full + 8 * s, kKV_BQ, j * kKV_BQ, hh, b);
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
      // the resident operand: K for warpgroup A, V for warpgroup B
      const int r = item % kRes;
      const uint64_t a_desc = mma_desc(k_s + r * 2 * kTile + (wg == 0 ? 0 : kTile));

      float acc[NC][32];                             // dV (A) or dK (B)
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;

      mbar_wait(kv_full + 8 * r, (item / kRes) & 1);

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

        // S^T = K Q^T (A) or dP^T = V g^T (B): 64 keys x 64 query rows, over
        // the KS steps that hold columns below D
        float t[32];
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          const uint32_t off = (ks / 4 * kChunk + ks % 4 * kStepKMajor) >> 4;
          wgmma_ss_n64(t, a_desc + off, b1_desc + off, ks != 0);
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
        if (j == n_tiles - 1 && lane == 0) mbar_arrive(kv_empty + 8 * r);

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
        reg_fence_acc<KS>(acc);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          wgmma_rs_acc<KS>(acc, ta[ks], b2_desc, kChunk, ks * kStepMNMajor);
        wgmma_commit();
        wgmma_wait<0>();
        reg_fence_acc<KS>(acc);
        if (lane == 0) mbar_arrive(qg_empty + 8 * s);
      }

      __nv_bfloat16* dst = (wg == 0 ? dv : dk) + static_cast<size_t>(head) * T * D;
      store_acc<NC, W::kLast>(dst, acc, key0, T, D, D, tq, 1.f, 1.f);
    }
  }
}

template <int KS>
constexpr size_t dq_smem_bytes() {
  // buffers of (Q, g), kStages of (K tile, V tile), alignment room
  return static_cast<size_t>(kResident<KS> * 2 * kQ_BQ +
                             kDqRing<KS> * 2 * kQ_BK) * Width<KS>::kCols * 2 +
         1024;
}

// grid: min(work items, SMs); block: kThreads. Work item w is q tile
// w % n_qtiles of head w / n_qtiles; head = b * H + h.
template <int KS>
__global__ void __launch_bounds__(kThreads, 1)
attn_bwd_dq_kernel(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   const __grid_constant__ CUtensorMap tm_g,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta,
                   __nv_bfloat16* __restrict__ dq, int T, int H, int D,
                   int n_qtiles, int n_work, float scale) {
  using W = Width<KS>;
  constexpr int NC = W::NC;
  constexpr int kStages = kDqRing<KS>;
  constexpr int kRes = kResident<KS>;
  constexpr uint32_t kQChunk = kQ_BQ * kRowBytes;
  constexpr uint32_t kKVChunk = kQ_BK * kRowBytes;
  constexpr uint32_t kQBytes = NC * kQChunk;
  constexpr uint32_t kKVBytes = NC * kKVChunk;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * kRes + 2 * kStages];

  const uint32_t q_s = (smem_u32(smem_raw) + 1023u) & ~1023u;  // buffer r: + r * 2 kQBytes
  const uint32_t st_s = q_s + kRes * 2 * kQBytes;    // stage s: K then V
  const uint32_t qg_full = smem_u32(&bars[0]);       // + 8 * buffer
  const uint32_t qg_empty = smem_u32(&bars[kRes]);
  const uint32_t kv_full = smem_u32(&bars[2 * kRes]);  // + 8 * stage
  const uint32_t kv_empty = smem_u32(&bars[2 * kRes + kStages]);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_tiles = (T + kQ_BK - 1) / kQ_BK;

  if (threadIdx.x == 0) {
    for (int r = 0; r < kRes; ++r) {
      mbar_init(qg_full + 8 * r, 1);
      mbar_init(qg_empty + 8 * r, 8);
    }
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
        const int hh = head % H, b = head / H;
        for (int j = 0; j < n_tiles; ++j, ++it) {
          const uint32_t s = it % kStages;
          mbar_wait(kv_empty + 8 * s, ((it / kStages) & 1) ^ 1);
          const uint32_t k_s = st_s + s * 2 * kKVBytes;
          mbar_expect_tx(kv_full + 8 * s, 2 * kKVBytes);
          tma_load_tile<NC>(k_s, &tm_k, kv_full + 8 * s, kQ_BK, j * kQ_BK, hh, b);
          tma_load_tile<NC>(k_s + kKVBytes, &tm_v, kv_full + 8 * s, kQ_BK, j * kQ_BK, hh, b);
          if (j == 0) {
            // after the first K/V tile, which needs no free Q/g buffer
            const int r = item % kRes;
            const uint32_t qr = q_s + r * 2 * kQBytes;
            mbar_wait(qg_empty + 8 * r, ((item / kRes) & 1) ^ 1);
            mbar_expect_tx(qg_full + 8 * r, 2 * kQBytes);
            tma_load_tile<NC>(qr, &tm_q, qg_full + 8 * r, kQ_BQ, q0, hh, b);
            tma_load_tile<NC>(qr + kQBytes, &tm_g, qg_full + 8 * r, kQ_BQ, q0, hh, b);
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
      const int r = item % kRes;
      const uint64_t q_desc = mma_desc(q_s + r * 2 * kQBytes + wg * 64 * kRowBytes);
      const uint64_t g_desc = mma_desc(q_s + r * 2 * kQBytes + kQBytes + wg * 64 * kRowBytes);

      float acc[NC][32];
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;

      mbar_wait(qg_full + 8 * r, (item / kRes) & 1);

      for (int j = 0; j < n_tiles; ++j, ++it) {
        const uint32_t s = it % kStages;
        const int k0 = j * kQ_BK;
        const uint64_t k_desc = mma_desc(st_s + s * 2 * kKVBytes);
        const uint64_t v_desc = mma_desc(st_s + s * 2 * kKVBytes + kKVBytes);
        mbar_wait(kv_full + 8 * s, (it / kStages) & 1);

        // S = Q K^T and dP = g V^T for 64 rows x 32 keys, over the KS steps
        // that hold columns below D
        float sc[16], dp[16];
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < KS; ++ks)
          wgmma_ss_n32(sc, q_desc + ((ks / 4 * kQChunk + ks % 4 * kStepKMajor) >> 4),
                       k_desc + ((ks / 4 * kKVChunk + ks % 4 * kStepKMajor) >> 4),
                       ks != 0);
#pragma unroll
        for (int ks = 0; ks < KS; ++ks)
          wgmma_ss_n32(dp, g_desc + ((ks / 4 * kQChunk + ks % 4 * kStepKMajor) >> 4),
                       v_desc + ((ks / 4 * kKVChunk + ks % 4 * kStepKMajor) >> 4),
                       ks != 0);
        wgmma_commit();
        wgmma_wait<0>();
        reg_fence(sc);
        reg_fence(dp);
        // Q and g have been read for the last time: the next item's may come
        if (j == n_tiles - 1 && lane == 0) mbar_arrive(qg_empty + 8 * r);

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
        reg_fence_acc<KS>(acc);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < 2; ++ks)
          wgmma_rs_acc<KS>(acc, da[ks], k_desc, kKVChunk, ks * kStepMNMajor);
        wgmma_commit();
        wgmma_wait<0>();
        reg_fence_acc<KS>(acc);
        if (lane == 0) mbar_arrive(kv_empty + 8 * s);
      }

      store_acc<NC, W::kLast>(dq + static_cast<size_t>(head) * T * D, acc, row0, T, D,
                              D, tq, 1.f, 1.f);
    }
  }
}

template <int KS>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* g, const void* lse, void* delta, void* dq, void* dk,
           void* dv, int B, int H, int T, int D, const Strides* st, float scale,
           cudaStream_t stream) {
  constexpr size_t kv_smem = kv_smem_bytes<KS>();
  constexpr size_t dq_smem = dq_smem_bytes<KS>();
  // at every call, not once: with the attribute set by an earlier call only, a
  // launch from autograd's thread after launches from the main thread was
  // refused (cudaErrorInvalidValue) on the card; setting it is cheap
  cudaError_t err = cudaFuncSetAttribute(
      attn_bwd_dkdv_kernel<KS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kv_smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(
      attn_bwd_dq_kernel<KS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(dq_smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int sms = 0;
  err = sm_count(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  // built at every call, since the pointers change; passed by value, so a
  // CUDA graph captures them with the launches. st: q, k, v, o, g.
  CUtensorMap q64, k64, v64, g64, q128, k32, v32, g128;
  if (!make_tile_map(&q64, q, B, H, T, D, st[0], kKV_BQ) ||
      !make_tile_map(&k64, k, B, H, T, D, st[1], kKV_BK) ||
      !make_tile_map(&v64, v, B, H, T, D, st[2], kKV_BK) ||
      !make_tile_map(&g64, g, B, H, T, D, st[4], kKV_BQ) ||
      !make_tile_map(&q128, q, B, H, T, D, st[0], kQ_BQ) ||
      !make_tile_map(&k32, k, B, H, T, D, st[1], kQ_BK) ||
      !make_tile_map(&v32, v, B, H, T, D, st[2], kQ_BK) ||
      !make_tile_map(&g128, g, B, H, T, D, st[4], kQ_BQ))
    return kTensorMapFailed;
  using bf = __nv_bfloat16;
  const float* lp = static_cast<const float*>(lse);
  float* dp = static_cast<float*>(delta);
  const int BH = B * H, rows = BH * T;
  const int lr = D <= 128 ? 8 : 32;
  const int groups = (rows + kDeltaWarps * (32 / lr) - 1) / (kDeltaWarps * (32 / lr));
  const int delta_grid = groups < kDeltaBlocksPerSM * sms ? groups : kDeltaBlocksPerSM * sms;
  const bf *ob = static_cast<const bf*>(o), *gb = static_cast<const bf*>(g);
  if (lr == 8)
    attn_bwd_delta_kernel<8><<<delta_grid, kDeltaWarps * 32, 0, stream>>>(
        ob, st[3], gb, st[4], dp, rows, T, H, D);
  else
    attn_bwd_delta_kernel<32><<<delta_grid, kDeltaWarps * 32, 0, stream>>>(
        ob, st[3], gb, st[4], dp, rows, T, H, D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_ktiles = (T + kKV_BK - 1) / kKV_BK, kv_work = BH * n_ktiles;
  attn_bwd_dkdv_kernel<KS><<<kv_work < sms ? kv_work : sms, kThreads, kv_smem, stream>>>(
      q64, k64, v64, g64, lp, dp, static_cast<bf*>(dk), static_cast<bf*>(dv), T, H, D,
      n_ktiles, kv_work, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_qtiles = (T + kQ_BQ - 1) / kQ_BQ, q_work = BH * n_qtiles;
  attn_bwd_dq_kernel<KS><<<q_work < sms ? q_work : sms, kThreads, dq_smem, stream>>>(
      q128, k32, v32, g128, lp, dp, static_cast<bf*>(dq), T, H, D, n_qtiles, q_work,
      scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, o, g: bf16 (B, H, T, D), D a multiple of 8 up to 256, each with a
// contiguous last dimension, its other strides in `strides` (elements: over
// T, over H, over B; q's, k's, v's, o's, then g's), every stride a multiple
// of 8 and every pointer 16-byte aligned (the caller checks; widths that are
// not a multiple of 8 are zero-padded by the caller, which passes the true
// scale). dq, dk, dv: contiguous (B, H, T, D) bf16. lse: the forward's fp32
// (B*H, T) natural log-sum-exp; delta: fp32 (B*H, T) scratch. Launches three
// kernels on the stream and returns the first launch error, or
// cudaGetLastError() after the last launch; -1 if a tensor map could not be
// encoded.
extern "C" int uurg_attention_bwd(const void* q, const void* k, const void* v,
                                  const void* o, const void* g, const void* lse,
                                  void* delta, void* dq, void* dk, void* dv,
                                  int B, int H, int T, int D,
                                  const long long* strides, float scale,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D < 8 || D > 256 || D % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  Strides st[5];
  for (int i = 0; i < 5; ++i)
    st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
#define UURG_BWD(ks)                                                            \
  case ks:                                                                      \
    return launch<ks>(q, k, v, o, g, lse, delta, dq, dk, dv, B, H, T, D, st, scale, s);
  switch ((D + 15) / 16) {
    UURG_BWD(1) UURG_BWD(2) UURG_BWD(3) UURG_BWD(4) UURG_BWD(5) UURG_BWD(6)
    UURG_BWD(7) UURG_BWD(8) UURG_BWD(9) UURG_BWD(10) UURG_BWD(11) UURG_BWD(12)
    UURG_BWD(13) UURG_BWD(14) UURG_BWD(15) UURG_BWD(16)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef UURG_BWD
}
