// The bfloat16 attention forward at padded head widths 320-512 (the xwide
// route): o = softmax(q k^T * scale) v on (B*H, T, D) bf16, D one of 320,
// 384, 448, 512, and when asked the natural log-sum-exp of each row.
//
// Replaces uurg_tpu/ops/flash_attention.py::_attn_kernel (launched by
// _fused_attention_fwd_impl) at the widths attention() pads to 320-512 in
// bfloat16: the CondUNet's one head of width 512 at model.ch 256 (16 x 16
// sites and the 4 x 4 mid site, T = 256 and 16). flash_attention_fwd.cu
// stops at width 256: its consumer warpgroup holds a 64 x D fp32 output,
// D / 2 registers a thread. flash_attention_f32.cu holds the float32 xwide
// forward, flash_attention_xwide_bwd.cu the backward in both dtypes.
//
// Arithmetic (flash_attention_fwd.cu's): scores in fp32 from bf16 products,
// scaled by scale * log2 e; an online softmax over key tiles in base 2,
// keys past T masked to -inf; P rounded to bf16 unnormalised before P V, the
// row sums taken from the unrounded P; O in fp32, divided by the row sum
// and stored once as bf16; the log-sum-exp in fp32. No atomics: a launch
// repeats its bits.
//
// Bound: bytes. A head does 4 T^2 D flops on 8 T D bytes (q, k, v read, o
// written once): T / 2 flops a byte, 128 at T = 256, under the card's 295
// bf16 flops a byte. But a work item of 64 query rows reads the whole K and
// V of its head, so at T = 256 the SMs take 4.5 times the bound's bytes out
// of L2 (Q once, K and V once for each of the head's four items), and
// every 64-key tile moves 384 KB through shared memory at D = 512: the TMA
// writes of K and V (128 KB), the score product's reads of Q and K (128 KB:
// Q is read again for every key tile), the exchange of partial scores
// (64 KB) and P V's reads of V (64 KB). On an NVIDIA H100 80GB HBM3 at
// 700 W, loading K and V costs 13% of the time (a variant that loads them
// for an item's first tile only); the rest is the products and what feeds
// them.
//
// Design (warp-specialised, TMA + wgmma on hopper_mma.cuh, as
// flash_attention_fwd.cu):
// - A work item is 64 query rows of one head. Blocks are persistent, one on
//   each SM (224 KB of shared memory at D = 512), walking items blockIdx.x,
//   + gridDim.x, ...; neighbouring blocks take the items of one head at
//   once, so its K and V come from L2 for all but one.
// - A producer warp loads the item's Q tile (64 rows x D, D / 64 boxes of
//   64 columns in the 128-byte swizzle) once and K and V in tiles of 64
//   keys, each tile on its own pair of mbarriers (full, empty). K tile j + 1
//   is loaded as soon as both consumers have formed tile j's scores, under
//   their softmax and P V; V tile j + 1 under the next scores. The ring runs
//   on across items, and Q is handed back after the item's last scores.
//   Tiles of 32 keys, two of each in flight, ran 15% longer: the score
//   product's n32 reads Q from shared memory twice as often a key.
// - Registers bound the output: 64 x 512 fp32 is 128 KB, half the register
//   file. So two consumer warpgroups share the item's 64 rows and split O's
//   columns: warpgroup 0 the first ceil(D / 128) chunks of 64, warpgroup 1
//   the rest (128 registers a thread at D = 512, the width of O that
//   flash_attention_fwd.cu holds at D = 256).
// - Both need the whole 64 x 64 score tile. Each sums it over its half of D
//   (wgmma, both operands from shared memory, fp32 accumulation) and the
//   two partial tiles meet in shared memory: a thread writes its partials
//   where the same thread of the other warpgroup, which holds the same rows
//   and keys, reads them (32 KB; named barrier 1: both written, 2: both
//   read before the next tile's are written). Both add s0 + s1 and run the
//   same softmax on the same bits, so the two halves of a row share one max
//   and one sum. Each warpgroup summing the whole tile itself needs no
//   exchange and no barrier but runs the score product twice (1.5 times
//   the necessary tensor-core work): 6% slower at both CondUNet shapes.
// - O += P V: the rounded P is the A operand in registers, V the MN-major
//   B operand as it lies (the keys are the contraction), one n64 wgmma a
//   chunk of the warpgroup's columns a 16-key step.
// - The output leaves the registers as 16-byte stores after a quad's lanes
//   swap their column pairs (store_acc); rows past T are computed on TMA's
//   zeros and not stored.
// The variants above: scripts/profile_torch_attention_xwide_variants.py
// --forward (keys32, whole_scores, kv_once), in turns.
//
// The tensor maps have the dimensions (D, T, 1, B*H) of the contiguous
// (B*H, T, D) tensors the wrapper hands over: rows past T arrive as zeros
// and never as the next head's rows, and heads index the map's last
// dimension, so more than 65,535 heads need no second launch.
#include <limits.h>
#include <math.h>

#include "hopper_mma.cuh"

namespace {

using namespace hopper;

constexpr int kBQ = 64;                  // query rows of a work item
constexpr int kBK = 64;                  // keys of a K or V tile
constexpr int kStages = 1;               // K tiles (and V tiles) in the ring
// each warpgroup sums the scores over half of D and the two halves meet in
// shared memory (false: each sums them over all of D, no exchange)
constexpr bool kSplitScores = true;
constexpr int kConsumers = 2;            // warpgroups
constexpr int kThreads = (kConsumers + 1) * 128;
constexpr int kArrivals = kConsumers * 4;   // one a consumer warp
constexpr size_t kSmemMax = 232448;      // shared memory a block can take
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <int D>
struct XTile {
  static_assert(D % 64 == 0 && D > 256 && D <= 512, "widths 320 to 512");
  static constexpr int NC = D / kChunkCols;          // 64-column chunks
  static constexpr int NO0 = (NC + 1) / 2;           // O chunks, warpgroup 0
  static constexpr uint32_t kQChunk = kBQ * kRowBytes;
  static constexpr uint32_t kKVChunk = kBK * kRowBytes;
  static constexpr uint32_t kQBytes = NC * kQChunk;
  static constexpr uint32_t kKVBytes = NC * kKVChunk;   // a K or a V tile
  // the two warpgroups' partial scores, fp32
  static constexpr uint32_t kXBytes =
      kSplitScores ? kConsumers * 128 * (kBK / 2) * 4 : 0;
  // Q, the K ring, the V ring, the partial scores, room to align to 1024
  // bytes
  static constexpr size_t kSmem =
      kQBytes + 2 * static_cast<size_t>(kStages) * kKVBytes + kXBytes + 1024;
  static_assert(kSmem <= kSmemMax, "the tiles fit one block's shared memory");
};

// the score tile's product over one 16-column step: n64 or n32 by its size
__device__ __forceinline__ void score_mma(float (&d)[32], uint64_t a,
                                          uint64_t b, int accumulate) {
  wgmma_ss_n64(d, a, b, accumulate);
}
__device__ __forceinline__ void score_mma(float (&d)[16], uint64_t a,
                                          uint64_t b, int accumulate) {
  wgmma_ss_n32(d, a, b, accumulate);
}

// the mbarriers of a block, as shared-memory addresses
struct Bars {
  uint32_t q_full, q_empty, k_full, k_empty, v_full, v_empty;   // + 8 a stage
};

// A consumer warpgroup: O columns 64 C0 .. 64 (C0 + NO) - 1 of every item
// this block takes; warpgroup 0 (C0 == 0) also writes the log-sum-exp.
template <int D, int NO, int C0>
__device__ __forceinline__ void consume(const Bars& b, uint32_t q_s,
                                        uint32_t k_s, uint32_t v_s,
                                        float4* xch,
                                        __nv_bfloat16* __restrict__ o,
                                        float* __restrict__ lse, int T,
                                        int n_qtiles, int n_work,
                                        float scale_log2) {
  using X = XTile<D>;
  constexpr int NS = kBK / 2;                        // score registers
  // the score product's 16-column steps this warpgroup sums
  constexpr int KS = 4 * X::NC;
  constexpr int KS0 = kSplitScores && C0 != 0 ? KS / 2 : 0;
  constexpr int KS1 = kSplitScores && C0 == 0 ? KS / 2 : KS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;            // accumulator row / column pair
  const int n_tiles = (T + kBK - 1) / kBK;
  const uint64_t q_desc = mma_desc(q_s);
  // the partial scores: this thread's, and the same thread's of the other
  // warpgroup, float4 i of NS / 4 at [i][thread]
  float4* mine = xch + (C0 == 0 ? 0 : NS / 4 * 128) + (threadIdx.x & 127);
  const float4* other = xch + (C0 == 0 ? NS / 4 * 128 : 0) + (threadIdx.x & 127);
  uint32_t it = 0;                                   // K/V tiles consumed so far

  for (int w = blockIdx.x, item = 0; w < n_work; w += gridDim.x, ++item) {
    const int head = w / n_qtiles, q0 = (w % n_qtiles) * kBQ;
    const int row0 = q0 + (warp & 3) * 16 + g;       // and row0 + 8

    float acc[NO][32];
#pragma unroll
    for (int c = 0; c < NO; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;
    float m_run[2] = {-INFINITY, -INFINITY};
    float l_run[2] = {0.f, 0.f};                     // this thread's share of the sums

    mbar_wait(b.q_full, item & 1);

    for (int j = 0; j < n_tiles; ++j, ++it) {
      const uint32_t s = it % kStages, parity = (it / kStages) & 1;
      const uint64_t k_desc = mma_desc(k_s + s * X::kKVBytes);
      const uint64_t v_desc = mma_desc(v_s + s * X::kKVBytes + C0 * X::kKVChunk);

      // S = Q K^T: the item's 64 rows and the tile's kBK keys over this
      // warpgroup's half of D
      mbar_wait(b.k_full + 8 * s, parity);
      float sc[NS];
      wgmma_fence();
#pragma unroll
      for (int ks = KS0; ks < KS1; ++ks)
        score_mma(sc, q_desc + ((ks / 4 * X::kQChunk + ks % 4 * kStepKMajor) >> 4),
                  k_desc + ((ks / 4 * X::kKVChunk + ks % 4 * kStepKMajor) >> 4),
                  ks != KS0);
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(sc);
      if (lane == 0) {
        mbar_arrive(b.k_empty + 8 * s);
        // the Q tile has been read for the last time: the next item's may come
        if (j == n_tiles - 1) mbar_arrive(b.q_empty);
      }
      if constexpr (kSplitScores) {
        // the halves meet; both add s0 + s1, so both hold the same bits.
        // Barrier 2: the other warpgroup has read the last tile's partials;
        // barrier 1: both have written this tile's
        if (it > 0) bar_sync(2, kConsumers * 128);
#pragma unroll
        for (int i = 0; i < NS / 4; ++i)
          mine[128 * i] = make_float4(sc[4 * i], sc[4 * i + 1], sc[4 * i + 2],
                                      sc[4 * i + 3]);
        bar_sync(1, kConsumers * 128);
#pragma unroll
        for (int i = 0; i < NS / 4; ++i) {
          const float4 x = other[128 * i];
          const float y[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
          for (int e = 0; e < 4; ++e)
            sc[4 * i + e] = C0 == 0 ? sc[4 * i + e] + y[e] : y[e] + sc[4 * i + e];
        }
      }

      // online softmax in base 2: d[4 i' + e] is row g + 8 (e / 2), key
      // 8 i' + 2 tq + (e % 2) of the tile
      const int k0 = j * kBK;
      if (k0 + kBK > T) {
#pragma unroll
        for (int i = 0; i < NS; ++i) {
          const int key = k0 + (i >> 2) * 8 + tq * 2 + (i & 1);
          sc[i] = key < T ? sc[i] * scale_log2 : -INFINITY;
        }
      } else {
#pragma unroll
        for (int i = 0; i < NS; ++i) sc[i] *= scale_log2;
      }
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < NS; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        // key k0 < T lies in every tile, so m_new is finite; alpha is 0 on
        // the first tile
        const float m_new = fmaxf(m_run[r], mx[r]);
        alpha[r] = ex2(m_run[r] - m_new);
        m_run[r] = m_new;
      }
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const float p = ex2(sc[i] - m_run[(i >> 1) & 1]);
        sc[i] = p;
        rs[(i >> 1) & 1] += p;
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + rs[r];
#pragma unroll
      for (int c = 0; c < NO; ++c)
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[c][i] *= alpha[(i >> 1) & 1];

      // O += P V over the warpgroup's chunks: P rounded to bf16 in place as
      // the A operand, V's rows the contraction
      uint32_t pa[kBK / 16][4];
#pragma unroll
      for (int ks = 0; ks < kBK / 16; ++ks) acc_to_a(pa[ks], sc + 8 * ks);
      mbar_wait(b.v_full + 8 * s, parity);
#pragma unroll
      for (int c = 0; c < NO; ++c) reg_fence(acc[c]);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kBK / 16; ++ks)
#pragma unroll
        for (int c = 0; c < NO; ++c)
          wgmma_rs_n64(acc[c], pa[ks],
                       v_desc + ((c * X::kKVChunk + ks * kStepMNMajor) >> 4));
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int c = 0; c < NO; ++c) reg_fence(acc[c]);
      if (lane == 0) mbar_arrive(b.v_empty + 8 * s);
    }

    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
      l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
      inv[r] = 1.f / l_run[r];
    }
    if (C0 == 0 && lse != nullptr && tq == 0) {
      float* lh = lse + static_cast<size_t>(head) * T;
      if (row0 < T) lh[row0] = (m_run[0] + log2f(l_run[0])) * kLn2;
      if (row0 + 8 < T) lh[row0 + 8] = (m_run[1] + log2f(l_run[1])) * kLn2;
    }
    store_acc<NO>(o + static_cast<size_t>(head) * T * D + C0 * kChunkCols, acc,
                  row0, T, D, D - C0 * kChunkCols, tq, inv[0], inv[1]);
  }
}

// grid: min(work items, SMs); block: kThreads. Work item w is query tile
// w % n_qtiles of head w / n_qtiles.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
attn_fwd_xwide_bf16(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                    int T, int n_qtiles, int n_work, float scale_log2) {
  using X = XTile<D>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 + 4 * kStages];

  const uint32_t q_s = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t k_s = q_s + X::kQBytes;             // stage s at + s kKVBytes
  const uint32_t v_s = k_s + kStages * X::kKVBytes;
  float4* xch = reinterpret_cast<float4*>(
      smem_raw + (v_s + kStages * X::kKVBytes - smem_u32(smem_raw)));
  Bars b;
  b.q_full = smem_u32(&bars[0]);
  b.q_empty = smem_u32(&bars[1]);
  b.k_full = smem_u32(&bars[2]);
  b.k_empty = smem_u32(&bars[2 + kStages]);
  b.v_full = smem_u32(&bars[2 + 2 * kStages]);
  b.v_empty = smem_u32(&bars[2 + 3 * kStages]);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    mbar_init(b.q_full, 1);
    mbar_init(b.q_empty, kArrivals);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(b.k_full + 8 * s, 1);
      mbar_init(b.k_empty + 8 * s, kArrivals);
      mbar_init(b.v_full + 8 * s, 1);
      mbar_init(b.v_empty + 8 * s, kArrivals);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= kConsumers * 4) {
    // ------------------------------------------------------------ producer
    reg_dealloc<40>();
    if (warp == kConsumers * 4 && lane == 0) {
      const int n_tiles = (T + kBK - 1) / kBK;
      uint32_t it = 0;                               // K/V tiles loaded so far
      for (int w = blockIdx.x, item = 0; w < n_work; w += gridDim.x, ++item) {
        const int head = w / n_qtiles, q0 = (w % n_qtiles) * kBQ;
        for (int j = 0; j < n_tiles; ++j, ++it) {
          const uint32_t s = it % kStages, parity = ((it / kStages) & 1) ^ 1;
          mbar_wait(b.k_empty + 8 * s, parity);
          mbar_expect_tx(b.k_full + 8 * s, X::kKVBytes);
          tma_load_tile<X::NC>(k_s + s * X::kKVBytes, &tm_k, b.k_full + 8 * s,
                               kBK, j * kBK, 0, head);
          if (j == 0) {
            // after the first K tile, which needs no free Q buffer
            mbar_wait(b.q_empty, (item & 1) ^ 1);
            mbar_expect_tx(b.q_full, X::kQBytes);
            tma_load_tile<X::NC>(q_s, &tm_q, b.q_full, kBQ, q0, 0, head);
          }
          mbar_wait(b.v_empty + 8 * s, parity);
          mbar_expect_tx(b.v_full + 8 * s, X::kKVBytes);
          tma_load_tile<X::NC>(v_s + s * X::kKVBytes, &tm_v, b.v_full + 8 * s,
                               kBK, j * kBK, 0, head);
        }
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    reg_alloc<232>();
    if (warp < 4)
      consume<D, X::NO0, 0>(b, q_s, k_s, v_s, xch, o, lse, T, n_qtiles,
                            n_work, scale_log2);
    else
      consume<D, X::NC - X::NO0, X::NO0>(b, q_s, k_s, v_s, xch, o, lse, T,
                                         n_qtiles, n_work, scale_log2);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int BH, int T, float scale, cudaStream_t stream) {
  using X = XTile<D>;
  // at every call, as flash_attention_fwd.cu sets it (a launch from
  // autograd's thread was refused when only another thread had set it)
  cudaError_t err = cudaFuncSetAttribute(
      attn_fwd_xwide_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(X::kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int sms = 0;
  err = sm_count(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_qtiles = (T + kBQ - 1) / kBQ;
  if (static_cast<long long>(BH) * n_qtiles > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_work = BH * n_qtiles;
  // contiguous (B*H, T, D): the maps' dimensions (D, T, 1, B*H)
  const Strides st{D, static_cast<long long>(T) * D, static_cast<long long>(T) * D};
  CUtensorMap tm_q, tm_k, tm_v;
  if (!make_tile_map(&tm_q, q, BH, 1, T, D, st, kBQ) ||
      !make_tile_map(&tm_k, k, BH, 1, T, D, st, kBK) ||
      !make_tile_map(&tm_v, v, BH, 1, T, D, st, kBK))
    return kTensorMapFailed;
  const int grid = n_work < sms ? n_work : sms;
  attn_fwd_xwide_bf16<D><<<grid, kThreads, X::kSmem, stream>>>(
      tm_q, tm_k, tm_v, static_cast<__nv_bfloat16*>(o), lse, T, n_qtiles,
      n_work, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, o: contiguous bf16 (BH, T, D), 16-byte aligned, D one of 320,
// 384, 448, 512 (the wrapper zero-pads other widths and passes the true
// scale); lse: fp32 (BH, T) or null. Returns the CUDA error code of the
// launch (0 on success), -1 if a tensor map could not be encoded.
extern "C" int uurg_attention_fwd_xwide_bf16(const void* q, const void* k,
                                             const void* v, void* o,
                                             void* lse, int BH, int T, int D,
                                             float scale, void* stream) {
  float* l = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (BH < 1 || T < 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (D) {
    case 320: return launch<320>(q, k, v, o, l, BH, T, scale, s);
    case 384: return launch<384>(q, k, v, o, l, BH, T, scale, s);
    case 448: return launch<448>(q, k, v, o, l, BH, T, scale, s);
    case 512: return launch<512>(q, k, v, o, l, BH, T, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
