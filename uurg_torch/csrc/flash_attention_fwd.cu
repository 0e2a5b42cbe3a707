// Attention forward: o = softmax(q k^T * scale) v on (B, H, T, D) bf16, each
// of q, k, v and o in any layout whose last dimension is contiguous.
//
// Replaces: uurg_tpu/ops/flash_attention.py::_attn_kernel (launched by
// _fused_attention_fwd_impl). Scores, softmax and both accumulations are fp32;
// the probabilities are rounded to bf16 before the PV product, as the TPU
// kernel casts p to v's dtype. The T x T score matrix never leaves the SM.
//
// Bound: bytes on the sampling path. A head does 4 * T * T * D flops on
// 8 * T * D bytes (q, k, v read, o written): T / 2 = 128 flops a byte at
// T = 256 and 8 at the T = 16 mid site, both under the H100's 295 bf16 flops
// a byte. Only T >= ~600 (DiT, SD) would be bound by the tensor cores. So the
// kernel has to keep loads in flight while it computes, and must not spend
// its issue slots and shared-memory bandwidth on feeding the tensor cores.
//
// Design (warp-specialised, TMA + wgmma):
// - A work item is 128 query rows of one head: two consumer warpgroups of 64
//   rows each, and a producer warp. The producer's registers go to the
//   consumers (setmaxnreg), which hold a 64 x D fp32 output (D / 2 registers
//   a thread) plus a 64 x 64 score tile.
// - The producer loads the q tile once and then K and V in 64-key tiles
//   through a two-stage ring: TMA boxes in the 128-byte swizzle, completion
//   counted on an mbarrier a stage ("full"), the consumers hand a stage back
//   on a second mbarrier ("empty"). Loads of tile j + 1 run under the
//   products of tile j. The tensor maps have three dimensions (B*H, T, D), so
//   rows past T arrive as zeros and never as the next head's rows.
// - Blocks are persistent: one on each SM (192 KB of shared memory at
//   D = 256 leave room for no second), walking work items blockIdx.x,
//   + gridDim.x, ... The K/V ring runs on across work items and the q tile
//   is handed back as soon as its last score product is done, so the next
//   item's loads run under this item's last products and its output store
//   (on the card this gained 2% over one block an item). Neighbouring blocks
//   take the two q tiles of one head at the same time, so its K and V come
//   from L2 for one of them.
// - Every product is a wgmma, bf16 in and fp32 accumulate. S = Q K^T reads
//   both operands from shared memory (K-major). The online softmax runs on
//   the score accumulator in registers, and its bf16 rounding is at once the
//   A operand of O += P V. V is used as it lies in memory: the MN-major
//   operand form takes the keys as the contraction, so there is no
//   transposed copy. O is kept as ceil(D / 64) accumulators of 64 x 64, each fed by
//   a 64-column instruction (one 256-column instruction gave the same bits
//   and the same time on the card, and would need a form of its own for
//   every D).
// - The output leaves the registers as 16-byte stores after the four lanes of
//   a quad have swapped their column pairs (hopper_mma.cuh, store_acc).
// - Keys past T are masked to -inf; rows past T are computed on zeros and not
//   stored.
//
// Head widths and layouts. The kernel reads q, k and v where they lie and at
// their true width D (a multiple of 8): the tensor maps have four dimensions
// (D, T, H, B) with the tensor's own strides, so a (B, H, T, D) view of a
// fused (B, T, 3, H, D) projection is read as it is, and the box that runs
// past column D of a head (D = 72: columns 72-127 of the second chunk's box)
// is zero-filled by TMA, never read from the neighbouring head. The template
// argument KS = ceil(D / 16) is the number of 16-deep contraction steps of
// S = Q K^T (5 at D = 72, not the 8 of the padded 128), and the shared-memory
// tiles are ceil(D / 64) chunks wide. O += P V runs one n64 instruction a
// whole chunk and a narrower one (n16, n32 or n48) over the last chunk's
// columns below 16 KS (D = 72: n64 + n16, not 2 x n64), and only columns
// below D are stored, at the output's own row and head strides: a
// token-major (B, T, H, D) buffer, so that the caller's merge of the heads
// is a view, or a contiguous (B, H, T, D) one.
//
// Issuing tile j + 1's score product before tile j's softmax, so that the
// tensor cores run it under the softmax (as FlashAttention-3 does), was
// tried at D <= 128: ptxas serialised the wgmmas (C7514: the rescale of O
// reads its accumulator inside the pipeline stage) and the forward at
// (32, 16, 256, 72) took 0.0545 ms against 0.0467 without.
//
// When a gradient is wanted the caller passes an lse buffer: the kernel then
// also writes each row's natural log-sum-exp of the scaled scores, fp32
// (B*H, T), from which the backward kernels rebuild P tile by tile. The
// sampling path passes none and runs the same instructions as without it.
#include <math.h>

#include "hopper_mma.cuh"

namespace {

using namespace hopper;

constexpr int kBQ = 128;          // query rows per block (two consumer warpgroups)
constexpr int kBK = 64;           // keys per tile
constexpr int kConsumers = 2;     // warpgroups
constexpr int kThreads = (kConsumers + 1) * 128;

// stages of the K/V ring: four at narrow widths (more loads in flight for
// the few products a tile of a narrow head gives: 0.0541 -> 0.0520 ms at
// (32, 16, 256, 72) on contiguous inputs; scripts/profile_torch_attention.py
// in turns, NVIDIA H100 80GB HBM3, 700 W), two at 192 and 256 columns
// (shared memory)
template <int KS>
constexpr int kRing = Width<KS>::kNarrow ? 4 : 2;

template <int KS>
constexpr size_t smem_bytes() {
  // q tile, kStages of (K tile, V tile), room to align to 1024 bytes
  return static_cast<size_t>(kBQ + kRing<KS> * 2 * kBK) * Width<KS>::kCols * 2 + 1024;
}

// grid: min(work items, SMs); block: kThreads. Work item w is q tile
// w % n_qtiles of head w / n_qtiles; head = b * H + h.
template <int KS>
__global__ void __launch_bounds__(kThreads, 1)
attn_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v,
                __nv_bfloat16* __restrict__ o, const Strides os,
                float* __restrict__ lse, int T, int H, int D, int n_qtiles,
                int n_work, float scale_log2) {
  using W = Width<KS>;
  constexpr int NC = W::NC;                          // 64-column chunks
  constexpr int kStages = kRing<KS>;
  constexpr uint32_t kQChunk = kBQ * kRowBytes;      // bytes of a q chunk
  constexpr uint32_t kKVChunk = kBK * kRowBytes;
  constexpr uint32_t kQBytes = NC * kQChunk;
  constexpr uint32_t kKVBytes = NC * kKVChunk;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 + 2 * kStages];

  const uint32_t q_s = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t kv_s = q_s + kQBytes;               // stage s: K then V
  const uint32_t q_full = smem_u32(&bars[0]);
  const uint32_t q_empty = smem_u32(&bars[1]);
  const uint32_t kv_full = smem_u32(&bars[2]);       // + 8 * stage
  const uint32_t kv_empty = smem_u32(&bars[2 + kStages]);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_tiles = (T + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, kConsumers * 4);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(kv_full + 8 * s, 1);
      mbar_init(kv_empty + 8 * s, kConsumers * 4);   // one arrival a warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= kConsumers * 4) {
    // ------------------------------------------------------------ producer
    reg_dealloc<40>();
    if (warp == kConsumers * 4 && lane == 0) {
      uint32_t it = 0;                               // K/V tiles loaded so far
      for (int w = blockIdx.x, item = 0; w < n_work; w += gridDim.x, ++item) {
        const int head = w / n_qtiles, q0 = (w % n_qtiles) * kBQ;
        const int hh = head % H, b = head / H;
        for (int j = 0; j < n_tiles; ++j, ++it) {
          const uint32_t s = it % kStages;
          mbar_wait(kv_empty + 8 * s, ((it / kStages) & 1) ^ 1);
          const uint32_t k_s = kv_s + s * 2 * kKVBytes;
          mbar_expect_tx(kv_full + 8 * s, 2 * kKVBytes);
          tma_load_tile<NC>(k_s, &tm_k, kv_full + 8 * s, kBK, j * kBK, hh, b);
          tma_load_tile<NC>(k_s + kKVBytes, &tm_v, kv_full + 8 * s, kBK, j * kBK, hh, b);
          if (j == 0) {
            // after the first K/V tile, which needs no free q buffer
            mbar_wait(q_empty, (item & 1) ^ 1);
            mbar_expect_tx(q_full, kQBytes);
            tma_load_tile<NC>(q_s, &tm_q, q_full, kBQ, q0, hh, b);
          }
        }
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    reg_alloc<232>();
    const int wg = warp >> 2;                        // 0 or 1: which 64 rows
    const int g = lane >> 2, tq = lane & 3;          // accumulator row / column pair
    const uint64_t q_desc = mma_desc(q_s + wg * 64 * kRowBytes);
    uint32_t it = 0;                                 // K/V tiles consumed so far

    for (int w = blockIdx.x, item = 0; w < n_work; w += gridDim.x, ++item) {
      const int head = w / n_qtiles, q0 = (w % n_qtiles) * kBQ;
      const int row0 = q0 + wg * 64 + (warp & 3) * 16 + g, row1 = row0 + 8;

      float acc[NC][32];
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;
      float m_run[2] = {-INFINITY, -INFINITY};         // rows row0 and row1
      float l_run[2] = {0.f, 0.f};                     // this thread's share of the sums

      mbar_wait(q_full, item & 1);

      for (int j = 0; j < n_tiles; ++j, ++it) {
        const uint32_t s = it % kStages;
        const uint32_t k_s = kv_s + s * 2 * kKVBytes;
        const uint64_t k_desc = mma_desc(k_s);
        const uint64_t v_desc = mma_desc(k_s + kKVBytes);
        mbar_wait(kv_full + 8 * s, (it / kStages) & 1);

        // S = Q K^T for this warpgroup's 64 rows and the tile's 64 keys, over
        // the KS steps that hold columns below D
        float sc[32];
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < KS; ++ks)
          wgmma_ss_n64(sc, q_desc + ((ks / 4 * kQChunk + ks % 4 * kStepKMajor) >> 4),
                       k_desc + ((ks / 4 * kKVChunk + ks % 4 * kStepKMajor) >> 4),
                       ks != 0);
        wgmma_commit();
        wgmma_wait<0>();
        reg_fence(sc);
        // the q tile has been read for the last time: the next item's may come
        if (j == n_tiles - 1 && lane == 0) mbar_arrive(q_empty);

        // online softmax in the log2 domain
        const int k0 = j * kBK;
        const bool ragged = k0 + kBK > T;
        float mx[2] = {-INFINITY, -INFINITY};
        if (ragged) {
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            const int key = k0 + (i >> 2) * 8 + tq * 2 + (i & 1);
            sc[i] = key < T ? sc[i] * scale_log2 : -INFINITY;
          }
        } else {
#pragma unroll
          for (int i = 0; i < 32; ++i) sc[i] *= scale_log2;
        }
#pragma unroll
        for (int i = 0; i < 32; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
        float alpha[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          // key k0 is always valid, so m_new is finite; alpha is 0 on the first tile
          const float m_new = fmaxf(m_run[r], mx[r]);
          alpha[r] = ex2(m_run[r] - m_new);
          m_run[r] = m_new;
        }
        float rs[2] = {0.f, 0.f};
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const float p = ex2(sc[i] - m_run[(i >> 1) & 1]);
          sc[i] = p;
          rs[(i >> 1) & 1] += p;
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + rs[r];
#pragma unroll
        for (int c = 0; c < NC; ++c)
#pragma unroll
          for (int i = 0; i < W::live(c); ++i) acc[c][i] *= alpha[(i >> 1) & 1];

        // O += P V: the rounded scores are the A operand, V's rows the contraction
        uint32_t pa[4][4];
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) acc_to_a(pa[ks], sc + 8 * ks);
        reg_fence_acc<KS>(acc);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          wgmma_rs_acc<KS>(acc, pa[ks], v_desc, kKVChunk, ks * kStepMNMajor);
        wgmma_commit();
        wgmma_wait<0>();
        reg_fence_acc<KS>(acc);
        if (lane == 0) mbar_arrive(kv_empty + 8 * s);
      }

      float inv[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
        l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
        inv[r] = 1.f / l_run[r];
      }
      if (lse != nullptr && tq == 0) {
        // log2-domain max plus log2 of the sum, back to the natural log
        float* lh = lse + static_cast<size_t>(head) * T;
        if (row0 < T) lh[row0] = (m_run[0] + log2f(l_run[0])) * 0.6931471805599453f;
        if (row1 < T) lh[row1] = (m_run[1] + log2f(l_run[1])) * 0.6931471805599453f;
      }
      store_acc<NC, W::kLast>(o + (head / H) * os.b + (head % H) * os.h, acc, row0, T,
                    os.t, D, tq, inv[0], inv[1]);
    }
  }
}

template <int KS>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int H, int T, int D, const Strides* st, float scale,
           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<KS>();
  // at every call, not once: with the attribute set by an earlier call only, a
  // launch from autograd's thread after launches from the main thread was
  // refused (cudaErrorInvalidValue) on the card; setting it is cheap
  cudaError_t err = cudaFuncSetAttribute(
      attn_fwd_kernel<KS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int sms = 0;
  err = sm_count(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  // built at every call, since the pointers change; passed by value, so a
  // CUDA graph captures them with the launch
  CUtensorMap tm_q, tm_k, tm_v;
  if (!make_tile_map(&tm_q, q, B, H, T, D, st[0], kBQ) ||
      !make_tile_map(&tm_k, k, B, H, T, D, st[1], kBK) ||
      !make_tile_map(&tm_v, v, B, H, T, D, st[2], kBK))
    return kTensorMapFailed;
  const int n_qtiles = (T + kBQ - 1) / kBQ;
  const int n_work = B * H * n_qtiles;
  attn_fwd_kernel<KS><<<n_work < sms ? n_work : sms, kThreads, smem, stream>>>(
      tm_q, tm_k, tm_v, static_cast<__nv_bfloat16*>(o), st[3], lse, T, H, D,
      n_qtiles, n_work, scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, o: bf16 (B, H, T, D), D a multiple of 8 up to 256, each with a
// contiguous last dimension, its other strides in `strides` (elements: over
// T, over H, over B; q's, k's, v's, then o's), every stride a multiple of 8
// and every pointer 16-byte aligned (the caller checks; widths that are not
// a multiple of 8 are zero-padded by the caller, which passes the true
// scale). lse: fp32 contiguous (B*H, T), or null when no gradient is wanted.
// Returns cudaGetLastError() after the launch; -1 if a tensor map could not be
// encoded.
extern "C" int uurg_attention_fwd(const void* q, const void* k, const void* v,
                                  void* o, void* lse, int B, int H, int T,
                                  int D, const long long* strides, float scale,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (D < 8 || D > 256 || D % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  Strides st[4];
  for (int i = 0; i < 4; ++i)
    st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
#define UURG_FWD(ks) \
  case ks: return launch<ks>(q, k, v, o, l, B, H, T, D, st, scale, s);
  switch ((D + 15) / 16) {
    UURG_FWD(1) UURG_FWD(2) UURG_FWD(3) UURG_FWD(4) UURG_FWD(5) UURG_FWD(6)
    UURG_FWD(7) UURG_FWD(8) UURG_FWD(9) UURG_FWD(10) UURG_FWD(11) UURG_FWD(12)
    UURG_FWD(13) UURG_FWD(14) UURG_FWD(15) UURG_FWD(16)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef UURG_FWD
}
