// The attention backward at padded head widths 320-512 (the xwide route),
// float32 and bfloat16, on the tensor cores: dq, dk, dv of o = softmax(q
// k^T * scale) v on (B*H, T, D).
//
// Replaces uurg_tpu/ops/flash_attention.py::_attn_bwd_kernel (launched by
// _fused_attention_bwd_impl) at the widths attention() pads to 320, 384,
// 448 and 512: the VAE's one head of width 512 (float32) and the CondUNet's
// at model.ch 256 (bfloat16). The bfloat16 kernels of
// flash_attention_bwd.cu stop at width 256; flash_attention_f32.cu holds the
// other float32 routes and the xwide forward in both dtypes.
//
// Arithmetic (the Pallas kernel's): P = exp(s * scale - lse) from the
// forward's log-sum-exp, delta = rowsum(dO o) (for bf16 from the bf16
// forward output; the Pallas kernel sums P dP, equal in exact arithmetic),
// dS = P (dP - delta) * scale, dq = dS k, dk = dS^T q, dv = P^T dO with fp32
// sums. In bf16 P is rounded to bf16 before dV and dS before dK and dQ, and
// each gradient is stored once in the input dtype.
//
// Three launches, no atomics (a launch repeats its bits):
//   1. delta, a warp a row;
//   2. the key pass: a block owns 32 keys of a head (K and V resident in
//      shared memory) and walks the queries in tiles of 64. A tile takes
//      two sweeps over 64-column chunks of its Q and dO rows: the first
//      forms S^T = K Q^T and dP^T = V dO^T (32 x 64), then P^T and dS^T go
//      to shared memory and dS to a scratch (B*H, T, Tk) in the input dtype
//      (Tk = T rounded up to 32 keys; zeros at keys past T); the second
//      forms dV += P^T dO and dK += dS^T Q chunk by chunk;
//   3. the dq pass: a block owns 64 queries and walks the keys in tiles of
//      32: dq += dS K from the scratch. Five products a head where a pass
//      that recomputed S and dP for dq would take seven; the scratch is
//      T * Tk elements a head (128 MB at the VAE's (32, 1, 1024, 512) in
//      float32, 16 MB at the CondUNet's (128, 1, 256, 512) in bf16).
//
// Registers bound the tiles: at D = 512 a key block's fp32 dK and dV take
// 32 x 512 x 2 floats, 128 registers of each of the block's 256 threads
// (64 keys would take the whole register file), and a dq block's 64 x 512
// the same. The key pass's warps split by role: warps 0-3 form S^T and
// then dV, warps 4-7 dP^T and then dK, each over all 32 keys (two m-tiles)
// and, warp w, queries 16 (w % 4) .. + 15 of the tile and then columns
// 16 (w % 4) .. + 15 of every 64-column chunk (two m16n8 accumulators of
// each m-tile a chunk, 16 D / 64 floats in all). A warp thus multiplies one
// operand pair, and its A fragments serve two n-blocks and its B fragments
// two m-tiles: a quarter fewer fragment loads (and float32 splits) a
// product than warps that each took 16 keys of both pairs, which ran the
// key pass 10% (bf16) and 12% (float32) longer on an H100
// (scripts/profile_torch_attention_xwide.py --tree, in turns). The dP
// warps hand dP^T to the S warps through shared memory. Warp w of the dq
// pass owns queries 16 (w % 4) .. + 15 and columns (w / 4) D / 2 .. +
// D / 2 - 1 (D / 16 m16n8 accumulators). The accumulators of a key block's
// chunks are distinct registers, so the gradient sweep is unrolled over
// the chunks.
//
// Products: mma.sync. bfloat16 takes the bf16 operands as they are
// (m16n8k16, fp32 accumulation), fragments by ldmatrix (.trans where the
// product contracts over the rows of a tile: dO and Q in dV and dK, K in
// dq). float32 takes three TF32 products a product (m16n8k8, "3xTF32", as
// the xwide forward): x = hi + lo with hi = tf32(x) rounded to nearest, a b
// ~ a_lo b_hi + a_hi b_lo + a_hi b_hi. The tensor cores' own accumulation
// truncates, which biases long sums (the forward measured 3.2e-5 relative L2
// at T = 4096 when O was summed in them), so every float32 sum runs in the
// tensor cores over at most 64 of its terms (a 64-column chunk of S and dP,
// a 64-query tile of dK and dV, a 32-key tile of dq) in a fresh accumulator
// and is added to the running sum by rounding fp32 adds. float32 fragments
// are 8-byte loads with a lane's logical k = t, t + 4 at the physical
// columns 2 t, 2 t + 1 (A and B alike); where B contracts over rows it
// takes rows 2 t and 2 t + 1 by 4-byte loads. Row strides keep every
// fragment load free of bank conflicts: 8 elements of padding for 8-byte
// and ldmatrix reads, 4 for the float32 row-wise reads (so a float32 chunk
// lands at stride 72 for the scores and 68 for the gradients).
//
// Loads: the streamed operand (Q and dO chunks, the tile's lse and delta;
// dS and K tiles in the dq pass) runs through a ring of 2-4 stages in
// shared memory filled by cp.async 16-byte copies (rows past T as zeros),
// one block barrier a stage: a stage's copy is issued right after the
// barrier that frees its buffer, so the next stages land while this one is
// multiplied. Shared memory at D = 512, one block an SM: the key pass
// 225,792 bytes in float32 (two stages) and 159,232 in bf16 (four, and a
// float32 dP^T tile); the dq pass 228,864 (three) and 153,600 (four). The
// second read of Q and dO a tile costs the key pass 9% (float32) to 14%
// (bf16): scripts/profile_torch_attention_xwide_variants.py's one_stream.
//
// Bound: operations, 10 T^2 D flops a head in five products (8 T^2 D in
// the key pass, 2 T^2 D in the dq pass) on 28 T D bytes (fp32). float32's
// floor on this design is three TF32 products at 495 TFLOP/s, bf16's one
// bf16 product at 989.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kKeys = 32;                // keys of a key-pass block
constexpr int kQ = 64;                   // queries of a key-pass tile
constexpr int kC = 64;                   // columns of a chunk
constexpr int kDqRows = 64;              // queries of a dq-pass block
constexpr int kDqKeys = 32;              // keys of a dq-pass tile
constexpr int kMaxGridY = 65535;         // heads a launch: grid y's limit
constexpr size_t kSmem = 232448;         // shared memory a block can take
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;

template <typename In>
constexpr bool kIsBf16 = false;
template <>
constexpr bool kIsBf16<__nv_bfloat16> = true;

constexpr int stages(size_t fixed, size_t stage) {
  return (kSmem - fixed) / stage < 4 ? static_cast<int>((kSmem - fixed) / stage)
                                     : 4;
}

// tiles and shared memory of width D in dtype In; strides in elements
template <int D, typename In>
struct Tiles {
  static_assert(D % 64 == 0 && D > 256 && D <= 512, "widths 320 to 512");
  static constexpr bool BF16 = kIsBf16<In>;
  static constexpr int NC = D / kC;                  // chunks of a row
  static constexpr int LK = D + 8;                   // K, V (key pass)
  static constexpr int LC1 = kC + 8;                 // a chunk, scores
  static constexpr int LC2 = BF16 ? kC + 8 : kC + 4; // a chunk, gradients
  static constexpr int LP = kQ + 8;                  // P^T, dS^T
  static constexpr int LS = kDqKeys + 8;             // dS (dq pass)
  static constexpr int LKQ = BF16 ? D + 8 : D + 4;   // K (dq pass)
  // key pass: K, V, P^T, dS^T, (bf16: the float32 dP^T tile), the ring,
  // then lse and delta (float32)
  static constexpr int KP_STAGE = 2 * kQ * LC1;      // Q and dO chunks
  static constexpr size_t KP_FIXED =
      sizeof(In) * (2 * kKeys * LK + 2 * kKeys * LP) +
      sizeof(float) * ((BF16 ? kKeys * LP : 0) + 2 * kQ);
  static constexpr int KP_NST = stages(KP_FIXED, sizeof(In) * KP_STAGE);
  static constexpr size_t KP_BYTES =
      KP_FIXED + sizeof(In) * KP_NST * static_cast<size_t>(KP_STAGE);
  // dq pass: the ring of (dS tile, K tile)
  static constexpr int DQ_STAGE = kDqRows * LS + kDqKeys * LKQ;
  static constexpr int DQ_NST = stages(0, sizeof(In) * DQ_STAGE);
  static constexpr size_t DQ_BYTES = sizeof(In) * DQ_NST * static_cast<size_t>(DQ_STAGE);
  static_assert(KP_NST >= 2 && DQ_NST >= 2, "a ring of two stages at least");
  static_assert(KP_NST - 1 <= NC, "a tile's lse arrives after the last is read");
};

// -- copies and fragments --

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, or 16 zero bytes when !live
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool live) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(smem_u32(dst)), "l"(src), "r"(live ? 16 : 0)
               : "memory");
}

// 4 bytes, or a zero when !live
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool live) {
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

// x = hi + lo: hi = tf32(x) rounded to nearest, ties away from zero (the
// bits of cvt.rna.tf32.f32 for finite x, by an add and a mask: the float32
// backward ran 13% faster than with the conversion, scripts/
// profile_torch_attention_xwide_variants.py), lo = x - hi exactly (the
// tensor core reads its TF32 part)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// a B fragment's two values, split
__device__ __forceinline__ void split_b(float b0, float b1, uint32_t (&hi)[2],
                                        uint32_t (&lo)[2]) {
  split_tf32(b0, hi[0], lo[0]);
  split_tf32(b1, hi[1], lo[1]);
}

// c += a b in 3xTF32, the small terms first
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4],
                                     const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  mma_tf32(c, al, bh[0], bh[1]);
  mma_tf32(c, ah, bl[0], bl[1]);
  mma_tf32(c, ah, bh[0], bh[1]);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8 x 8 bf16 matrices; lanes 8 i .. 8 i + 7 give the row addresses of
// matrix i
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// a float32 A fragment, split, from the 8-byte pairs of rows g and g + 8
// (logical columns t in .x, t + 4 in .y)
__device__ __forceinline__ void split_a(const float* row, int ld,
                                        uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  const float2 x0 = ld2(row), x1 = ld2(row + 8 * ld);
  split_tf32(x0.x, hi[0], lo[0]);
  split_tf32(x1.x, hi[1], lo[1]);
  split_tf32(x0.y, hi[2], lo[2]);
  split_tf32(x1.y, hi[3], lo[3]);
}

// four consecutive elements at src (16-byte aligned float32 or 8-byte
// aligned bf16), as float32
template <typename In>
__device__ __forceinline__ float4 load4(const In* src) {
  if constexpr (kIsBf16<In>) {
    const uint2 raw = __ldg(reinterpret_cast<const uint2*>(src));
    return make_float4(__uint_as_float(raw.x << 16),
                       __uint_as_float(raw.x & 0xffff0000u),
                       __uint_as_float(raw.y << 16),
                       __uint_as_float(raw.y & 0xffff0000u));
  } else {
    return __ldg(reinterpret_cast<const float4*>(src));
  }
}

// two float32 values to dst in In (rounded to nearest for bf16)
template <typename In>
__device__ __forceinline__ void store2(In* dst, float a, float b) {
  if constexpr (kIsBf16<In>)
    *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(a, b);
  else
    *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}

template <typename In>
__device__ __forceinline__ void store1(In* dst, float a) {
  if constexpr (kIsBf16<In>)
    *dst = __float2bfloat16_rn(a);
  else
    *dst = a;
}

// rows row0 .. row0 + ROWS - 1 of a (T, D) head into a tile of stride ld,
// zeros past T; every thread of the block issues its share
template <int ROWS, int D, typename In>
__device__ __forceinline__ void issue_rows(In* dst, int ld, const In* __restrict__ src,
                                           int row0, int T) {
  constexpr int E = 16 / sizeof(In);       // elements a copy
  constexpr int PER_ROW = D / E;
  static_assert(ROWS * PER_ROW % kThreads == 0, "whole copies a thread");
#pragma unroll 4
  for (int n = 0; n < ROWS * PER_ROW / kThreads; ++n) {
    const int i = threadIdx.x + n * kThreads;
    const int r = i / PER_ROW, c = (i - r * PER_ROW) * E;
    const bool ok = row0 + r < T;
    cp_async16(dst + r * ld + c,
               ok ? src + static_cast<size_t>(row0 + r) * D + c : src, ok);
  }
}

// -- delta --

// delta[r] = sum_d g[r][d] o[r][d], a warp a row
template <typename In>
__global__ void __launch_bounds__(kThreads)
attn_delta_xwide(const In* __restrict__ o, const In* __restrict__ g,
                 float* __restrict__ delta, long long rows, int D) {
  const long long r = static_cast<long long>(blockIdx.x) * (kThreads / 32) +
                      threadIdx.x / 32;
  if (r >= rows) return;
  const int lane = threadIdx.x % 32;
  float sum = 0.f;
  for (int d = 4 * lane; d < D; d += 128) {
    const float4 x = load4<In>(g + r * D + d), y = load4<In>(o + r * D + d);
    sum = fmaf(x.x, y.x, sum);
    sum = fmaf(x.y, y.y, sum);
    sum = fmaf(x.z, y.z, sum);
    sum = fmaf(x.w, y.w, sum);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sum += __shfl_xor_sync(kFull, sum, off);
  if (lane == 0) delta[r] = sum;
}

// -- the key pass --

// chunk c (< 2 NC) of the query tile at q0 into a ring stage: Q and dO
// columns 64 (c % NC) .. + 63 of queries q0 .. q0 + 63 at stride LC1 (c <
// NC, the scores) or LC2 (the gradients), zeros past T; with c == 0 also
// the tile's lse and delta
template <int D, typename In>
__device__ __forceinline__ void keys_issue(In* stage, float* lse_s, float* del_s,
                                           const In* __restrict__ q,
                                           const In* __restrict__ g,
                                           const float* __restrict__ lse,
                                           const float* __restrict__ delta,
                                           int c, int q0, int T) {
  using S = Tiles<D, In>;
  constexpr int E = 16 / sizeof(In);
  constexpr int PER_ROW = kC / E;
  const bool scores = c < S::NC;
  const int col0 = (scores ? c : c - S::NC) * kC;
  const int ld = scores ? S::LC1 : S::LC2;
  In* Qc = stage;
  In* Gc = stage + kQ * S::LC1;
#pragma unroll
  for (int n = 0; n < kQ * PER_ROW / kThreads; ++n) {
    const int i = threadIdx.x + n * kThreads;
    const int r = i / PER_ROW, cc = (i % PER_ROW) * E;
    const bool ok = q0 + r < T;
    const size_t at = static_cast<size_t>(q0 + r) * D + col0 + cc;
    cp_async16(Qc + r * ld + cc, ok ? q + at : q, ok);
    cp_async16(Gc + r * ld + cc, ok ? g + at : g, ok);
  }
  if (c == 0 && threadIdx.x < 2 * kQ) {
    const int r = threadIdx.x % kQ;
    const bool ok = q0 + r < T;
    const bool first = threadIdx.x < kQ;
    const float* src = first ? lse : delta;
    cp_async4((first ? lse_s : del_s) + r, ok ? src + q0 + r : src, ok);
  }
}

// grid: (Tk / 32, heads); block (x, y) owns keys 32 x .. + 31 of head y and
// writes their dk and dv, and dS of every query at those keys to ds
// (BH, T, Tk)
template <int D, typename In>
__global__ void __launch_bounds__(kThreads, 1)
attn_bwd_xwide_keys(const In* __restrict__ q, const In* __restrict__ k,
                    const In* __restrict__ v, const In* __restrict__ g,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, In* __restrict__ dk,
                    In* __restrict__ dv, In* __restrict__ ds, int T, int Tk,
                    float scale, float scale_log2) {
  using S = Tiles<D, In>;
  constexpr bool kBf16 = S::BF16;
  constexpr int NC = S::NC, NST = S::KP_NST, LK = S::LK, LC1 = S::LC1,
                LC2 = S::LC2, LP = S::LP, STAGE = S::KP_STAGE;
  extern __shared__ float4 smem4[];
  In* Ks = reinterpret_cast<In*>(smem4);
  In* Vs = Ks + kKeys * LK;
  In* Ps = Vs + kKeys * LK;                  // P^T, [key][query]
  In* Ss = Ps + kKeys * LP;                  // dS^T, [key][query]
  // dP^T on its way from the dP warps to the S warps: float32, in place of
  // dS^T for float32, a tile of its own for bf16
  float* Xs = reinterpret_cast<float*>(Ss + (kBf16 ? kKeys * LP : 0));
  In* ring = kBf16 ? reinterpret_cast<In*>(Xs + kKeys * LP) : Ss + kKeys * LP;
  float* lse_s = reinterpret_cast<float*>(ring + NST * STAGE);
  float* del_s = lse_s + kQ;

  const size_t head = static_cast<size_t>(blockIdx.y) * T;
  q += head * D;
  k += head * D;
  v += head * D;
  g += head * D;
  dk += head * D;
  dv += head * D;
  lse += head;
  delta += head;
  ds += head * Tk;
  const int k0 = blockIdx.x * kKeys;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int gr = lane / 4, t = lane % 4;
  // warps 0-3 form S^T and then dV, warps 4-7 dP^T and then dK, each over
  // all 32 keys (two m-tiles) and queries qcol .. + 15 of the tile, then
  // columns qcol .. + 15 of each chunk
  const bool dside = warp >= 4;
  const int qcol = 16 * (warp & 3);
  const In* Ao = dside ? Vs : Ks;            // the scores' A: V or K rows
  const In* Ag = dside ? Ss : Ps;            // the gradients' A: dS^T or P^T

  issue_rows<kKeys, D, In>(Ks, LK, k, k0, T);
  issue_rows<kKeys, D, In>(Vs, LK, v, k0, T);
  cp_async_commit();

  // the next chunk to issue (chunk ic of the tile at iq0) and its stage
  int ic = 0, iq0 = 0, is = 0, rs = 0;
  auto issue_next = [&]() {
    if (iq0 < T)
      keys_issue<D, In>(ring + is * STAGE, lse_s, del_s, q, g, lse, delta,
                        ic, iq0, T);
    cp_async_commit();
    if (++ic == 2 * NC) {
      ic = 0;
      iq0 += kQ;
    }
    if (++is == NST) is = 0;
  };
  // wait for the oldest chunk in flight (every thread's copies), then issue
  // the one NST - 1 ahead into the stage the chunk before it held, which
  // the barrier says every warp is done with; returns the arrived stage
  auto next_stage = [&]() -> const In* {
    cp_async_wait<NST - 2>();
    __syncthreads();
    issue_next();
    const In* stage = ring + rs * STAGE;
    if (++rs == NST) rs = 0;
    return stage;
  };
#pragma unroll 1
  for (int n = 0; n < NST - 1; ++n) issue_next();

  // dV (or dK) of the 32 keys: chunk c, m-tile m, n-block u
  float acc[NC][2][2][4];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[c][m][u][e] = 0.f;

#pragma unroll 1
  for (int q0 = 0; q0 < T; q0 += kQ) {
    // S^T (or dP^T) of the 32 keys x the warp's 16 queries: m-tile m,
    // n-block j
    float x[2][2][4];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) x[m][j][e] = 0.f;
#pragma unroll 1
    for (int c = 0; c < NC; ++c) {
      const In* Qc = next_stage();
      const In* Bc = dside ? Qc + kQ * LC1 : Qc;   // dO or Q rows
      if constexpr (kBf16) {
        const In* aa = Ao + (lane % 16) * LK + c * kC + 8 * (lane / 16);
        const In* bb = Bc + (qcol + lane % 8 + 8 * (lane / 16)) * LC1 +
                       8 * ((lane / 8) % 2);
#pragma unroll
        for (int s = 0; s < kC / 16; ++s) {
          uint32_t b[4];
          ldsm4(b, bb + 16 * s);
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            uint32_t a[4];
            ldsm4(a, aa + 16 * m * LK + 16 * s);
            mma_bf16(x[m][0], a, b[0], b[1]);
            mma_bf16(x[m][1], a, b[2], b[3]);
          }
        }
      } else {
        // the chunk's sums in fresh accumulators, added to the running ones
        const float* aa = Ao + gr * LK + c * kC + 2 * t;
        const float* bb = Bc + (qcol + gr) * LC1 + 2 * t;
        float xc[2][2][4] = {};
#pragma unroll
        for (int s = 0; s < kC / 8; ++s) {
          uint32_t ah[2][4], al[2][4];
#pragma unroll
          for (int m = 0; m < 2; ++m)
            split_a(aa + 16 * m * LK + 8 * s, LK, ah[m], al[m]);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            uint32_t bh[2], bl[2];
            const float2 xb = ld2(bb + 8 * j * LC1 + 8 * s);
            split_b(xb.x, xb.y, bh, bl);
#pragma unroll
            for (int m = 0; m < 2; ++m) mma3(xc[m][j], ah[m], al[m], bh, bl);
          }
        }
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) x[m][j][e] += xc[m][j][e];
      }
    }

    // the dP warps hand dP^T over; the S warps form P^T and dS^T of their
    // scores (key 16 m + gr + 8 h, query qcol + 8 j + 2 t + e) into shared
    // memory and dS into the scratch; P and dS are 0 at keys or queries
    // past T
    if (dside) {
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            *reinterpret_cast<float2*>(Xs + (16 * m + gr + 8 * h) * LP + qcol +
                                       8 * j + 2 * t) =
                make_float2(x[m][j][2 * h], x[m][j][2 * h + 1]);
    }
    __syncthreads();
    if (!dside) {
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int kl = 16 * m + gr + 8 * h, ql = qcol + 8 * j + 2 * t;
            const float2 dp = ld2(Xs + kl * LP + ql);
            float p[2], d[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const bool live = k0 + kl < T && q0 + ql + e < T;
              p[e] = live ? exp2f(x[m][j][2 * h + e] * scale_log2 -
                                  lse_s[ql + e] * kLog2e)
                          : 0.f;
              d[e] = p[e] * ((e ? dp.y : dp.x) - del_s[ql + e]) * scale;
              if (q0 + ql + e < T)
                store1<In>(ds + static_cast<size_t>(q0 + ql + e) * Tk + k0 + kl,
                           d[e]);
            }
            store2<In>(Ps + kl * LP + ql, p[0], p[1]);
            store2<In>(Ss + kl * LP + ql, d[0], d[1]);
          }
    }

    // dV += P^T dO (or dK += dS^T Q), a chunk of 64 columns at a time: the
    // warp's columns qcol + 8 u .. of chunk c
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const In* Qc = next_stage();
      const In* Bc = dside ? Qc : Qc + kQ * LC1;   // Q or dO rows
      if constexpr (kBf16) {
        const In* aa = Ag + (lane % 16) * LP + 8 * (lane / 16);
        const In* bb = Bc + (lane % 8 + 8 * ((lane / 8) % 2)) * LC2 + qcol +
                       8 * (lane / 16);
#pragma unroll
        for (int s = 0; s < kQ / 16; ++s) {
          uint32_t b[4];
          ldsm4_t(b, bb + 16 * s * LC2);
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            uint32_t a[4];
            ldsm4(a, aa + 16 * m * LP + 16 * s);
            mma_bf16(acc[c][m][0], a, b[0], b[1]);
            mma_bf16(acc[c][m][1], a, b[2], b[3]);
          }
        }
      } else {
        const float* aa = Ag + gr * LP + 2 * t;
        const float* bb = Bc + 2 * t * LC2 + qcol + gr;
        float xc[2][2][4] = {};
#pragma unroll 2
        for (int s = 0; s < kQ / 8; ++s) {
          uint32_t ah[2][4], al[2][4];
#pragma unroll
          for (int m = 0; m < 2; ++m)
            split_a(aa + 16 * m * LP + 8 * s, LP, ah[m], al[m]);
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            uint32_t bh[2], bl[2];
            const float* xb = bb + 8 * s * LC2 + 8 * u;
            split_b(xb[0], xb[LC2], bh, bl);
#pragma unroll
            for (int m = 0; m < 2; ++m) mma3(xc[m][u], ah[m], al[m], bh, bl);
          }
        }
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int u = 0; u < 2; ++u)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[c][m][u][e] += xc[m][u][e];
      }
    }
  }
  cp_async_wait<0>();

  In* out = dside ? dk : dv;
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int key = k0 + 16 * m + gr + 8 * h;
      if (key >= T) continue;
      In* row = out + static_cast<size_t>(key) * D + qcol + 2 * t;
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int u = 0; u < 2; ++u)
          store2<In>(row + c * kC + 8 * u, acc[c][m][u][2 * h],
                     acc[c][m][u][2 * h + 1]);
    }
}

// -- the dq pass --

// key tile kt of a dq block into a ring stage: dS rows q0 .. q0 + 63 at
// keys 32 kt .. + 31 (stride LS; rows past T as zeros; every key < Tk is
// written by the key pass), then K rows 32 kt .. + 31 (stride LKQ; zeros
// past T)
template <int D, typename In>
__device__ __forceinline__ void dq_issue(In* stage, const In* __restrict__ ds,
                                         const In* __restrict__ k, int kt,
                                         int q0, int T, int Tk) {
  using S = Tiles<D, In>;
  constexpr int E = 16 / sizeof(In);
  constexpr int PER_ROW = kDqKeys / E;
#pragma unroll
  for (int n = 0; n < kDqRows * PER_ROW / kThreads; ++n) {
    const int i = threadIdx.x + n * kThreads;
    const int r = i / PER_ROW, cc = (i % PER_ROW) * E;
    const bool ok = q0 + r < T;
    cp_async16(stage + r * S::LS + cc,
               ok ? ds + static_cast<size_t>(q0 + r) * Tk + kt * kDqKeys + cc : ds,
               ok);
  }
  issue_rows<kDqKeys, D, In>(stage + kDqRows * S::LS, S::LKQ, k, kt * kDqKeys, T);
}

// grid: (ceil(T / 64), heads); block (x, y) owns queries 64 x .. + 63 of
// head y: dq = dS K over the Tk / 32 key tiles
template <int D, typename In>
__global__ void __launch_bounds__(kThreads, 1)
attn_bwd_xwide_dq(const In* __restrict__ ds, const In* __restrict__ k,
                  In* __restrict__ dq, int T, int Tk) {
  using S = Tiles<D, In>;
  constexpr bool kBf16 = S::BF16;
  constexpr int NST = S::DQ_NST, LS = S::LS, LKQ = S::LKQ,
                STAGE = S::DQ_STAGE, NB = D / 16;
  extern __shared__ float4 smem4[];
  In* ring = reinterpret_cast<In*>(smem4);

  const size_t head = static_cast<size_t>(blockIdx.y) * T;
  ds += head * Tk;
  k += head * D;
  dq += head * D;
  const int q0 = blockIdx.x * kDqRows;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int gr = lane / 4, t = lane % 4;
  const int qrow = 16 * (warp & 3);          // the warp's queries
  const int col0 = (warp >> 2) * (D / 2);    // its columns
  const int n_kt = Tk / kDqKeys;

#pragma unroll 1
  for (int n = 0; n < NST - 1; ++n) {
    if (n < n_kt) dq_issue<D, In>(ring + n * STAGE, ds, k, n, q0, T, Tk);
    cp_async_commit();
  }
  float acc[NB][4];
#pragma unroll
  for (int n = 0; n < NB; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  int rs = 0, is = NST - 1;
#pragma unroll 1
  for (int kt = 0; kt < n_kt; ++kt) {
    cp_async_wait<NST - 2>();
    __syncthreads();
    if (kt + NST - 1 < n_kt)
      dq_issue<D, In>(ring + is * STAGE, ds, k, kt + NST - 1, q0, T, Tk);
    cp_async_commit();
    if (++is == NST) is = 0;
    const In* Dt = ring + rs * STAGE;
    const In* Kt = Dt + kDqRows * LS;
    if (++rs == NST) rs = 0;
    if constexpr (kBf16) {
      uint32_t a[2][4];
#pragma unroll
      for (int s = 0; s < 2; ++s)
        ldsm4(a[s], Dt + (qrow + lane % 16) * LS + 16 * s + 8 * (lane / 16));
      const In* kb = Kt + (lane % 8 + 8 * ((lane / 8) % 2)) * LKQ + col0 + 8 * (lane / 16);
#pragma unroll
      for (int p = 0; p < NB / 2; ++p)
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          uint32_t b[4];
          ldsm4_t(b, kb + 16 * s * LKQ + 16 * p);
          mma_bf16(acc[2 * p], a[s], b[0], b[1]);
          mma_bf16(acc[2 * p + 1], a[s], b[2], b[3]);
        }
    } else {
      uint32_t ah[4][4], al[4][4];
#pragma unroll
      for (int s = 0; s < 4; ++s)
        split_a(Dt + (qrow + gr) * LS + 8 * s + 2 * t, LS, ah[s], al[s]);
      const float* kb = Kt + 2 * t * LKQ + col0 + gr;
      // a pair of n-blocks at a time: the tile's 32 keys in a fresh
      // accumulator, then into the running sum
#pragma unroll
      for (int p = 0; p < NB / 2; ++p) {
        float c2[2][4] = {};
#pragma unroll
        for (int s = 0; s < 4; ++s)
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const float* x = kb + 8 * s * LKQ + 16 * p + 8 * u;
            uint32_t bh[2], bl[2];
            split_b(x[0], x[LKQ], bh, bl);
            mma3(c2[u], ah[s], al[s], bh, bl);
          }
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[2 * p + u][e] += c2[u][e];
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + qrow + gr + 8 * h;
    if (row >= T) continue;
    In* dst = dq + static_cast<size_t>(row) * D + col0 + 2 * t;
#pragma unroll
    for (int n = 0; n < NB; ++n) store2<In>(dst + 8 * n, acc[n][2 * h], acc[n][2 * h + 1]);
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// delta, then per run of at most 65535 heads the key pass and the dq pass
template <int D, typename In>
int launch(const In* q, const In* k, const In* v, const In* o, const In* g,
           const float* lse, float* delta, In* ds, In* dq, In* dk, In* dv,
           int BH, int T, float scale, cudaStream_t stream) {
  using S = Tiles<D, In>;
  const long long rows = static_cast<long long>(BH) * T;
  const unsigned blocks = static_cast<unsigned>(
      (rows + kThreads / 32 - 1) / (kThreads / 32));
  attn_delta_xwide<In><<<blocks, kThreads, 0, stream>>>(o, g, delta, rows, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = allow_smem(attn_bwd_xwide_keys<D, In>, S::KP_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = allow_smem(attn_bwd_xwide_dq<D, In>, S::DQ_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int Tk = (T + kKeys - 1) / kKeys * kKeys;
  for (int h0 = 0; h0 < BH; h0 += kMaxGridY) {
    const size_t at = static_cast<size_t>(h0) * T;
    const int nh = min(BH - h0, kMaxGridY);
    attn_bwd_xwide_keys<D, In><<<dim3(Tk / kKeys, nh), kThreads, S::KP_BYTES, stream>>>(
        q + at * D, k + at * D, v + at * D, g + at * D, lse + at, delta + at,
        dk + at * D, dv + at * D, ds + at * Tk, T, Tk, scale, scale * kLog2e);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    attn_bwd_xwide_dq<D, In><<<dim3((T + kDqRows - 1) / kDqRows, nh), kThreads,
                                 S::DQ_BYTES, stream>>>(ds + at * Tk, k + at * D,
                                                        dq + at * D, T, Tk);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

template <typename In>
int dispatch(const void* q, const void* k, const void* v, const void* o,
             const void* g, const void* lse, void* delta, void* ds, void* dq,
             void* dk, void* dv, int BH, int T, int D, float scale,
             void* stream) {
  if (BH < 1 || T < 1) return static_cast<int>(cudaErrorInvalidValue);
  const In *qi = static_cast<const In*>(q), *ki = static_cast<const In*>(k),
           *vi = static_cast<const In*>(v), *oi = static_cast<const In*>(o),
           *gi = static_cast<const In*>(g);
  const float* lf = static_cast<const float*>(lse);
  float* df = static_cast<float*>(delta);
  In *si = static_cast<In*>(ds), *dqi = static_cast<In*>(dq),
     *dki = static_cast<In*>(dk), *dvi = static_cast<In*>(dv);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 320:
      return launch<320, In>(qi, ki, vi, oi, gi, lf, df, si, dqi, dki, dvi, BH, T, scale, s);
    case 384:
      return launch<384, In>(qi, ki, vi, oi, gi, lf, df, si, dqi, dki, dvi, BH, T, scale, s);
    case 448:
      return launch<448, In>(qi, ki, vi, oi, gi, lf, df, si, dqi, dki, dvi, BH, T, scale, s);
    case 512:
      return launch<512, In>(qi, ki, vi, oi, gi, lf, df, si, dqi, dki, dvi, BH, T, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, k, v, o, g, dq, dk, dv: contiguous float32 (BH, T, D), 16-byte
// aligned, D one of 320, 384, 448, 512; lse (the forward's) and delta
// (scratch): float32 (BH, T); ds: float32 scratch (BH, T, Tk), Tk = T
// rounded up to a multiple of 32. Launches delta, then the key pass and the
// dq pass a run of 65535 heads. Returns the CUDA error code of the launches
// (0 on success).
extern "C" int uurg_attention_bwd_xwide_f32(const void* q, const void* k,
                                            const void* v, const void* o,
                                            const void* g, const void* lse,
                                            void* delta, void* ds, void* dq,
                                            void* dk, void* dv, int BH, int T,
                                            int D, float scale, void* stream) {
  return dispatch<float>(q, k, v, o, g, lse, delta, ds, dq, dk, dv, BH, T, D,
                         scale, stream);
}

// the same in bfloat16: q, k, v, o, g, ds, dq, dk, dv bf16; lse and delta
// float32
extern "C" int uurg_attention_bwd_xwide_bf16(const void* q, const void* k,
                                             const void* v, const void* o,
                                             const void* g, const void* lse,
                                             void* delta, void* ds, void* dq,
                                             void* dk, void* dv, int BH, int T,
                                             int D, float scale, void* stream) {
  return dispatch<__nv_bfloat16>(q, k, v, o, g, lse, delta, ds, dq, dk, dv, BH,
                                 T, D, scale, stream);
}
