// Hopper (sm_90a) building blocks shared by the kernels: mbarriers, TMA tile
// loads through tensor maps, bulk copies of a contiguous range, thread-block
// clusters and their distributed shared memory (the GroupNorm forward), wgmma
// (warpgroup matrix multiply) with its shared-memory descriptors, named
// barriers and register reallocation (the attention kernels).
// Thin wrappers over PTX; no kernel lives here.
//
// Shared-memory tile layout used throughout: a (rows, D) bf16 tile is stored
// as ceil(D / 64) chunks, each chunk rows x 64 elements (128 bytes a row) in
// the 128-byte swizzle that TMA writes and wgmma reads, chunk after chunk.
// Every chunk starts on a 1024-byte boundary (rows is a multiple of 8). One
// TMA box (64 columns x rows) fills one chunk; where the head width D is not
// a multiple of 64, the last box runs past column D and TMA fills the rest of
// the chunk with zeros, so no byte of padding exists in device memory. The same chunk serves as a K-major
// operand (the contraction runs along the 64 columns: Q K^T) and as an
// MN-major operand (the contraction runs along the rows: P V), chosen in the
// descriptor and the instruction's transpose bit, so no tile is ever stored
// transposed.
#pragma once
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

constexpr int kChunkCols = 64;          // bf16 elements in a 128-byte row
constexpr uint32_t kRowBytes = 128;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// two floats -> bf16x2, the first in the low half (the lower column index)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 2^x by the special-function unit alone (what exp2f ends in, without its
// scaling of results below 2^-126, which are flushed to 0 here)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---------------------------------------------------------------- mbarrier
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

// makes the initialised barriers visible to the async proxy (TMA)
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// spins until the barrier's phase differs from `parity`. (A watchdog that
// traps after a long wait was tried here: the call it adds to the consumers'
// loop costs ptxas its register plan, 404 bytes of spills at D = 256 and
// serialised wgmma; the forward then took 0.1140 ms where it takes 0.0751
// without, same script and card as below.)
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// --------------------------------------------------------------------- TMA
// One box of a (B, H, T, D) tensor map (dimensions D, T, H, B; see
// make_tile_map) into shared memory at `dst`; completion is counted in bytes
// on `bar`. Coordinates: column, row, head, batch. Rows past T and columns
// past D arrive as zeros (and still count towards the bytes).
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int col, int row,
                                            int h, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row), "r"(h),
      "r"(b)
      : "memory");
}

// A (rows, 64 NC) tile: one box per 64-column chunk, chunk after chunk at
// `dst`, for head h of batch element b.
template <int NC>
__device__ __forceinline__ void tma_load_tile(uint32_t dst, const CUtensorMap* map,
                                              uint32_t bar, int rows, int row0,
                                              int h, int b) {
#pragma unroll
  for (int c = 0; c < NC; ++c)
    tma_load_4d(dst + c * rows * kRowBytes, map, bar, c * kChunkCols, row0, h, b);
}

// ------------------------------------------------------------- bulk copy
// `bytes` contiguous bytes from global memory to shared memory at `dst`, with
// no tensor map: source, destination and size are multiples of 16. Completion
// is counted in bytes on `bar` (at most 2^20 - 1 bytes a barrier phase).
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// ---------------------------------------------------- thread-block clusters
// rank of this block in its cluster
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// The cluster's barrier, split: every thread of every block arrives once and
// waits once a phase. What a thread wrote before it arrived, into any block's
// shared memory, is visible to every thread after its wait.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// the address, in the cluster's window, of block `rank`'s copy of this block's
// shared-memory address `addr`
__device__ __forceinline__ uint32_t cluster_map(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

__device__ __forceinline__ void cluster_store(uint32_t addr, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(addr), "f"(v) : "memory");
}

// ------------------------------------------------------------------- wgmma
// Shared-memory matrix descriptor for a chunk in the 128-byte swizzle.
// K-major (contraction along the 64 columns): groups of 8 rows lie 1024 bytes
// apart (stride offset); the leading offset is not used. MN-major
// (contraction along the rows): groups of 8 contraction rows lie 1024 bytes
// apart (stride offset); the leading offset is the distance between blocks of
// 64 columns, unused at n = 64. Both therefore share one encoding.
__device__ __forceinline__ uint64_t mma_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>(1) << 16) |            // leading offset (unused)
         (static_cast<uint64_t>(1024 >> 4) << 32) |    // stride offset
         (static_cast<uint64_t>(1) << 62);             // 128-byte swizzle
}

// byte offsets to add to a chunk's address for the k-th 16-wide contraction step
constexpr uint32_t kStepKMajor = 32;                   // 16 bf16 along a row
constexpr uint32_t kStepMNMajor = 16 * kRowBytes;      // 16 rows

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps ordinary code that reads or writes accumulator registers on its side
// of a wgmma fence or wait (the first L registers: those a narrow product
// writes)
template <int L = 32, int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < (L < N ? L : N); ++i) asm volatile("" : "+f"(r[i])::"memory");
}

#define UURG_D32                                                              \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),     \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),        \
      "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),        \
      "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),        \
      "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define UURG_D8                                                               \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),     \
      "+f"(d[6]), "+f"(d[7])
#define UURG_D24                                                              \
  UURG_D16, "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),  \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
#define UURG_R8 "{%0, %1, %2, %3, %4, %5, %6, %7}"
#define UURG_R24                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "   \
  "%16, %17, %18, %19, %20, %21, %22, %23}"
#define UURG_D16                                                              \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),     \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
#define UURG_R32                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "   \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "    \
  "%30, %31}"
#define UURG_R16                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"

// d (64 x 64, fp32) = a (64 x 16, shared, K-major) b (64 x 16 as N x K, shared,
// K-major) + (accumulate ? d : 0)
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a,
                                             uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " UURG_R32
      ", %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : UURG_D32
      : "l"(a), "l"(b), "r"(accumulate));
}

// the same with a 32-wide b: d (64 x 32)
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t a,
                                             uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " UURG_R16
      ", %16, %17, p, 1, 1, 0, 0;\n"
      "}\n"
      : UURG_D16
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 64, fp32) += a (64 x 16 bf16, this thread's registers) b (16 x 64 as
// K x N, shared, MN-major: the rows of the chunk are the contraction)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " UURG_R32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : UURG_D32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x N, fp32, in the first N / 2 registers of a 64-column accumulator)
// += a (64 x 16 bf16, registers) b (16 x N as K x N, shared, MN-major), for
// N = 16, 32, 48: the last 64-column chunk of a head width that is not a
// multiple of 64 (D = 72: n16 over columns 64-79), so that no product runs
// over the columns that are zero past the width. The operand is the same
// 128-byte-swizzled chunk as for n64; the instruction reads its first N
// columns.
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t b);
template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t b) {
  wgmma_rs_n64(d, a, b);
}
template <>
__device__ __forceinline__ void wgmma_rs<48>(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 " UURG_R24
      ", {%24, %25, %26, %27}, %28, p, 1, 1, 1;\n"
      "}\n"
      : UURG_D24
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " UURG_R16
      ", {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n"
      "}\n"
      : UURG_D16
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_rs<16>(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 " UURG_R8
      ", {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n"
      "}\n"
      : UURG_D8
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef UURG_D32
#undef UURG_D24
#undef UURG_D16
#undef UURG_D8
#undef UURG_R32
#undef UURG_R24
#undef UURG_R16
#undef UURG_R8

// A head width of KS 16-column steps: tiles and accumulators of NC =
// ceil(KS / 4) chunks of 64 columns (kCols in shared memory), the last of
// which holds kLast columns (and kLast / 2 live accumulator registers a
// thread; the rest are never written or read). Narrow widths (at most two
// chunks) leave the shared memory for deeper rings and second buffers.
template <int KS>
struct Width {
  static constexpr int NC = (KS + 3) / 4;
  static constexpr int kCols = NC * kChunkCols;
  static constexpr int kLast = 16 * (KS - 4 * (NC - 1));
  static constexpr bool kNarrow = NC <= 2;
  __host__ __device__ static constexpr int live(int c) {
    return c == NC - 1 ? kLast / 2 : 32;
  }
};

// reg_fence over the live registers of such an accumulator
template <int KS>
__device__ __forceinline__ void reg_fence_acc(float (&acc)[Width<KS>::NC][32]) {
#pragma unroll
  for (int c = 0; c < Width<KS>::NC; ++c) {
    if (c == Width<KS>::NC - 1)
      reg_fence<Width<KS>::kLast / 2>(acc[c]);
    else
      reg_fence(acc[c]);
  }
}

// acc += a (64 x 16 bf16, registers) b, b the 16 contraction rows of a
// (rows, 64 NC) tile in shared memory (MN-major) that start `off` bytes into
// each chunk at `desc`, chunks `chunk` bytes apart: one instruction a chunk,
// n64, and the last chunk's kLast columns only
template <int KS>
__device__ __forceinline__ void wgmma_rs_acc(float (&acc)[Width<KS>::NC][32],
                                             const uint32_t (&a)[4], uint64_t desc,
                                             uint32_t chunk, uint32_t off) {
#pragma unroll
  for (int c = 0; c < Width<KS>::NC; ++c) {
    const uint64_t b = desc + ((c * chunk + off) >> 4);
    if (c == Width<KS>::NC - 1)
      wgmma_rs<Width<KS>::kLast>(acc[c], a, b);
    else
      wgmma_rs<64>(acc[c], a, b);
  }
}

// A 64 x N fp32 accumulator lies in registers as follows: warp w of the
// warpgroup holds rows 16 w .. 16 w + 15; with g = lane / 4 and tq = lane % 4,
// d[4 j + e] is row g + 8 (e / 2), column 8 j + 2 tq + (e % 2). The A operand
// of a 16-deep step has the same rows, so the accumulator of columns
// 16 s .. 16 s + 15 becomes that step's A registers by rounding in place.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float* d16) {
  a[0] = pack_bf16(d16[0], d16[1]);
  a[1] = pack_bf16(d16[2], d16[3]);
  a[2] = pack_bf16(d16[4], d16[5]);
  a[3] = pack_bf16(d16[6], d16[7]);
}

// In-register 4 x 4 transpose across the four lanes of a quad (tq = lane % 4):
// afterwards v[n] holds what lane n had in its v[tq].
__device__ __forceinline__ void quad_transpose(uint32_t (&v)[4], int tq) {
  const bool odd = tq & 1, high = tq & 2;
  uint32_t s0 = odd ? v[0] : v[1], s1 = odd ? v[2] : v[3];
  s0 = __shfl_xor_sync(0xffffffffu, s0, 1);
  s1 = __shfl_xor_sync(0xffffffffu, s1, 1);
  if (odd) { v[0] = s0; v[2] = s1; } else { v[1] = s0; v[3] = s1; }
  s0 = high ? v[0] : v[2];
  s1 = high ? v[1] : v[3];
  s0 = __shfl_xor_sync(0xffffffffu, s0, 2);
  s1 = __shfl_xor_sync(0xffffffffu, s1, 2);
  if (high) { v[0] = s0; v[1] = s1; } else { v[2] = s0; v[3] = s1; }
}

// Stores this thread's part of a warpgroup's 64 x (64 NC) accumulator, scaled
// by s0 (row row0) and s1 (row row0 + 8), as bf16 into rows of `ld`
// elements at `dst` (row r at dst + r * ld), columns below D only (D a
// multiple of 8). A thread holds two neighbouring columns of every 8-column
// group; written as they lie, each 4-byte store fills an eighth of a 32-byte
// sector. So the four lanes of a quad first swap their pairs: each then
// holds 8 whole columns and stores 16 bytes, a quad 64 contiguous bytes of a
// row. That took the forward at B*H = 256, T = 256, D = 256 from 0.0751 to
// 0.0534 ms (scripts/profile_torch_attention.py, NVIDIA H100 80GB HBM3,
// 700 W). Staging the tile in shared memory for a TMA store was tried and
// was no faster (0.0538 ms), and three more tensor maps a call cost the host
// about 20 us of eager time in the backward at T = 16.
// The last chunk holds LAST columns: its registers past them are not read.
template <int NC, int LAST = 64>
__device__ __forceinline__ void store_acc(__nv_bfloat16* dst,
                                          const float (&acc)[NC][32], int row0,
                                          int T, size_t ld, int D, int tq,
                                          float s0, float s1) {
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const int cols = c == NC - 1 ? LAST : 64;
      if (32 * m >= cols) continue;                  // no live column here
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float sc = h == 0 ? s0 : s1;
        uint32_t v[4];
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const int j = 4 * m + n;                   // 8-column group
          v[n] = 8 * j < cols ? pack_bf16(acc[c][4 * j + 2 * h] * sc,
                                          acc[c][4 * j + 2 * h + 1] * sc)
                              : 0u;
        }
        quad_transpose(v, tq);
        const int row = row0 + 8 * h;
        const int col = c * kChunkCols + (4 * m + tq) * 8;
        if (row < T && col < D)
          *reinterpret_cast<uint4*>(dst + static_cast<size_t>(row) * ld + col) =
              make_uint4(v[0], v[1], v[2], v[3]);
      }
    }
}

// ------------------------------------------- warp roles and named barriers
template <int R>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ------------------------------------------------ host: device, tensor maps
// SMs of the first device used: the grid of a persistent kernel
inline cudaError_t sm_count(int* sms) {
  static int cached = 0;
  if (cached == 0) {
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&cached, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
  }
  *sms = cached;
  return cudaSuccess;
}

constexpr int kTensorMapFailed = -1;   // the launchers' result beside CUDA's codes

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the libcuda that is already loaded, so that the
// library needs no link against it
inline EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &status);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &status);
#endif
    if (err != cudaSuccess || status != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// Element strides of a (B, H, T, D) tensor whose last dimension is
// contiguous: rows (over T), heads (over H) and batch elements (over B).
struct Strides {
  long long t, h, b;
};

// Map of a (B, H, T, D) bf16 tensor with the given strides, as four
// dimensions (D, T, H, B) with the true width D as dimension 0, in boxes of
// 64 columns x `box_rows` rows of one head, 128-byte swizzle. A box that
// runs past T or past D is filled with zeros, never with the next head's
// rows or columns, whatever the layout (a head's columns inside a fused
// (B, T, 3, H, D) projection included). TMA needs every stride in bytes to
// be a multiple of 16 and the base 16-byte aligned: the caller checks. L2
// promotion is 128 bytes: at D = 72 each row of the last box holds 16 bytes,
// and 256-byte promotion fetched twice what the rows need (the forward at
// (32, 16, 256, 72) took 0.0520 ms with it, 0.0467 with 128 bytes and 0.0476
// with none, the backward 0.226 / 0.220 / 0.220; D = 256 the same either
// way; scripts/profile_torch_attention.py in turns, NVIDIA H100 80GB HBM3,
// 700 W).
inline bool make_tile_map(CUtensorMap* map, const void* base, int B, int H,
                          int T, int D, Strides st, int box_rows) {
  EncodeTiledFn encode = encode_tiled_fn();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(T),
                              static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st.t) * 2,
                                 static_cast<cuuint64_t>(st.h) * 2,
                                 static_cast<cuuint64_t>(st.b) * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(kChunkCols),
                             static_cast<cuuint32_t>(box_rows), 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
                dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace hopper
