// Attention forward: o = softmax(q k^T * scale) v on (B*H, T, D) bf16.
//
// Replaces: uurg_tpu/ops/flash_attention.py::_attn_kernel (launched by
// _fused_attention_fwd_impl). Scores, softmax and both accumulations are fp32;
// the probabilities are rounded to bf16 before the PV product, as the TPU
// kernel casts p to v's dtype. The T x T score matrix never leaves the SM.
//
// Bound: bytes on the sampling path. A head does 4 * T * T * D flops on
// 8 * T * D bytes (q, k, v read, o written): T / 2 = 128 flops a byte at
// T = 256 and 8 at the T = 16 mid site, both under the H100's 295 bf16 flops
// a byte. Only T >= ~600 (DiT, SD) would be bound by the tensor cores.
//
// Design: the TPU kernel holds a whole head's K and V in VMEM and does one
// plain softmax. At D = 256 a 64-row q tile (32 KB) plus K (128 KB) plus V
// (128 KB) is 288 KB, over the 227 KB a block can have, so this kernel walks
// K/V in 64-key tiles with an online softmax (running max and sum per row,
// the output rescaled when the max grows). Shared memory holds the q tile,
// one K tile (row-major) and one V tile stored transposed, each row padded by
// 8 bf16 so the fragment loads are free of bank conflicts: 104 KB at D = 256,
// two blocks per SM. Four warps each own 16 query rows and run mma.sync
// m16n8k16 (bf16 in, fp32 accumulate). The register-pressure point is the
// (16 x D) fp32 output accumulator of a warp: it is held in the mma C-fragment
// layout, D / 8 tiles of 4 floats per thread (128 registers at D = 256), and
// never spills to shared memory; the q fragments are re-read from shared
// memory per 16-wide k step instead of being held (which would cost another
// 64 registers). S is converted in registers straight into the A fragments of
// the PV product. Rows past T (ragged q tiles, T = 16) are zero-filled and not
// stored; keys past T are masked to -inf.
//
// When a gradient is wanted the caller passes an lse buffer: the kernel then
// also writes each row's natural log-sum-exp of the scaled scores, fp32
// (B*H, T), from which the backward kernel rebuilds P tile by tile. The
// sampling path passes none and runs the same instructions as without it.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;      // query rows per block
constexpr int kBK = 64;      // keys per tile
constexpr int kWarps = 4;    // each warp owns 16 query rows
constexpr int kThreads = kWarps * 32;
constexpr int kPad = 8;      // bf16 padding per shared-memory row

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

template <int D>
constexpr size_t smem_bytes() {
  return (static_cast<size_t>(kBQ + kBK) * (D + kPad) +
          static_cast<size_t>(D) * (kBK + kPad)) * sizeof(__nv_bfloat16);
}

// grid: (ceil(T / kBQ), B*H); block: kThreads.
template <int D>
__global__ void __launch_bounds__(kThreads)
attn_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v,
                __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int T,
                float scale_log2) {
  constexpr int QS = D + kPad;   // row stride of Qs and Ks (elements)
  constexpr int VS = kBK + kPad; // row stride of Vt
  constexpr int NT = D / 8;      // output n-tiles per warp
  constexpr int CH = D / 8;      // 16-byte chunks per row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + kBQ * QS;
  __nv_bfloat16* Vt = Ks + kBK * QS;   // [D][kBK + kPad]: V transposed

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;   // mma fragment row / column pair
  const int q0 = blockIdx.x * kBQ;
  const size_t head = static_cast<size_t>(blockIdx.y) * T * D;
  const __nv_bfloat16* qh = q + head;
  const __nv_bfloat16* kh = k + head;
  const __nv_bfloat16* vh = v + head;
  __nv_bfloat16* oh = o + head;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  for (int i = tid; i < kBQ * CH; i += kThreads) {
    const int r = i / CH, c = (i % CH) * 8;
    uint4 val = zero;
    if (q0 + r < T)
      val = *reinterpret_cast<const uint4*>(qh + static_cast<size_t>(q0 + r) * D + c);
    *reinterpret_cast<uint4*>(Qs + r * QS + c) = val;
  }

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};   // rows g and g + 8
  float l_run[2] = {0.f, 0.f};               // this thread's share of the row sums
  const int qr = warp * 16;

  for (int k0 = 0; k0 < T; k0 += kBK) {
    __syncthreads();   // the previous tile is consumed (and Qs is stored)
    // K tile, row-major: a warp reads contiguous 16-byte chunks of one row
    for (int i = tid; i < kBK * CH; i += kThreads) {
      const int r = i / CH, c = (i % CH) * 8;
      uint4 val = zero;
      if (k0 + r < T)
        val = *reinterpret_cast<const uint4*>(kh + static_cast<size_t>(k0 + r) * D + c);
      *reinterpret_cast<uint4*>(Ks + r * QS + c) = val;
    }
    // V tile, transposed: neighbouring threads take neighbouring keys so the
    // 2-byte stores into a Vt row fall in distinct banks
    for (int i = tid; i < kBK * CH; i += kThreads) {
      const int r = i % kBK, c = (i / kBK) * 8;
      uint4 val = zero;
      if (k0 + r < T)
        val = *reinterpret_cast<const uint4*>(vh + static_cast<size_t>(k0 + r) * D + c);
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&val);
#pragma unroll
      for (int j = 0; j < 8; ++j) Vt[(c + j) * VS + r] = e[j];
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows and the tile's 64 keys
    float s[kBK / 8][4];
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
      const __nv_bfloat16* qa = Qs + (qr + g) * QS + kk + tq * 2;
      const uint32_t a[4] = {ld32(qa), ld32(qa + 8 * QS), ld32(qa + 8),
                             ld32(qa + 8 * QS + 8)};
#pragma unroll
      for (int n = 0; n < kBK / 8; ++n) {
        const __nv_bfloat16* kb = Ks + (n * 8 + g) * QS + kk + tq * 2;
        const uint32_t b[2] = {ld32(kb), ld32(kb + 8)};
        mma_16816(s[n], a, b);
      }
    }

    // online softmax in the log2 domain
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + n * 8 + tq * 2 + (e & 1);
        const float val = key < T ? s[n][e] * scale_log2 : -INFINITY;
        s[n][e] = val;
        mx[e >> 1] = fmaxf(mx[e >> 1], val);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      // key k0 is always valid, so m_new is finite; alpha is 0 on the first tile
      const float m_new = fmaxf(m_run[r], mx[r]);
      alpha[r] = exp2f(m_run[r] - m_new);
      m_run[r] = m_new;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[n][e] - m_run[e >> 1]);
        s[n][e] = p;
        rs[e >> 1] += p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + rs[r];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // O += P V: the S accumulators of two neighbouring key tiles are the A
    // fragment of one 16-key step
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) {
      const uint32_t a[4] = {pack_bf16(s[2 * ks][0], s[2 * ks][1]),
                             pack_bf16(s[2 * ks][2], s[2 * ks][3]),
                             pack_bf16(s[2 * ks + 1][0], s[2 * ks + 1][1]),
                             pack_bf16(s[2 * ks + 1][2], s[2 * ks + 1][3])};
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const __nv_bfloat16* vb = Vt + (n * 8 + g) * VS + ks * 16 + tq * 2;
        const uint32_t b[2] = {ld32(vb), ld32(vb + 8)};
        mma_16816(acc[n], a, b);
      }
    }
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
    inv[r] = 1.f / l_run[r];
  }
  const int row0 = q0 + qr + g, row1 = row0 + 8;
  if (lse != nullptr && tq == 0) {
    // log2-domain max plus log2 of the sum, back to the natural log
    float* lh = lse + static_cast<size_t>(blockIdx.y) * T;
    if (row0 < T) lh[row0] = (m_run[0] + log2f(l_run[0])) * 0.6931471805599453f;
    if (row1 < T) lh[row1] = (m_run[1] + log2f(l_run[1])) * 0.6931471805599453f;
  }
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int col = n * 8 + tq * 2;
    if (row0 < T)
      *reinterpret_cast<uint32_t*>(oh + static_cast<size_t>(row0) * D + col) =
          pack_bf16(acc[n][0] * inv[0], acc[n][1] * inv[0]);
    if (row1 < T)
      *reinterpret_cast<uint32_t*>(oh + static_cast<size_t>(row1) * D + col) =
          pack_bf16(acc[n][2] * inv[1], acc[n][3] * inv[1]);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int BH, int T, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        attn_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid((T + kBQ - 1) / kBQ, BH);
  attn_fwd_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), lse,
      T, scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, o: contiguous (BH, T, D) bf16, 16-byte aligned, D in
// {64, 128, 192, 256} (the caller zero-pads other head widths and passes the
// true scale). lse: fp32 (BH, T), or null when no gradient is wanted.
// Returns cudaGetLastError() after the launch.
extern "C" int uurg_attention_fwd(const void* q, const void* k, const void* v,
                                  void* o, void* lse, int BH, int T, int D,
                                  float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  switch (D) {
    case 64: return launch<64>(q, k, v, o, l, BH, T, scale, s);
    case 128: return launch<128>(q, k, v, o, l, BH, T, scale, s);
    case 192: return launch<192>(q, k, v, o, l, BH, T, scale, s);
    case 256: return launch<256>(q, k, v, o, l, BH, T, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
