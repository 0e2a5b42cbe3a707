// GroupNorm forward over NHWC activations with fp32 statistics.
//
// Replaces: uurg_tpu/ops/group_norm.py::_gn_fwd_kernel (launched by _fwd_impl),
// with the numerics of _gn_reference: var = max(E[x^2] - mean^2, 0),
// y = x * a + b with a = rstd * scale and b = bias - mean * a, all in fp32,
// y stored in x's dtype. Per-(sample, group) mean and rstd are written too.
//
// Bound: bytes. The work is a few flops per element, so the least time is one
// read of x plus one write of y at the card's memory rate.
//
// Design: the TPU kernel keeps 8 whole samples in VMEM so x is read once; a
// sample is up to 768 KB here, over the 227 KB of shared memory a block gets.
// So one block takes one sample (B = 256 blocks on the sampling path, more
// than the 132 SMs) and reads it twice: a statistics sweep, then a normalise
// sweep whose re-read of the same sample, moments later, is meant to hit the
// 50 MB L2. Each thread owns one 16-byte column chunk (8 bf16 or 4 fp32
// channels) and walks the pixels, so loads are 16 bytes wide and a warp reads
// contiguous memory; per-channel partial sums meet in shared memory and one
// thread per group folds them.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

template <typename T> struct Chunk;

template <> struct Chunk<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float* f) {
    uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float2 t = __bfloat1622float2(h[i]);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float* f) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = u;
  }
};

template <> struct Chunk<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void load(const float* p, float* f) {
    float4 u = *reinterpret_cast<const float4*>(p);
    f[0] = u.x; f[1] = u.y; f[2] = u.z; f[3] = u.w;
  }
  static __device__ __forceinline__ void store(float* p, const float* f) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  }
};

constexpr int kMaxThreads = 512;

// grid: one block per sample; block: rows * (C / N) threads, where the
// thread's chunk is tid % (C / N) and its first pixel is tid / (C / N).
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
gn_fwd_kernel(const T* __restrict__ x, const float* __restrict__ scale,
              const float* __restrict__ bias, T* __restrict__ y,
              float* __restrict__ mean_out, float* __restrict__ rstd_out,
              int HW, int C, int G, float eps) {
  constexpr int N = Chunk<T>::N;
  extern __shared__ float smem[];
  const int nchunk = C / N;
  const int rows = blockDim.x / nchunk;
  const int cc = threadIdx.x % nchunk;
  const int r0 = threadIdx.x / nchunk;
  const size_t base = static_cast<size_t>(blockIdx.x) * HW * C + cc * N;

  float s[N], q[N];
#pragma unroll
  for (int i = 0; i < N; ++i) { s[i] = 0.f; q[i] = 0.f; }
  for (int p = r0; p < HW; p += rows) {
    float v[N];
    Chunk<T>::load(x + base + static_cast<size_t>(p) * C, v);
#pragma unroll
    for (int i = 0; i < N; ++i) { s[i] += v[i]; q[i] += v[i] * v[i]; }
  }

  float* red_s = smem;                 // [rows][C] per-thread channel sums
  float* red_q = red_s + rows * C;     // [rows][C] per-thread sums of squares
  float* g_mean = red_q + rows * C;    // [G]
  float* g_rstd = g_mean + G;          // [G]
#pragma unroll
  for (int i = 0; i < N; ++i) {
    red_s[r0 * C + cc * N + i] = s[i];
    red_q[r0 * C + cc * N + i] = q[i];
  }
  __syncthreads();

  const int cg = C / G;
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    float ss = 0.f, qq = 0.f;
    for (int r = 0; r < rows; ++r)
      for (int j = 0; j < cg; ++j) {
        ss += red_s[r * C + g * cg + j];
        qq += red_q[r * C + g * cg + j];
      }
    const float n = static_cast<float>(HW) * cg;
    const float m = ss / n;
    const float var = fmaxf(qq / n - m * m, 0.f);
    const float rs = rsqrtf(var + eps);
    g_mean[g] = m;
    g_rstd[g] = rs;
    mean_out[blockIdx.x * G + g] = m;
    rstd_out[blockIdx.x * G + g] = rs;
  }
  __syncthreads();

  float a[N], b[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int c = cc * N + i;
    const int g = c / cg;
    a[i] = g_rstd[g] * scale[c];
    b[i] = bias[c] - g_mean[g] * a[i];
  }
  for (int p = r0; p < HW; p += rows) {
    const size_t off = base + static_cast<size_t>(p) * C;
    float v[N];
    Chunk<T>::load(x + off, v);
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = v[i] * a[i] + b[i];
    Chunk<T>::store(y + off, v);
  }
}

template <typename T>
int launch(const void* x, const void* scale, const void* bias, void* y,
           void* mean, void* rstd, int B, int HW, int C, int G, float eps,
           cudaStream_t stream) {
  const int nchunk = C / Chunk<T>::N;
  int rows = kMaxThreads / nchunk;
  if (rows < 1) rows = 1;
  const int threads = rows * nchunk;
  const size_t smem = (2 * static_cast<size_t>(rows) * C + 2 * G) * sizeof(float);
  gn_fwd_kernel<T><<<B, threads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<T*>(y),
      static_cast<float*>(mean), static_cast<float*>(rstd), HW, C, G, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = bfloat16, 1 = float32. The caller guarantees contiguous NHWC x,
// 16-byte aligned pointers, C % G == 0, C % (16 / sizeof(x)) == 0 and
// C / (16 / sizeof(x)) <= 512. Returns cudaGetLastError() after the launch.
extern "C" int uurg_group_norm_fwd(const void* x, const void* scale,
                                   const void* bias, void* y, void* mean,
                                   void* rstd, int B, int HW, int C, int G,
                                   float eps, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<__nv_bfloat16>(x, scale, bias, y, mean, rstd, B, HW, C, G, eps, s);
  if (dtype == 1)
    return launch<float>(x, scale, bias, y, mean, rstd, B, HW, C, G, eps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
