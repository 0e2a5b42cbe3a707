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
//
// Backward (replaces _gn_bwd_kernel, launched by _bwd): the Pallas kernel's
// analytic formula, with x_hat = (x - mean) * rstd from the saved fp32 mean
// and rstd and gs = g * scale:
//   dx = (gs - s1 - x_hat * s2) * rstd,  s1 = mean_group(gs),
//   s2 = mean_group(gs * x_hat),  dscale = sum g * x_hat,  dbias = sum g,
// all fp32, dx in x's dtype. Bound: bytes (read x and g, write dx). The same
// block layout as the forward: sweep 1 reads x and g and sums g and g * x_hat
// per channel (scale is constant over a channel, so s1 and s2 are the
// scale-weighted group sums of those two, and they are also the sample's
// dbias and dscale terms); sweep 2 re-reads both and writes dx. The TPU
// kernel adds dscale and dbias across its sequential grid; here each block
// writes its sample's (C,) partials and a second small launch sums them over
// the batch in a fixed order, so the result does not depend on block order
// and needs no atomics.
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

// grid: one block per sample; block and shared memory as the forward.
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
gn_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g,
              const float* __restrict__ scale, const float* __restrict__ mean,
              const float* __restrict__ rstd, T* __restrict__ dx,
              float* __restrict__ dscale_part, float* __restrict__ dbias_part,
              int HW, int C, int G) {
  constexpr int N = Chunk<T>::N;
  extern __shared__ float smem[];
  const int nchunk = C / N;
  const int rows = blockDim.x / nchunk;
  const int cc = threadIdx.x % nchunk;
  const int r0 = threadIdx.x / nchunk;
  const int cg = C / G;
  const size_t base = static_cast<size_t>(blockIdx.x) * HW * C + cc * N;

  float m[N], rs[N], sa[N], sb[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int grp = (cc * N + i) / cg;
    m[i] = mean[blockIdx.x * G + grp];
    rs[i] = rstd[blockIdx.x * G + grp];
    sa[i] = 0.f;
    sb[i] = 0.f;
  }
  for (int p = r0; p < HW; p += rows) {
    const size_t off = base + static_cast<size_t>(p) * C;
    float xv[N], gv[N];
    Chunk<T>::load(x + off, xv);
    Chunk<T>::load(g + off, gv);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      sa[i] += gv[i];
      sb[i] += gv[i] * ((xv[i] - m[i]) * rs[i]);
    }
  }

  float* red_a = smem;                 // [rows][C] per-thread sums of g
  float* red_b = red_a + rows * C;     // [rows][C] per-thread sums of g * x_hat
  float* ch_a = red_b + rows * C;      // [C] scale * sum g
  float* ch_b = ch_a + C;              // [C] scale * sum g * x_hat
  float* g_s1 = ch_b + C;              // [G]
  float* g_s2 = g_s1 + G;              // [G]
#pragma unroll
  for (int i = 0; i < N; ++i) {
    red_a[r0 * C + cc * N + i] = sa[i];
    red_b[r0 * C + cc * N + i] = sb[i];
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float a = 0.f, b = 0.f;
    for (int r = 0; r < rows; ++r) {
      a += red_a[r * C + c];
      b += red_b[r * C + c];
    }
    dbias_part[static_cast<size_t>(blockIdx.x) * C + c] = a;
    dscale_part[static_cast<size_t>(blockIdx.x) * C + c] = b;
    ch_a[c] = scale[c] * a;
    ch_b[c] = scale[c] * b;
  }
  __syncthreads();
  const float inv_n = 1.f / (static_cast<float>(HW) * cg);
  for (int grp = threadIdx.x; grp < G; grp += blockDim.x) {
    float a = 0.f, b = 0.f;
    for (int j = 0; j < cg; ++j) {
      a += ch_a[grp * cg + j];
      b += ch_b[grp * cg + j];
    }
    g_s1[grp] = a * inv_n;
    g_s2[grp] = b * inv_n;
  }
  __syncthreads();

  float sc[N], s1[N], s2[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int c = cc * N + i;
    sc[i] = scale[c];
    s1[i] = g_s1[c / cg];
    s2[i] = g_s2[c / cg];
  }
  for (int p = r0; p < HW; p += rows) {
    const size_t off = base + static_cast<size_t>(p) * C;
    float xv[N], gv[N];
    Chunk<T>::load(x + off, xv);
    Chunk<T>::load(g + off, gv);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const float xh = (xv[i] - m[i]) * rs[i];
      xv[i] = (gv[i] * sc[i] - s1[i] - xh * s2[i]) * rs[i];
    }
    Chunk<T>::store(dx + off, xv);
  }
}

// grid: ceil(C / 256); block: 256. out[c] = sum over b in order of part[b][c].
__global__ void gn_bwd_reduce_kernel(const float* __restrict__ dscale_part,
                                     const float* __restrict__ dbias_part,
                                     float* __restrict__ dscale,
                                     float* __restrict__ dbias, int B, int C) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  float a = 0.f, b = 0.f;
  for (int i = 0; i < B; ++i) {
    a += dscale_part[static_cast<size_t>(i) * C + c];
    b += dbias_part[static_cast<size_t>(i) * C + c];
  }
  dscale[c] = a;
  dbias[c] = b;
}

template <typename T>
int launch_bwd(const void* x, const void* g, const void* scale,
               const void* mean, const void* rstd, void* dx, void* dscale_part,
               void* dbias_part, void* dscale, void* dbias, int B, int HW,
               int C, int G, cudaStream_t stream) {
  const int nchunk = C / Chunk<T>::N;
  int rows = kMaxThreads / nchunk;
  if (rows < 1) rows = 1;
  const int threads = rows * nchunk;
  const size_t smem =
      (2 * static_cast<size_t>(rows) * C + 2 * C + 2 * G) * sizeof(float);
  gn_bwd_kernel<T><<<B, threads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g),
      static_cast<const float*>(scale), static_cast<const float*>(mean),
      static_cast<const float*>(rstd), static_cast<T*>(dx),
      static_cast<float*>(dscale_part), static_cast<float*>(dbias_part), HW,
      C, G);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  gn_bwd_reduce_kernel<<<(C + 255) / 256, 256, 0, stream>>>(
      static_cast<const float*>(dscale_part),
      static_cast<const float*>(dbias_part), static_cast<float*>(dscale),
      static_cast<float*>(dbias), B, C);
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

// Backward. x, g, dx: contiguous NHWC of one dtype (0 = bfloat16,
// 1 = float32), with the forward's constraints on C; scale: fp32 (C,);
// mean, rstd: the forward's fp32 (B, G); dscale_part, dbias_part: fp32 (B, C)
// scratch; dscale, dbias: fp32 (C,). Launches two kernels on the stream and
// returns the first launch error, or cudaGetLastError() after the last one.
extern "C" int uurg_group_norm_bwd(const void* x, const void* g,
                                   const void* scale, const void* mean,
                                   const void* rstd, void* dx,
                                   void* dscale_part, void* dbias_part,
                                   void* dscale, void* dbias, int B, int HW,
                                   int C, int G, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_bwd<__nv_bfloat16>(x, g, scale, mean, rstd, dx, dscale_part,
                                     dbias_part, dscale, dbias, B, HW, C, G, s);
  if (dtype == 1)
    return launch_bwd<float>(x, g, scale, mean, rstd, dx, dscale_part,
                             dbias_part, dscale, dbias, B, HW, C, G, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
