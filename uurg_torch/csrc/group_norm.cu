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
// Design: the TPU kernel keeps 8 whole samples in VMEM so x is read once. A
// sample is up to 768 KB here (32 x 32 x 384 bf16), over the 227 KB of shared
// memory a block gets, but not over a thread-block cluster's: NHWC makes any
// run of a sample's whole pixels one contiguous range, so a sample is cut
// into S in {1, 2, 4, 8} such runs ("slices"), one a block of a cluster of S
// blocks (grid B S). ops/group_norm.py chooses S by shape: the smallest
// cluster whose block fits shared memory (larger slices measured faster than
// more blocks on an SM: fewer blocks pay the fold and the cluster's exchange).
// Route "slab":
//   1. the slice comes in by up to four bulk asynchronous copies
//      (cp.async.bulk, no tensor map: the range is contiguous), one lane and
//      one mbarrier each, so the sums start on the first while the rest
//      lands;
//   2. each thread owns one 16-byte column chunk (8 bf16 or 4 fp32 channels)
//      and walks the slice's pixels in shared memory (a warp reads 512
//      contiguous bytes); per-thread channel sums meet in a [rows][C] scratch
//      and are folded per channel (one thread a column), then per group: a
//      chunk may straddle groups, and no float atomics anywhere;
//   3. every block pushes its 2 G partial sums into every block's shared
//      memory (mapa + st.shared::cluster) before one cluster barrier, folds
//      the S partials in rank order, and derives mean and rstd itself, with
//      the same bits in every block and on every run; rank 0 writes them;
//   4. y = x a + b from shared memory, 16 bytes a thread, straight to device
//      memory. x came from device memory once.
// Route "split" is for a sample too large for eight slices (32 x 32 x 512
// fp32 and up: the VAE's sites, SD's widest) and for a one-pixel sample. x is
// read twice from device memory, but by enough blocks to fill the card at
// any batch: a sample is cut into S runs of whole pixels, one a block
// (grid B S), S chosen by ops/group_norm.py::_split_count from the batch
// and the sample's bytes (B S near four blocks an SM). Two launches:
//   1. statistics: each block sums its run (a thread's 16-byte column chunk
//      down the run, the loop unrolled four times), folds as the slab route does and
//      writes its 2 G group sums to an fp32 scratch part[B][S][2][G] that
//      the wrapper allocates (no float atomics, no counters);
//   2. normalise: every block folds its sample's S rows of part in one fixed
//      order (fold_runs), so every block and every run derives the same mean
//      and rstd bits; block 0 of the sample writes them; then y = x a + b
//      over the run, walked from its end, so that the first reads are the
//      tail that launch 1 read last and L2 may still hold.
//   Its floor is two reads of x and one write of y: 1.5 times the bound.
//
// Backward (replaces _gn_bwd_kernel, launched by _bwd): the Pallas kernel's
// analytic formula, with x_hat = (x - mean) * rstd from the saved fp32 mean
// and rstd and gs = g * scale:
//   dx = (gs - s1 - x_hat * s2) * rstd,  s1 = mean_group(gs),
//   s2 = mean_group(gs * x_hat),  dscale = sum g * x_hat,  dbias = sum g,
// all fp32, dx in x's dtype. Bound: bytes (read x and g once, write dx once).
// Scale is constant over a channel, so s1 and s2 are the scale-weighted group
// sums of the per-channel sums of g and g * x_hat, which are also the
// sample's dbias and dscale terms. Two routes: route "slab", as the forward's, holds a slice of x AND of g in each block of a cluster of S
// (twice the forward's bytes, so S doubles where the forward's slice was
// the limit), brought in by the same bulk copies, one barrier for both
// halves of a copy; the sums, the fold and the exchange of the 2 G group
// sums are the forward's, and dx is written from shared memory, so x and g
// come from device memory once. Route "sweep" (one block a sample, where
// the forward has split) reads x and g twice. The TPU kernel adds
// dscale and dbias across its sequential grid. Here, in the same launch, with
// no float atomics and equal bits on every run: each sample's per-channel
// sums go to an fp32 scratch row (a cluster's S blocks first hand each other
// their channels, so a sample is one row), and integer arrival counters elect
// the last block of each group of rows, which folds the group's rows in
// index order, then the last of those, which folds the group sums in order
// (arrive_row before dx, fold_batch after it).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper_mma.cuh"

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
constexpr int kSlabThreads = 256;     // ops/group_norm.py mirrors it (_SLAB_THREADS)
constexpr int kSlabChunks = 4;        // bulk copies (and barriers) a slice, at most
constexpr int kSlabChunkBytes = 16384;  // ... each at least this long
constexpr int kSplitThreads = 256;    // tests/test_torch_gn_split.py mirrors it
constexpr int kSplitUnroll = 4;       // 16-byte loads in flight a thread, split normalise

// ---- what the routes share: one source of the arithmetic ----

// this thread's channel sums into the block's [2][rows][C] scratch
template <int N>
__device__ __forceinline__ void store_partials(float* red, int rows, int C, int r0,
                                               int cc, const float* s, const float* q) {
  float4* ds = reinterpret_cast<float4*>(red + static_cast<size_t>(r0) * C + cc * N);
  float4* dq = reinterpret_cast<float4*>(red + static_cast<size_t>(rows + r0) * C + cc * N);
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
    ds[i] = make_float4(s[4 * i], s[4 * i + 1], s[4 * i + 2], s[4 * i + 3]);
    dq[i] = make_float4(q[4 * i], q[4 * i + 1], q[4 * i + 2], q[4 * i + 3]);
  }
}

// [2][rows][C] partials -> ch[2][C] (one thread a column, rows additions,
// a warp's addresses one float apart) -> grp[2][G] (one thread a group and
// sum, C / G neighbours, each weighted by w[channel] where w is given: the
// backward's scale). Per channel before per group: a 16-byte chunk may
// straddle groups (C / G = 12, or 3). Fixed order, no atomics. Begins and ends
// with a block barrier.
__device__ __forceinline__ void fold_partials(const float* red, float* ch, float* grp,
                                              int rows, int C, int G,
                                              const float* __restrict__ w = nullptr) {
  __syncthreads();
  for (int j = threadIdx.x; j < 2 * C; j += blockDim.x) {
    const int which = j / C, c = j - which * C;
    const float* col = red + static_cast<size_t>(which) * rows * C + c;
    float acc = 0.f;
#pragma unroll 8
    for (int r = 0; r < rows; ++r) acc += col[static_cast<size_t>(r) * C];
    ch[j] = acc;
  }
  __syncthreads();
  const int cg = C / G;
  for (int j = threadIdx.x; j < 2 * G; j += blockDim.x) {
    const int which = j / G, g = j - which * G;
    const float* src = ch + which * C + g * cg;
    float acc = 0.f;
    if (w) {
#pragma unroll 4
      for (int k = 0; k < cg; ++k) acc += src[k] * w[g * cg + k];
    } else {
#pragma unroll 4
      for (int k = 0; k < cg; ++k) acc += src[k];
    }
    grp[j] = acc;
  }
  __syncthreads();
}

// A block's slice of npix whole pixels (from element `first` on) of each of
// the K sources, into K slabs of maxpix pixels one after the other in shared
// memory: up to kSlabChunks bulk copies (cp.async.bulk, no tensor map: the
// range is contiguous), issued by lane k for copy k of every source at once,
// one mbarrier each, so that the sums start on the first while the rest
// lands. Copy k covers pixels [k cp, min((k + 1) cp, npix)); returns cp and
// sets *nk. The caller's block barrier makes the barriers' initialisation
// visible before anyone waits.
template <typename T, int K>
__device__ __forceinline__ int issue_slice(uint64_t* bars, T* slab, const T* const (&src)[K],
                                           size_t first, int npix, int maxpix, int C,
                                           int* nk_out) {
  using namespace hopper;
  const int slice_bytes = npix * C * static_cast<int>(sizeof(T));
  int nk = slice_bytes / kSlabChunkBytes;
  nk = nk < 1 ? 1 : (nk > kSlabChunks ? kSlabChunks : nk);
  const int cp = (npix + nk - 1) / nk;
  if (threadIdx.x < nk && threadIdx.x * cp < npix) {    // lane k: copy k
    const int c0 = threadIdx.x * cp;
    const int n = npix - c0 < cp ? npix - c0 : cp;
    const uint32_t bytes = static_cast<uint32_t>(n) * C * sizeof(T);
    const uint32_t bar = smem_u32(&bars[threadIdx.x]);
    mbar_init(bar, 1);
    mbar_init_fence();
    mbar_expect_tx(bar, K * bytes);
#pragma unroll
    for (int s = 0; s < K; ++s)
      bulk_load(smem_u32(slab + (static_cast<size_t>(s) * maxpix + c0) * C),
                src[s] + first + static_cast<size_t>(c0) * C, bytes, bar);
  }
  *nk_out = nk;
  return cp;
}

// mean and rstd of group g from the sample's sums over n values
__device__ __forceinline__ void group_stats(float ss, float qq, float n, float eps,
                                            float* mean, float* rstd) {
  const float m = ss / n;
  const float var = fmaxf(qq / n - m * m, 0.f);
  *mean = m;
  *rstd = rsqrtf(var + eps);
}

// a, b of this thread's channels: in a = scale, b = bias; stat = [mean[G], rstd[G]]
template <int N>
__device__ __forceinline__ void affine(float* a, float* b, const float* stat, int G,
                                       int cg, int cc) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int g = (cc * N + i) / cg;
    a[i] = stat[G + g] * a[i];
    b[i] = b[i] - stat[g] * a[i];
  }
}

// ---- route "split": S blocks a sample, x read twice from device memory ----
// grid: B * S blocks, block j of sample b (blockIdx.x = b S + j) takes the
// pixels [run_begin(j), run_begin(j + 1)) (S runs of HW / S or HW / S + 1
// whole pixels); block: rows * (C / N) threads,
// where the thread's chunk is tid % (C / N) and its first pixel is
// tid / (C / N) from the run's start.

// the first pixel of run j: the first HW % S runs are one pixel longer
// (32-bit arithmetic: a 64-bit division is a call, whose saved registers
// ptxas reported as spills)
__device__ __forceinline__ int run_begin(int j, int HW, int S) {
  const int q = HW / S, r = HW - q * S;
  return j * q + (j < r ? j : r);
}

// launch 1: this block's 2 G group sums of x and x^2 into part[blockIdx.x]
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
gn_fwd_split_stats(const T* __restrict__ x, float* __restrict__ part, int HW, int C,
                   int G, int S) {
  constexpr int N = Chunk<T>::N;
  extern __shared__ float smem[];
  const int nchunk = C / N;
  const int rows = blockDim.x / nchunk;
  const int cc = threadIdx.x % nchunk;
  const int r0 = threadIdx.x / nchunk;
  const int sample = blockIdx.x / S, run = blockIdx.x - sample * S;
  const int p1 = run_begin(run + 1, HW, S);
  const T* src = x + static_cast<size_t>(sample) * HW * C + cc * N;

  float s[N], q[N];
#pragma unroll
  for (int i = 0; i < N; ++i) { s[i] = 0.f; q[i] = 0.f; }
#pragma unroll 4
  for (int p = run_begin(run, HW, S) + r0; p < p1; p += rows) {
    float v[N];
    Chunk<T>::load(src + static_cast<size_t>(p) * C, v);
#pragma unroll
    for (int i = 0; i < N; ++i) { s[i] += v[i]; q[i] += v[i] * v[i]; }
  }

  float* red = smem;                   // [2][rows][C]
  float* ch = red + 2 * rows * C;      // [2][C]
  float* grp = ch + 2 * C;             // [2][G]
  store_partials<N>(red, rows, C, r0, cc, s, q);
  fold_partials(red, ch, grp, rows, C, G);
  float* dst = part + static_cast<size_t>(blockIdx.x) * 2 * G;
  for (int j = threadIdx.x; j < 2 * G; j += blockDim.x) dst[j] = grp[j];
}

// out[j] = the sum over r < S of rows[r][j], j < n, in one fixed order: lane
// u of a quad adds rows u, u + 4, ... in index order, then the quad adds its
// four sums by shuffles ((a0 + a1) + (a2 + a3): the adds commute, so every
// lane, block and run gets the same bits). Eight columns a warp at a time,
// full warps only (a block of rows * (C / N) threads may end in a part of
// one). The rows come from L2 (launch 1 wrote them).
__device__ __forceinline__ void fold_runs(const float* rows, int S, int n, float* out) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, u = lane % 4;
  const int nwarps = blockDim.x / 32;
  if (warp >= nwarps) return;
  for (int j0 = warp * 8; j0 < n; j0 += nwarps * 8) {    // uniform in a warp
    const int j = j0 + lane / 4;
    float acc = 0.f;
    if (j < n) {
#pragma unroll 8
      for (int r = u; r < S; r += 4) acc += rows[static_cast<size_t>(r) * n + j];
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    if (u == 0 && j < n) out[j] = acc;
  }
}

// launch 2: mean and rstd from the sample's S rows of part, then y over the run
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
gn_fwd_split_norm(const T* __restrict__ x, const float* __restrict__ scale,
                  const float* __restrict__ bias, const float* __restrict__ part,
                  T* __restrict__ y, float* __restrict__ mean_out,
                  float* __restrict__ rstd_out, int HW, int C, int G, int S,
                  float eps) {
  constexpr int N = Chunk<T>::N;
  extern __shared__ float smem[];
  const int nchunk = C / N;
  const int rows = blockDim.x / nchunk;
  const int cc = threadIdx.x % nchunk;
  const int r0 = threadIdx.x / nchunk;
  const int cg = C / G;
  const int sample = blockIdx.x / S, run = blockIdx.x - sample * S;

  float a[N], b[N];
#pragma unroll
  for (int i = 0; i < N; ++i) { a[i] = scale[cc * N + i]; b[i] = bias[cc * N + i]; }
  float* sums = smem;                  // [2][G]
  float* stat = sums + 2 * G;          // [2][G] mean, rstd
  fold_runs(part + static_cast<size_t>(sample) * S * 2 * G, S, 2 * G, sums);
  __syncthreads();
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    group_stats(sums[g], sums[G + g], static_cast<float>(HW) * cg, eps, &stat[g],
                &stat[G + g]);
    if (run == 0) {
      mean_out[sample * G + g] = stat[g];
      rstd_out[sample * G + g] = stat[G + g];
    }
  }
  __syncthreads();
  affine<N>(a, b, stat, G, cg, cc);

  const int p0 = run_begin(run, HW, S) + r0;
  const int p1 = run_begin(run + 1, HW, S);
  if (p0 >= p1) return;
  const size_t base = static_cast<size_t>(sample) * HW * C + cc * N;
  int k = (p1 - 1 - p0) / rows;        // this thread's last pixel: p0 + k rows
  for (; k >= kSplitUnroll - 1; k -= kSplitUnroll) {
    float v[kSplitUnroll][N];
#pragma unroll
    for (int u = 0; u < kSplitUnroll; ++u)
      Chunk<T>::load(x + base + static_cast<size_t>(p0 + (k - u) * rows) * C, v[u]);
#pragma unroll
    for (int u = 0; u < kSplitUnroll; ++u) {
#pragma unroll
      for (int i = 0; i < N; ++i) v[u][i] = v[u][i] * a[i] + b[i];
      Chunk<T>::store(y + base + static_cast<size_t>(p0 + (k - u) * rows) * C, v[u]);
    }
  }
  for (; k >= 0; --k) {
    const size_t off = base + static_cast<size_t>(p0 + k * rows) * C;
    float v[N];
    Chunk<T>::load(x + off, v);
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = v[i] * a[i] + b[i];
    Chunk<T>::store(y + off, v);
  }
}

// ---- route "slab": a cluster of S blocks a sample, x read once ----
// grid: B * S blocks in clusters of S; block rank r of a cluster takes pixels
// [r HW / S, (r + 1) HW / S) of sample blockIdx.x / S. Threads as above.
// Dynamic shared memory: the slice, then red, ch, grp, stat as above, then
// part[S][2][G], into which every block of the cluster writes its grp.
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
gn_fwd_slab_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                   const float* __restrict__ bias, T* __restrict__ y,
                   float* __restrict__ mean_out, float* __restrict__ rstd_out,
                   int HW, int C, int G, float eps, int S) {
  using namespace hopper;
  constexpr int N = Chunk<T>::N;
  extern __shared__ __align__(128) unsigned char slab_smem[];
  __shared__ __align__(8) uint64_t bars[kSlabChunks];
  const int nchunk = C / N;
  const int rows = blockDim.x / nchunk;
  const int cc = threadIdx.x % nchunk;
  const int r0 = threadIdx.x / nchunk;
  const int cg = C / G;
  const int rank = S > 1 ? static_cast<int>(cluster_rank()) : 0;
  const int sample = blockIdx.x / S;
  const int p0 = rank * HW / S;
  const int npix = (rank + 1) * HW / S - p0;
  const int maxpix = (HW + S - 1) / S;
  const size_t first = (static_cast<size_t>(sample) * HW + p0) * C;

  // arrive at once: when a peer's wait below returns, this block runs and
  // its shared memory may be written
  if (S > 1) cluster_arrive();

  T* slab = reinterpret_cast<T*>(slab_smem);
  float* red = reinterpret_cast<float*>(slab_smem + static_cast<size_t>(maxpix) * C * sizeof(T));
  float* ch = red + 2 * rows * C;
  float* grp = ch + 2 * C;
  float* stat = grp + 2 * G;
  float* part = stat + 2 * G;

  const T* const srcs[1] = {x};
  int nk;
  const int cp = issue_slice<T, 1>(bars, slab, srcs, first, npix, maxpix, C, &nk);
  float a[N], b[N];
#pragma unroll
  for (int i = 0; i < N; ++i) { a[i] = scale[cc * N + i]; b[i] = bias[cc * N + i]; }
  __syncthreads();                     // the barriers are initialised

  float s[N], q[N];
#pragma unroll
  for (int i = 0; i < N; ++i) { s[i] = 0.f; q[i] = 0.f; }
  const T* mine = slab + cc * N;
  for (int k = 0; k < nk; ++k) {
    const int c0 = k * cp;
    if (c0 >= npix) break;
    const int c1 = npix - c0 < cp ? npix : c0 + cp;
    mbar_wait(smem_u32(&bars[k]), 0);
#pragma unroll 4
    for (int p = c0 + r0; p < c1; p += rows) {
      float v[N];
      Chunk<T>::load(mine + static_cast<size_t>(p) * C, v);
#pragma unroll
      for (int i = 0; i < N; ++i) { s[i] += v[i]; q[i] += v[i] * v[i]; }
    }
  }
  store_partials<N>(red, rows, C, r0, cc, s, q);
  fold_partials(red, ch, grp, rows, C, G);

  if (S > 1) {
    // push this block's 2 G sums into every block's part[rank], then one
    // cluster barrier: no block reads a peer's memory afterwards
    cluster_wait();
    for (int j = threadIdx.x; j < 2 * G * S; j += blockDim.x) {
      const int to = j / (2 * G), e = j - to * 2 * G;
      cluster_store(cluster_map(smem_u32(part + rank * 2 * G + e), to), grp[e]);
    }
    cluster_arrive();
    cluster_wait();
  }
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    float ss = grp[g], qq = grp[G + g];
    if (S > 1) {                       // in rank order: equal bits in every block and run
      ss = 0.f;
      qq = 0.f;
      for (int r = 0; r < S; ++r) { ss += part[r * 2 * G + g]; qq += part[r * 2 * G + G + g]; }
    }
    group_stats(ss, qq, static_cast<float>(HW) * cg, eps, &stat[g], &stat[G + g]);
    if (rank == 0) {
      mean_out[sample * G + g] = stat[g];
      rstd_out[sample * G + g] = stat[G + g];
    }
  }
  __syncthreads();

  affine<N>(a, b, stat, G, cg, cc);
  T* out = y + first + cc * N;
#pragma unroll 4
  for (int p = r0; p < npix; p += rows) {
    float v[N];
    Chunk<T>::load(mine + static_cast<size_t>(p) * C, v);
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = v[i] * a[i] + b[i];
    Chunk<T>::store(out + static_cast<size_t>(p) * C, v);
  }
}

inline size_t stats_floats(int rows, int C, int G) {
  return 2 * static_cast<size_t>(rows) * C + 2 * C + 4 * G;
}

template <typename T>
int launch_split(const void* x, const void* scale, const void* bias, void* y,
                 void* mean, void* rstd, void* part, int B, int HW, int C, int G,
                 float eps, int S, cudaStream_t stream) {
  if (S < 1 || S > HW || part == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int nchunk = C / Chunk<T>::N;
  int rows = kSplitThreads / nchunk;
  if (rows < 1) rows = 1;
  const int threads = rows * nchunk;
  const unsigned blocks = static_cast<unsigned>(B) * S;
  const size_t smem = (2 * static_cast<size_t>(rows) * C + 2 * C + 2 * G) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      gn_fwd_split_stats<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  float* pf = static_cast<float*>(part);
  gn_fwd_split_stats<T><<<blocks, threads, smem, stream>>>(static_cast<const T*>(x), pf,
                                                           HW, C, G, S);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  gn_fwd_split_norm<T><<<blocks, threads, 4 * G * sizeof(float), stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(scale),
      static_cast<const float*>(bias), pf, static_cast<T*>(y),
      static_cast<float*>(mean), static_cast<float*>(rstd), HW, C, G, S, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_slab(const void* x, const void* scale, const void* bias, void* y,
                void* mean, void* rstd, int B, int HW, int C, int G, float eps,
                int S, cudaStream_t stream) {
  if (S < 1 || S > 8 || S > HW) return static_cast<int>(cudaErrorInvalidValue);
  const int nchunk = C / Chunk<T>::N;
  const int maxpix = (HW + S - 1) / S;
  int rows = kSlabThreads / nchunk;
  if (rows > maxpix) rows = maxpix;
  if (rows < 1) rows = 1;
  const size_t smem = static_cast<size_t>(maxpix) * C * sizeof(T) +
                      (stats_floats(rows, C, G) + (S > 1 ? 2 * G * S : 0)) * sizeof(float);
  // at every call: a launch from another thread was refused when only an
  // earlier call had set it
  cudaError_t err = cudaFuncSetAttribute(
      gn_fwd_slab_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(B) * S);
  config.blockDim = dim3(rows * nchunk);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = S > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&config, gn_fwd_slab_kernel<T>, static_cast<const T*>(x),
                           static_cast<const float*>(scale),
                           static_cast<const float*>(bias), static_cast<T*>(y),
                           static_cast<float*>(mean), static_cast<float*>(rstd), HW, C,
                           G, eps, S);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* x, const void* scale, const void* bias, void* y,
           void* mean, void* rstd, void* part, int B, int HW, int C, int G, float eps,
           int route, int cluster, cudaStream_t stream) {
  if (route == 0)
    return launch_split<T>(x, scale, bias, y, mean, rstd, part, B, HW, C, G, eps,
                           cluster, stream);
  if (route == 1)
    return launch_slab<T>(x, scale, bias, y, mean, rstd, B, HW, C, G, eps, cluster,
                          stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// ---- the backward's batch fold of dscale and dbias, in the same launch ----

// Thread 0 arrives on the integer counter `ctr`; true in every thread of the
// block that arrived n-th of n. The fences order each thread's earlier
// writes before the arrival and the elected block's later reads after it.
// The elected block sets the counter back to 0: no other block of the launch
// touches it again, so the next launch (or a CUDA graph's replay) finds it
// zero. That assumes the launches sharing the counters run one at a time,
// on one stream.
__device__ __forceinline__ bool elect_last(unsigned* ctr, unsigned n, int* flag) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const bool last = atomicAdd(ctr, 1u) == n - 1;
    if (last) atomicExch(ctr, 0u);
    *flag = last;
  }
  __syncthreads();
  const bool last = *flag != 0;
  if (last) __threadfence();
  return last;
}

// dst[j] = sum over r in index order of src[r][j], j < ncols (a multiple of
// 4), 16 bytes a thread; the rows come from L2 (other blocks wrote them)
__device__ __forceinline__ void sum_rows(const float* src, int nrows, int ncols,
                                         float* dst) {
  const int n4 = ncols / 4;
  const float4* s = reinterpret_cast<const float4*>(src);
  for (int j = threadIdx.x; j < n4; j += blockDim.x) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
    for (int r = 0; r < nrows; ++r) {
      const float4 v = __ldcg(s + static_cast<size_t>(r) * n4 + j);
      acc.x += v.x; acc.y += v.y; acc.z += v.z; acc.w += v.w;
    }
    reinterpret_cast<float4*>(dst)[j] = acc;
  }
}

// The arrival of a block whose part of sample `sample`'s row part[sample] =
// [sum g x_hat (C) | sum g (C)] is written: thread 0 fences and adds one
// to the counter of the sample's group (the caller's block barrier before
// it orders the other threads' writes before that fence, as in a grid
// barrier) and gets the old count back, which nothing reads until
// fold_batch: the block goes on to dx while the atomic is in flight. (A
// warp of its own for the arrival, whose fence then stalls no dx, measured
// slower.)
__device__ __forceinline__ unsigned arrive_row(unsigned* counters, int fold, int sample) {
  unsigned old = 0;
  if (threadIdx.x == 0) {
    __threadfence();
    old = atomicAdd(&counters[1 + sample / fold], 1u);
  }
  return old;
}

// Called last by every block with arrive_row's result, `arrivals` blocks a
// sample. Rows fold in groups of `fold` samples: the block whose arrival
// completed its group adds the group's rows in index order into
// gpart[group] (with one group, straight into out) and resets the group's
// counter; counter 0 then elects the last of those, which adds gpart's rows
// in order into out = [dscale | dbias]. Equal bits whatever order the
// blocks run in; the tail after the last block's dx is two short serial
// chains (fold + B / fold rows) instead of one of B rows.
__device__ __forceinline__ void fold_batch(unsigned old, const float* part, float* gpart,
                                           float* out, unsigned* counters, int B,
                                           int C, int fold, int sample, int arrivals) {
  __shared__ int flag;
  const int ngroups = (B + fold - 1) / fold;
  const int group = sample / fold;
  const int r0 = group * fold;
  const int r1 = B < r0 + fold ? B : r0 + fold;
  if (threadIdx.x == 0) {
    const bool last = old == static_cast<unsigned>((r1 - r0) * arrivals) - 1;
    if (last) atomicExch(&counters[1 + group], 0u);
    flag = last;
  }
  __syncthreads();
  if (!flag) return;
  __threadfence();
  if (ngroups == 1) {
    sum_rows(part, B, 2 * C, out);
    return;
  }
  sum_rows(part + static_cast<size_t>(r0) * 2 * C, r1 - r0, 2 * C,
           gpart + static_cast<size_t>(group) * 2 * C);
  if (!elect_last(&counters[0], static_cast<unsigned>(ngroups), &flag)) return;
  sum_rows(gpart, ngroups, 2 * C, out);
}

// this thread's mean and rstd, a channel each
template <int N>
__device__ __forceinline__ void channel_stats(float* m, float* rs, const float* mean,
                                              const float* rstd, int sample, int G,
                                              int cg, int cc) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int grp = (cc * N + i) / cg;
    m[i] = mean[sample * G + grp];
    rs[i] = rstd[sample * G + grp];
  }
}

// sums of g and g * x_hat over a chunk's channels
template <int N>
__device__ __forceinline__ void add_bwd_sums(const float* xv, const float* gv,
                                             const float* m, const float* rs,
                                             float* sa, float* sb) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    sa[i] += gv[i];
    sb[i] += gv[i] * ((xv[i] - m[i]) * rs[i]);
  }
}

// the chunk's dx, into xv
template <int N>
__device__ __forceinline__ void bwd_dx(float* xv, const float* gv, const float* m,
                                       const float* rs, const float* sc,
                                       const float* s1, const float* s2) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float xh = (xv[i] - m[i]) * rs[i];
    xv[i] = (gv[i] * sc[i] - s1[i] - xh * s2[i]) * rs[i];
  }
}

// scale, s1 and s2 of this thread's channels; s = [s2[G], s1[G]]
template <int N>
__device__ __forceinline__ void dx_terms(float* sc, float* s1, float* s2,
                                         const float* scale, const float* s, int G,
                                         int cg, int cc) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int c = cc * N + i;
    sc[i] = scale[c];
    s2[i] = s[c / cg];
    s1[i] = s[G + c / cg];
  }
}

// work = [dscale (C) | dbias (C) | part (B, 2, C) | gpart (groups, 2, C)]
__device__ __forceinline__ float* part_rows(float* work, int C) { return work + 2 * C; }

// ---- backward route "sweep": one block a sample, x and g read twice ----
// grid: one block per sample; block: rows * (C / N) threads with rows =
// kMaxThreads / (C / N), the thread's chunk tid % (C / N) and its first
// pixel tid / (C / N).
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
gn_bwd_sweep_kernel(const T* __restrict__ x, const T* __restrict__ g,
                    const float* __restrict__ scale, const float* __restrict__ mean,
                    const float* __restrict__ rstd, T* __restrict__ dx,
                    float* __restrict__ work, unsigned* __restrict__ counters, int B,
                    int HW, int C, int G, int fold) {
  constexpr int N = Chunk<T>::N;
  extern __shared__ float smem[];
  const int nchunk = C / N;
  const int rows = blockDim.x / nchunk;
  const int cc = threadIdx.x % nchunk;
  const int r0 = threadIdx.x / nchunk;
  const int cg = C / G;
  const int sample = blockIdx.x;
  const size_t base = static_cast<size_t>(sample) * HW * C + cc * N;

  float m[N], rs[N], sa[N], sb[N];
  channel_stats<N>(m, rs, mean, rstd, sample, G, cg, cc);
#pragma unroll
  for (int i = 0; i < N; ++i) { sa[i] = 0.f; sb[i] = 0.f; }
  for (int p = r0; p < HW; p += rows) {
    const size_t off = base + static_cast<size_t>(p) * C;
    float xv[N], gv[N];
    Chunk<T>::load(x + off, xv);
    Chunk<T>::load(g + off, gv);
    add_bwd_sums<N>(xv, gv, m, rs, sa, sb);
  }

  float* red = smem;                   // [2][rows][C]
  float* ch = red + 2 * rows * C;      // [2][C] sum g x_hat, sum g
  float* grp = ch + 2 * C;             // [2][G] scale-weighted, then s2, s1
  store_partials<N>(red, rows, C, r0, cc, sb, sa);
  fold_partials(red, ch, grp, rows, C, G, scale);
  float* part = part_rows(work, C);
  for (int j = threadIdx.x; j < 2 * C; j += blockDim.x)
    part[static_cast<size_t>(sample) * 2 * C + j] = ch[j];
  const float inv_n = 1.f / (static_cast<float>(HW) * cg);
  for (int j = threadIdx.x; j < 2 * G; j += blockDim.x) grp[j] *= inv_n;
  __syncthreads();
  const unsigned old = arrive_row(counters, fold, sample);

  float sc[N], s1[N], s2[N];
  dx_terms<N>(sc, s1, s2, scale, grp, G, cg, cc);
  for (int p = r0; p < HW; p += rows) {
    const size_t off = base + static_cast<size_t>(p) * C;
    float xv[N], gv[N];
    Chunk<T>::load(x + off, xv);
    Chunk<T>::load(g + off, gv);
    bwd_dx<N>(xv, gv, m, rs, sc, s1, s2);
    Chunk<T>::store(dx + off, xv);
  }
  fold_batch(old, part, part + static_cast<size_t>(B) * 2 * C, work, counters, B, C,
             fold, sample, 1);
}

// ---- backward route "slab": a cluster of S blocks a sample, x and g read once ----
// grid: B * S blocks in clusters of S, pixels and threads as the forward's
// slab route. Dynamic shared memory: the slices of x and of g, then red[2][rows][C],
// ch[2][C], grp[2][G], and with S > 1 xchg[S][2][G] (every rank's grp) and
// recv[S][2][cw]: every rank's ch at the cw channels whose batch sums this
// rank collects, [rank cw, min((rank + 1) cw, C)).
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
gn_bwd_slab_kernel(const T* __restrict__ x, const T* __restrict__ g,
                   const float* __restrict__ scale, const float* __restrict__ mean,
                   const float* __restrict__ rstd, T* __restrict__ dx,
                   float* __restrict__ work, unsigned* __restrict__ counters, int B,
                   int HW, int C, int G, int fold, int S) {
  using namespace hopper;
  constexpr int N = Chunk<T>::N;
  extern __shared__ __align__(128) unsigned char slab_smem[];
  __shared__ __align__(8) uint64_t bars[kSlabChunks];
  const int nchunk = C / N;
  const int rows = blockDim.x / nchunk;
  const int cc = threadIdx.x % nchunk;
  const int r0 = threadIdx.x / nchunk;
  const int cg = C / G;
  const int rank = S > 1 ? static_cast<int>(cluster_rank()) : 0;
  const int sample = blockIdx.x / S;
  const int p0 = rank * HW / S;
  const int npix = (rank + 1) * HW / S - p0;
  const int maxpix = (HW + S - 1) / S;
  const int cw = (C + S - 1) / S;
  const size_t first = (static_cast<size_t>(sample) * HW + p0) * C;

  // arrive at once: when a peer's wait below returns, this block runs and
  // its shared memory may be written
  if (S > 1) cluster_arrive();

  T* slab = reinterpret_cast<T*>(slab_smem);     // x, then g
  float* red = reinterpret_cast<float*>(slab_smem + 2 * static_cast<size_t>(maxpix) *
                                                        C * sizeof(T));
  float* ch = red + 2 * rows * C;
  float* grp = ch + 2 * C;
  float* xchg = grp + 2 * G;
  float* recv = xchg + 2 * G * S;

  const T* const srcs[2] = {x, g};
  int nk;
  const int cp = issue_slice<T, 2>(bars, slab, srcs, first, npix, maxpix, C, &nk);
  float m[N], rs[N], sa[N], sb[N];
  channel_stats<N>(m, rs, mean, rstd, sample, G, cg, cc);
#pragma unroll
  for (int i = 0; i < N; ++i) { sa[i] = 0.f; sb[i] = 0.f; }
  __syncthreads();                     // the barriers are initialised

  const T* xm = slab + cc * N;
  const T* gm = xm + static_cast<size_t>(maxpix) * C;
  for (int k = 0; k < nk; ++k) {
    const int c0 = k * cp;
    if (c0 >= npix) break;
    const int c1 = npix - c0 < cp ? npix : c0 + cp;
    mbar_wait(smem_u32(&bars[k]), 0);
#pragma unroll 4
    for (int p = c0 + r0; p < c1; p += rows) {
      float xv[N], gv[N];
      Chunk<T>::load(xm + static_cast<size_t>(p) * C, xv);
      Chunk<T>::load(gm + static_cast<size_t>(p) * C, gv);
      add_bwd_sums<N>(xv, gv, m, rs, sa, sb);
    }
  }
  store_partials<N>(red, rows, C, r0, cc, sb, sa);
  fold_partials(red, ch, grp, rows, C, G, scale);

  float* part = part_rows(work, C);
  float* row = part + static_cast<size_t>(sample) * 2 * C;
  if (S > 1) {
    // push grp into every block's xchg[rank], and this slice's channel sums
    // into recv[rank] of the block that collects them; then one cluster
    // barrier: no block touches a peer's memory afterwards
    cluster_wait();
    for (int j = threadIdx.x; j < 2 * G * S; j += blockDim.x) {
      const int to = j / (2 * G), e = j - to * 2 * G;
      cluster_store(cluster_map(smem_u32(xchg + rank * 2 * G + e), to), grp[e]);
    }
    for (int j = threadIdx.x; j < 2 * C; j += blockDim.x) {
      const int which = j / C, c = j - which * C, to = c / cw;
      cluster_store(cluster_map(smem_u32(recv + (rank * 2 + which) * cw + c - to * cw), to),
                    ch[j]);
    }
    cluster_arrive();
    cluster_wait();
    // this rank's channels of the sample's row, the ranks added in order
    const int lo = rank * cw, n = C - lo < cw ? C - lo : cw;
    for (int j = threadIdx.x; j < 2 * cw; j += blockDim.x) {
      const int which = j / cw, k = j - which * cw;
      if (k >= n) continue;
      float acc = 0.f;
      for (int r = 0; r < S; ++r) acc += recv[(r * 2 + which) * cw + k];
      row[which * C + lo + k] = acc;
    }
  } else {
    for (int j = threadIdx.x; j < 2 * C; j += blockDim.x) row[j] = ch[j];
  }
  // s2, s1: the group sums over the sample, the ranks added in order (equal
  // bits in every block and run), over n values
  const float inv_n = 1.f / (static_cast<float>(HW) * cg);
  for (int j = threadIdx.x; j < 2 * G; j += blockDim.x) {
    float acc = grp[j];
    if (S > 1) {
      acc = 0.f;
      for (int r = 0; r < S; ++r) acc += xchg[r * 2 * G + j];
    }
    grp[j] = acc * inv_n;
  }
  __syncthreads();
  const unsigned old = arrive_row(counters, fold, sample);

  float sc[N], s1[N], s2[N];
  dx_terms<N>(sc, s1, s2, scale, grp, G, cg, cc);
  T* out = dx + first + cc * N;
#pragma unroll 4
  for (int p = r0; p < npix; p += rows) {
    float xv[N], gv[N];
    Chunk<T>::load(xm + static_cast<size_t>(p) * C, xv);
    Chunk<T>::load(gm + static_cast<size_t>(p) * C, gv);
    bwd_dx<N>(xv, gv, m, rs, sc, s1, s2);
    Chunk<T>::store(out + static_cast<size_t>(p) * C, xv);
  }
  fold_batch(old, part, part + static_cast<size_t>(B) * 2 * C, work, counters, B, C,
             fold, sample, S);
}

template <typename T>
int launch_bwd(const void* x, const void* g, const void* scale, const void* mean,
               const void* rstd, void* dx, void* work, void* counters, int B, int HW,
               int C, int G, int fold, int route, int S, cudaStream_t stream) {
  const int nchunk = C / Chunk<T>::N;
  const T* xt = static_cast<const T*>(x);
  const T* gt = static_cast<const T*>(g);
  const float* sc = static_cast<const float*>(scale);
  const float* mn = static_cast<const float*>(mean);
  const float* rs = static_cast<const float*>(rstd);
  T* dxt = static_cast<T*>(dx);
  float* wk = static_cast<float*>(work);
  unsigned* ctr = static_cast<unsigned*>(counters);
  if (fold < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (route == 0) {
    int rows = kMaxThreads / nchunk;
    if (rows < 1) rows = 1;
    const size_t smem = (2 * static_cast<size_t>(rows) * C + 2 * C + 2 * G) * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        gn_bwd_sweep_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    gn_bwd_sweep_kernel<T><<<B, rows * nchunk, smem, stream>>>(
        xt, gt, sc, mn, rs, dxt, wk, ctr, B, HW, C, G, fold);
    return static_cast<int>(cudaGetLastError());
  }
  if (route != 1 || S < 1 || S > 8 || S > HW)
    return static_cast<int>(cudaErrorInvalidValue);
  const int maxpix = (HW + S - 1) / S;
  int rows = kSlabThreads / nchunk;
  if (rows > maxpix) rows = maxpix;
  if (rows < 1) rows = 1;
  const int cw = (C + S - 1) / S;
  const size_t smem = 2 * static_cast<size_t>(maxpix) * C * sizeof(T) +
                      (2 * static_cast<size_t>(rows) * C + 2 * C + 2 * G +
                       (S > 1 ? 2 * G * S + 2 * cw * S : 0)) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      gn_bwd_slab_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(B) * S);
  config.blockDim = dim3(rows * nchunk);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = S > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&config, gn_bwd_slab_kernel<T>, xt, gt, sc, mn, rs, dxt, wk,
                           ctr, B, HW, C, G, fold, S);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = bfloat16, 1 = float32. route: 0 = split, two launches on
// B * cluster blocks (cluster = S runs a sample, 1 <= S <= HW; part: fp32
// scratch of B * S * 2 * G floats that the caller allocates and no other
// launch in flight shares), 1 = slab with clusters of `cluster` blocks (1, 2,
// 4 or 8, at most HW; part unused); the caller chooses the route by shape so
// that a slab's slice and scratch fit a block's shared memory. The caller
// guarantees contiguous NHWC x, 16-byte aligned pointers, C % G == 0,
// C % (16 / sizeof(x)) == 0 and C / (16 / sizeof(x)) <= 512. Returns the
// launch's CUDA error code (0 = launched); nothing falls back.
extern "C" int uurg_group_norm_fwd(const void* x, const void* scale,
                                   const void* bias, void* y, void* mean,
                                   void* rstd, void* part, int B, int HW, int C,
                                   int G, float eps, int dtype, int route,
                                   int cluster, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<__nv_bfloat16>(x, scale, bias, y, mean, rstd, part, B, HW, C, G,
                                 eps, route, cluster, s);
  if (dtype == 1)
    return launch<float>(x, scale, bias, y, mean, rstd, part, B, HW, C, G, eps,
                         route, cluster, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Backward, one launch. x, g, dx: contiguous NHWC of one dtype (0 =
// bfloat16, 1 = float32), with the forward's constraints on C; scale: fp32
// (C,); mean, rstd: the forward's fp32 (B, G); work: fp32, 16-byte aligned,
// (2 + 2 B + 2 ceil(B / fold)) C floats, of which the first 2 C are written
// as dscale then dbias and the rest is scratch; counters: uint32, at least
// 1 + ceil(B / fold), zero on entry and left zero (the launches that share
// them must run one at a time). route: 0 = sweep, 1 = slab with clusters of
// `cluster` blocks, chosen by the caller by shape as for the forward.
// Returns the launch's CUDA error code (0 = launched); nothing falls back.
extern "C" int uurg_group_norm_bwd(const void* x, const void* g, const void* scale,
                                   const void* mean, const void* rstd, void* dx,
                                   void* work, void* counters, int B, int HW, int C,
                                   int G, int fold, int dtype, int route, int cluster,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_bwd<__nv_bfloat16>(x, g, scale, mean, rstd, dx, work, counters, B, HW,
                                     C, G, fold, route, cluster, s);
  if (dtype == 1)
    return launch_bwd<float>(x, g, scale, mean, rstd, dx, work, counters, B, HW, C, G,
                             fold, route, cluster, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

namespace {
__global__ void empty_kernel() {}
}  // namespace

// A kernel that does nothing, for scripts/profile_torch_group_norm.py: its
// time in a replayed CUDA graph is the floor under every small launch.
extern "C" int uurg_empty_launch(int blocks, int threads, void* stream) {
  empty_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
