#!/usr/bin/env python3
"""The rate of ``mma.sync.aligned.m16n8k8`` TF32 products on one GPU: the
instruction the ``xwide`` float32 attention forward runs its three-TF32
products on, measured alone.

    python3 scripts/bench_mma_tf32_rate.py

Builds a small CUDA program with nvcc (sm_90a) into a temporary directory
and runs it: 132 blocks, each warp issuing chains of independent products
on registers (no memory traffic), at several chain counts and block sizes;
prints ms and TFLOP/s of each (2 * 16 * 8 * 8 operations a product), then
the card's name and power limit. Needs a CUDA GPU and nvcc (~10 s).
"""
from __future__ import annotations

import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// CH independent accumulator chains a warp, iters products on each
template <int CH>
__global__ void chains(float* out, int iters) {
  uint32_t a[4] = {threadIdx.x, threadIdx.x * 3u, 7u, 9u};
  float c[CH][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < CH; ++j) mma_tf32(c[j], a, a[0] + j, a[1]);
  }
  float s = 0;
  for (int j = 0; j < CH; ++j) s += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

template <int CH>
void run(int threads, float* out) {
  const int iters = 4096;
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  chains<CH><<<132, threads>>>(out, 16);
  cudaEventRecord(a);
  chains<CH><<<132, threads>>>(out, iters);
  cudaEventRecord(b);
  cudaEventSynchronize(b);
  float ms;
  cudaEventElapsedTime(&ms, a, b);
  const double flops = 132.0 * threads / 32 * iters * CH * 2.0 * 16 * 8 * 8;
  printf("chains %d threads %d: %.3f ms, %.1f TFLOP/s tf32 mma.sync\n", CH,
         threads, ms, flops / ms / 1e9);
}

int main() {
  float* out;
  cudaMalloc(&out, 132 * 1024 * 4);
  run<4>(512, out);
  run<8>(512, out);
  run<16>(512, out);
  run<8>(1024, out);
  run<4>(128, out);
  run<16>(256, out);
  const cudaError_t err = cudaDeviceSynchronize();
  printf("CUDA: %s\n", cudaGetErrorString(err));
  return err == cudaSuccess ? 0 : 1;
}
"""


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from uurg_torch.ops import _build

    with tempfile.TemporaryDirectory(prefix="uurg_mma_rate_") as tmp:
        src, exe = os.path.join(tmp, "mma_rate.cu"), os.path.join(tmp, "mma")
        with open(src, "w") as f:
            f.write(SOURCE)
        subprocess.run([_build._nvcc(), "-gencode",
                        "arch=compute_90a,code=sm_90a", "-O3", "-o", exe, src],
                       check=True)
        rc = subprocess.run([exe]).returncode
    print(cs.card_line())
    return rc


if __name__ == "__main__":
    sys.exit(main())
