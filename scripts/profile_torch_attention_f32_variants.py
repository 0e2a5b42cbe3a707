#!/usr/bin/env python3
"""Variants of the float32 attention kernels (tiled route), timed in turns.

    python3 scripts/profile_torch_attention_f32_variants.py

Copies ``uurg_torch/`` into a temporary directory once per variant, patches
the copy's ``csrc/flash_attention_f32.cu`` (and ``ops/flash_attention.py``
where the scratch changes; a patch that no longer applies fails the run),
builds it with its own nvcc, holds forward and backward against the plain
versions (relative L2 1e-5 and 1e-4) at ViT-B/16's (64, 12, 197, 64) and at
(4, 3, 65, 64), and times both there and at (256, 12, 5, 64) (device ms by
CUDA-graph replay, TF32 off). The order is the tree as it is, then each
variant, then the tree again, so that the two readings of the tree bound the
card's drift. Variants:

- ``first_design``: PR 11's kernels (the wide route) at D = 64, as the
  tree stood before the tiled and packed routes;
- ``dq_shares``: the key-tile kernel sums each 64-key tile's share of
  dq = dS K itself (from dS^T in shared memory) into float32 scratch
  (key tiles, B*H*T, 64), and a third pass sums the shares in key-tile
  order (five products, no dS in HBM);
- ``dq_recompute``: the key-tile kernel writes no dS (but for packed
  heads), and a second kernel owning 64 query rows rebuilds S and dP over
  32-key tiles of a cp.async ring and sums dq = dS K in registers (seven
  products, no scratch);
- ``fwd_rows8``: eight query rows a lane in the forward, not four (an
  8 x 4 score tile and 8 x 8 output: 1.25 bytes of shared memory a FFMA
  where 4 x 4 and 4 x 8 take 1.75; 128-row blocks, two an SM, not three);
- ``fwd_keys64``: forward key tiles of 64 (4 x 8 scores, two blocks an SM,
  not three);
- ``bwd_q16``: backward query tiles of 16 (three blocks an SM, not two);
- ``dq_keys64``: dq kernel key tiles of 64, not 32;
- ``unroll``: the D loops of the score products and the P V / dS Q loops
  fully unrolled (more loads in flight, more registers).

Ends with the card's name and power limit.
"""
from __future__ import annotations

import argparse
import os
import re
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CU = "csrc/flash_attention_f32.cu"
_STORE_DS = r"      store_ds\(Dt, ds_blk \+ t \* kBwdQ, Tp, nk\);\n"
_DQ_LAUNCH = (r"  err = allow_smem\(attn_bwd_dq_d64, dq_d64_smem\(\)\);\n.*?"
              r"n_q\);\n")
_BWD_SMEM = r"constexpr size_t bwd_d64_smem\(\)"
_ALLOW = r"template <typename Kernel>\ncudaError_t allow_smem"
_PLAN = (r"    Tp = -\(-T // _DS_PAD\) \* _DS_PAD\n"
         r"    return F32Plan\(\"tiled\", Dp, \(B \* H, Tp, Tp\)\)")

_SHARES = r'''// the block's share of dq for query tile t: queries below nq16 against its
// keys below nk, to part (this key tile's (B*H*T, 64) slice, at the head)
__device__ __forceinline__ void dq_share(const float* Dt, const float* Ks,
                                         float* __restrict__ part, int t,
                                         int T, int nk, int nq16) {
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int qd = 4 * (w % 2) + lane / 8, dd = 8 * (w / 2) + lane % 8;
  if (4 * qd >= nq16) return;
  float4 a[4];
  for (int r = 0; r < 4; ++r) a[r] = make_float4(0.f, 0.f, 0.f, 0.f);
  const int ke = (nk + 15) / 16 * 16;
#pragma unroll 4
  for (int kk = 0; kk < ke; ++kk) {
    const float4 ds = ld4(Dt + kk * kTld + 4 * qd);
    const float4 kv = ld4(Ks + kk * kLd + 4 * dd);
    fma4(a[0], ds.x, kv);
    fma4(a[1], ds.y, kv);
    fma4(a[2], ds.z, kv);
    fma4(a[3], ds.w, kv);
  }
  for (int r = 0; r < 4; ++r) {
    const int qr = t * kBwdQ + 4 * qd + r;
    if (qr < T)
      *reinterpret_cast<float4*>(part + static_cast<long long>(qr) * kD +
                                 4 * dd) = a[r];
  }
}

// dq = the key tiles' shares summed in key-tile order, float4 a thread
__global__ void __launch_bounds__(256)
attn_dq_sum(const float4* __restrict__ part, float4* __restrict__ dq,
            long long n4, int n_tiles) {
  const long long i = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
  if (i >= n4) return;
  float4 s = part[i];
  for (int t = 1; t < n_tiles; ++t) {
    const float4 x = part[t * n4 + i];
    s.x += x.x;
    s.y += x.y;
    s.z += x.z;
    s.w += x.w;
  }
  dq[i] = s;
}

'''
_SHARES_CALL = ("      dq_share(Dt, Ks, dq_out + ((blockIdx.x % n_tiles) * rows + "
                "head_row0) * kD,\n               t, T, nk, nq16);\n")
_SHARES_LAUNCH = r'''  {
    const long long n4 = rows * (kD / 4);
    attn_dq_sum<<<static_cast<unsigned>((n4 + 255) / 256), 256, 0, stream>>>(
        reinterpret_cast<const float4*>(scratch),
        reinterpret_cast<float4*>(dq), n4, n_tiles);
  }
'''

_RECOMPUTE_KERNEL = r'''constexpr int kRcKeys = 32;
constexpr size_t dq_rc_smem() {
  return sizeof(float) * ((2 * kDqRows + 4 * kRcKeys) * kLd +
                          kWarps * 16 * kTld + 2 * kDqRows);
}

__global__ void __launch_bounds__(kNT, 2)
attn_bwd_dq_rc(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ g,
               const float* __restrict__ lse, const float* __restrict__ delta,
               float* __restrict__ dq, int T, int n_tiles, float scale,
               float scale_log2) {
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Gs = Qs + kDqRows * kLd;
  float* Ks = Gs + kDqRows * kLd;
  float* Vs = Ks + 2 * kRcKeys * kLd;
  float* Ds = Vs + 2 * kRcKeys * kLd;
  float* Ls = Ds + kWarps * 16 * kTld;
  float* Es = Ls + kDqRows;
  constexpr int kStage = kRcKeys * kLd;
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int lr = lane / 8, lk = lane % 8;
  const long long bh = blockIdx.x / n_tiles;
  const int q0 = (blockIdx.x % n_tiles) * kDqRows;
  const long long h0 = bh * T;
  const int qlive = min(kDqRows, T - q0);
  async_tile<kDqRows>(Qs, q, h0 + q0, qlive);
  async_tile<kDqRows>(Gs, g, h0 + q0, qlive);
  async_vec<kDqRows>(Ls, lse, h0 + q0, qlive);
  async_vec<kDqRows>(Es, delta, h0 + q0, qlive);
  const int n_kt = (T + kRcKeys - 1) / kRcKeys;
  async_tile<kRcKeys>(Ks, k, h0, min(kRcKeys, T));
  async_tile<kRcKeys>(Vs, v, h0, min(kRcKeys, T));
  cp_async_commit();
  if (n_kt > 1) {
    async_tile<kRcKeys>(Ks + kStage, k, h0 + kRcKeys, min(kRcKeys, T - kRcKeys));
    async_tile<kRcKeys>(Vs + kStage, v, h0 + kRcKeys, min(kRcKeys, T - kRcKeys));
    cp_async_commit();
  }
  const int my_live = min(16, T - q0 - 16 * w);
  const float* Qw = Qs + 16 * w * kLd;
  const float* Gw = Gs + 16 * w * kLd;
  float* Dw = Ds + 16 * w * kTld;
  float4 acc[4][2];
  for (int i = 0; i < 4; ++i) acc[i][0] = acc[i][1] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int t = 0; t < n_kt; ++t) {
    if (t + 1 < n_kt) cp_async_wait<1>(); else cp_async_wait<0>();
    __syncthreads();
    if (my_live > 0) {
      const float* Kt = Ks + (t & 1) * kStage;
      const float* Vt = Vs + (t & 1) * kStage;
      const int nk = min(kRcKeys, T - t * kRcKeys);
      const int jlim = nk > lk ? (nk - lk + 7) / 8 : 0;
      float s[4][4], dp[4][4];
      for (int i = 0; i < 4; ++i) for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
      for (int d = 0; d < kD; d += 4) {
        float4 a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = ld4(Qw + (lr + 4 * i) * kLd + d);
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = ld4(Kt + (lk + 8 * j) * kLd + d);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = dot4(a[i], b[j], s[i][j]);
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = ld4(Gw + (lr + 4 * i) * kLd + d);
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = ld4(Vt + (lk + 8 * j) * kLd + d);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) dp[i][j] = dot4(a[i], b[j], dp[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = 16 * w + lr + 4 * i;
        const float li = Ls[r] * kLog2e, di = Es[r];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float p = j < jlim ? exp2f(s[i][j] * scale_log2 - li) : 0.f;
          Dw[(lr + 4 * i) * kTld + lk + 8 * j] = p * (dp[i][j] - di) * scale;
        }
      }
      __syncwarp();
#pragma unroll 2
      for (int kk = 0; kk < kRcKeys; kk += 4) {
        float4 p[4], x[4][2];
#pragma unroll
        for (int i = 0; i < 4; ++i) p[i] = ld4(Dw + (lr + 4 * i) * kTld + kk);
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int c = 0; c < 2; ++c) x[u][c] = ld4(Kt + (kk + u) * kLd + 4 * lk + 32 * c);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < 2; ++c)
            axpy4(acc[i][c], p[i], x[0][c], x[1][c], x[2][c], x[3][c]);
      }
      __syncwarp();
    }
    if (t + 2 < n_kt) {
      __syncthreads();
      const int live = min(kRcKeys, T - (t + 2) * kRcKeys);
      async_tile<kRcKeys>(Ks + (t & 1) * kStage, k, h0 + (t + 2) * kRcKeys, live);
      async_tile<kRcKeys>(Vs + (t & 1) * kStage, v, h0 + (t + 2) * kRcKeys, live);
      cp_async_commit();
    }
  }
  for (int i = 0; i < 4; ++i) {
    const int rl = lr + 4 * i;
    if (rl >= my_live) continue;
    const long long r = h0 + q0 + 16 * w + rl;
    for (int c = 0; c < 2; ++c)
      *reinterpret_cast<float4*>(dq + r * kD + 4 * lk + 32 * c) = acc[i][c];
  }
}

'''
_RECOMPUTE_LAUNCH = r'''  {
    const int nq = (T + kDqRows - 1) / kDqRows;
    err = allow_smem(attn_bwd_dq_rc, dq_rc_smem());
    if (err != cudaSuccess) return static_cast<int>(err);
    attn_bwd_dq_rc<<<BH * nq, kNT, dq_rc_smem(), stream>>>(
        q, k, v, g, lse, delta, dq, T, nq, scale, scale * kLog2e);
  }
'''

# name -> [(file under uurg_torch/, regex, replacement)]
VARIANTS = {
    "first_design": [
        ("ops/flash_attention.py", r"    if Dp > 64:\n", "    if Dp >= 64:\n"),
        (_CU, r"return D == 128 \|\| D == 192",
         "return D == 64 || D == 128 || D == 192"),
        (_CU, r"    case 128: return launch_fwd<128>",
         "    case 64: return launch_fwd<64>(qf, kf, vf, of, lf, BH, T, scale, "
         "s);\n    case 128: return launch_fwd<128>"),
        (_CU, r"    case 128:\n      return launch_bwd<128>",
         "    case 64:\n      return launch_bwd<64>(qf, kf, vf, gf, lf, df, "
         "dqf, dkf, dvf, BH, T, scale, s);\n    case 128:\n      return "
         "launch_bwd<128>")],
    "dq_shares": [
        (_CU, _STORE_DS, _SHARES_CALL),
        (_CU, _BWD_SMEM, _SHARES + "constexpr size_t bwd_d64_smem()"),
        (_CU, _DQ_LAUNCH, _SHARES_LAUNCH),
        ("ops/flash_attention.py", _PLAN,
         '    return F32Plan("tiled", Dp, (-(-T // 64), B * H * T, Dp))')],
    "dq_recompute": [
        (_CU, _STORE_DS, "      ;  // dq rebuilt by attn_bwd_dq_rc\n"),
        (_CU, _ALLOW, _RECOMPUTE_KERNEL
         + "template <typename Kernel>\ncudaError_t allow_smem"),
        (_CU, _DQ_LAUNCH, _RECOMPUTE_LAUNCH)],
    "fwd_rows8": [
        (_CU, r"constexpr int kFwdMI = 4;", "constexpr int kFwdMI = 8;"),
        (_CU, r"__launch_bounds__\(kNT, 3\)\nattn_fwd_d64",
         "__launch_bounds__(kNT, 2)\nattn_fwd_d64")],
    "fwd_keys64": [
        (_CU, r"constexpr int kFwdKeys = 32;", "constexpr int kFwdKeys = 64;"),
        (_CU, r"__launch_bounds__\(kNT, 3\)\nattn_fwd_d64",
         "__launch_bounds__(kNT, 2)\nattn_fwd_d64")],
    "bwd_q16": [
        (_CU, r"constexpr int kBwdQ = 32;", "constexpr int kBwdQ = 16;"),
        (_CU, r"__launch_bounds__\(kNT, 2\)\nattn_bwd_d64",
         "__launch_bounds__(kNT, 3)\nattn_bwd_d64")],
    "dq_keys64": [
        (_CU, r"constexpr int kDqKeys = 32;", "constexpr int kDqKeys = 64;")],
    "unroll": [
        (_CU, r"#pragma unroll 2\n  for \(int (d|kk|qq) = 0;",
         "#pragma unroll\n  for (int \\1 = 0;")],
}
CHECK = ((64, 12, 197, 64), (4, 3, 65, 64))
TIMED = ((64, 12, 197, 64), (256, 12, 5, 64))


def make_tree(base: str, name: str) -> str:
    """A copy of uurg_torch/ (without its build) under ``base``/``name``,
    patched as ``VARIANTS[name]`` says."""
    tree = os.path.join(base, name)
    shutil.copytree(os.path.join(ROOT, "uurg_torch"),
                    os.path.join(tree, "uurg_torch"),
                    ignore=shutil.ignore_patterns("__pycache__", "build"))
    for rel, pattern, new in VARIANTS.get(name, []):
        path = os.path.join(tree, "uurg_torch", rel)
        with open(path) as f:
            text = f.read()
        text, n = re.subn(pattern, lambda m: m.expand(new) if "\\1" in new
                          else new, text, flags=re.S)
        if n == 0:
            raise RuntimeError(f"{name}: patch {pattern[:40]!r} no longer "
                               f"applies to {rel}")
        with open(path, "w") as f:
            f.write(text)
    return tree


def time_tree(tree: str) -> int:
    """In a child process: build ``tree``'s flash_attention_f32.cu, check
    it and print its times."""
    sys.path.insert(0, tree)
    import torch

    sys.path.insert(1, ROOT)
    import chip_smoke as cs
    from uurg_torch.ops import _build
    from uurg_torch.ops import flash_attention as FA

    torch.backends.cuda.matmul.allow_tf32 = False
    _build.sources = lambda: [_build.CSRC / "flash_attention_f32.cu"]
    _build.build_all()
    for line in _build.build_logs.get("flash_attention_f32",
                                      "").splitlines():
        if re.search(r"[1-9]\d* bytes (spill|stack)", line):
            print(f"  ptxas: {line.strip()}")
    name = os.path.basename(tree)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for B, H, T, D in CHECK:
        q, k, v, g = (torch.randn(B, H, T, D, generator=gen, device="cuda")
                      for _ in range(4))
        o, lse = FA._attention_kernel(q, k, v, with_lse=True)
        got = FA.attention_bwd(q, k, v, o, lse, g)
        torch.cuda.synchronize()
        cs.rel_l2(f"{name} fwd T={T}", o, FA.attention_plain(q, k, v),
                  cs.F32_FWD_REL)
        for n, a, b in zip("qkv", got, FA.attention_bwd_plain(q, k, v, g)):
            cs.rel_l2(f"{name} bwd d{n} T={T}", a, b, cs.F32_BWD_REL)
    out = []
    for B, H, T, D in TIMED:
        q, k, v, g = (torch.randn(B, H, T, D, generator=gen, device="cuda")
                      for _ in range(4))
        o, lse = FA._attention_kernel(q, k, v, with_lse=True)
        fwd = cs.time_ms(lambda: FA._attention_kernel(q, k, v, True))[0]
        bwd = cs.time_ms(lambda: FA.attention_bwd(q, k, v, o, lse, g))[0]
        out.append(f"({B}, {H}, {T}, {D}) fwd {fwd:.4f} bwd {bwd:.4f}")
    print(f"{name}: " + " | ".join(out), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--time-tree", help=argparse.SUPPRESS)
    ap.add_argument("--only", nargs="*", help="variants to run (default all)")
    args = ap.parse_args()
    if args.time_tree:
        return time_tree(args.time_tree)
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs

    print(f"== card: {cs.card_line()}", flush=True)
    base = tempfile.mkdtemp(prefix="uurg_attn_f32_variants_")
    try:
        for name in ["as_is", *(args.only or VARIANTS), "as_is_again"]:
            tree = make_tree(base, name)
            subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--time-tree", tree], check=True)
    finally:
        shutil.rmtree(base, ignore_errors=True)
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
