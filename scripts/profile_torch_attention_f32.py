#!/usr/bin/env python3
"""The port's float32 attention kernels alone, on one GPU: build, check, time.

    python3 scripts/profile_torch_attention_f32.py [--quick]

Builds the kernels (the full nvcc / ptxas output goes to
``chiprun_out/build_<source>.log``; the float32 source's register and spill
lines are printed), holds the forward, its log-sum-exp and the backward
against the plain PyTorch versions at the edges of each route (relative L2
1e-5 forward, 1e-4 backward, as ``chip_smoke.py`` phase 16) with three runs
of equal bits, then times at ViT-B/16's two shapes (CUDA-graph replay, TF32
off): the route the wrapper picks, the plain versions and float32 SDPA,
with the backward's device time split by kernel (``torch.profiler``).
``--quick`` checks only. A quick check for work on
``uurg_torch/csrc/flash_attention_f32.cu``; ``chip_smoke.py`` stays the
whole proof, and ``scripts/profile_torch_attention_f32_variants.py`` times
other designs (the first one among them) against it in turns.
"""
from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (B, H, T, D): each route's edges at D = 64 and a padded width, the wide
# route, then ViT-B/16 at 224 and 32 px (T = 1 is left out: its dq and dk
# are zero, so a relative gate holds nothing)
CHECK_SHAPES = tuple((4, 3, T, D) for T in (2, 5, 16, 17, 31, 33, 63, 65,
                                            196, 197, 208)
                     for D in (64, 40)) + (
    (2, 2, 77, 160), (2, 2, 130, 256), (64, 12, 197, 64), (256, 12, 5, 64))
TIMED_SHAPES = ((64, 12, 197, 64), (256, 12, 5, 64))


def main() -> int:
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("needs a CUDA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import chip_smoke as cs
    from profile_torch_attention import kernel_split
    from uurg_torch.ops import _build
    from uurg_torch.ops import flash_attention as FA

    print(f"== card: {cs.card_line()}; torch {torch.__version__}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    try:
        _build.build_all()
    finally:
        for name, log in _build.build_logs.items():
            with open(os.path.join(out_dir, f"build_{name}.log"), "w") as f:
                f.write(log)
            if name != "flash_attention_f32":
                continue
            for line in log.splitlines():
                if any(w in line for w in ("registers", "spill", "warning",
                                           "error", "Compiling", "(C75")):
                    print(f"  [{name}] {line.strip()}", flush=True)

    gen = torch.Generator(device="cuda").manual_seed(0)
    for B, H, T, D in CHECK_SHAPES:
        q, k, v, g = (torch.randn(B, H, T, D, generator=gen, device="cuda")
                      for _ in range(4))
        tag = f"{FA._f32_plan(B, H, T, D).route} B={B} H={H} T={T} D={D}"
        o, lse = FA._attention_kernel(q, k, v, with_lse=True)
        o = o.contiguous()
        got = FA.attention_bwd(q, k, v, o, lse, g)
        torch.cuda.synchronize()
        cs.rel_l2(f"fwd {tag}", o, FA.attention_plain(q, k, v),
                  cs.F32_FWD_REL)
        cs.check_lse(f"fwd {tag}", lse, q, k)
        for n, a, b in zip("qkv", got, FA.attention_bwd_plain(q, k, v, g)):
            cs.rel_l2(f"bwd d{n} {tag}", a, b, cs.F32_BWD_REL)
        for _ in range(cs.RAGGED_REPEATS - 1):
            o2, lse2 = FA._attention_kernel(q, k, v, with_lse=True)
            again = FA.attention_bwd(q, k, v, o, lse, g)
            if not (torch.equal(o2.contiguous(), o) and torch.equal(lse2, lse)
                    and all(torch.equal(a, b) for a, b in zip(got, again))):
                cs.fail(f"{tag}: repeated runs differ in their bits")
    print(f"== {len(CHECK_SHAPES)} shapes held, {cs.RAGGED_REPEATS} runs each "
          f"with equal bits", flush=True)
    if "--quick" in sys.argv:
        return 0

    print("== times (device ms per call, CUDA-graph replay)", flush=True)
    for B, H, T, D in TIMED_SHAPES:
        q, k, v, g = (torch.randn(B, H, T, D, generator=gen, device="cuda")
                      for _ in range(4))
        route = FA._f32_plan(B, H, T, D).route
        o, lse = FA._attention_kernel(q, k, v, with_lse=True)
        n = B * H * T * D
        fb = max(16 * n / cs.HBM_BYTES_PER_S, 4 * n * T / cs.FP32_FLOPS) * 1e3
        bb = max(28 * n / cs.HBM_BYTES_PER_S, 10 * n * T / cs.FP32_FLOPS) * 1e3
        fwd = cs.time_ms(lambda: FA._attention_kernel(q, k, v, True))[0]
        plain = cs.time_ms(lambda: FA.attention_plain(q, k, v))[0]
        lib = cs.time_ms(lambda: F.scaled_dot_product_attention(q, k, v))[0]
        print(f"  fwd {route} B={B} H={H} T={T} D={D}: kernel {fwd:.4f}, "
              f"plain {plain:.4f}, SDPA {lib:.4f}, bound {fb:.4f}",
              flush=True)
        bwd = cs.time_ms(lambda: FA.attention_bwd(q, k, v, o, lse, g))[0]
        plain = cs.time_ms(lambda: FA.attention_bwd_plain(q, k, v, g))[0]
        fn, stream = cs.library_bwd(F.scaled_dot_product_attention,
                                    (q, k, v), g)
        lib = cs.time_ms(fn, stream=stream)[0]
        print(f"  bwd {route} B={B} H={H} T={T} D={D}: kernel {bwd:.4f}, "
              f"plain {plain:.4f}, SDPA backward {lib:.4f}, bound {bb:.4f}",
              flush=True)
        split = kernel_split(lambda: FA.attention_bwd(q, k, v, o, lse, g))
        print("    by kernel: " + ", ".join(
            f"{name} {t:.4f}" for name, t in sorted(split.items())),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
