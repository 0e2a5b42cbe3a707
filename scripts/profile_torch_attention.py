#!/usr/bin/env python3
"""The port's attention kernels alone, on one GPU: build, check, time.

    python3 scripts/profile_torch_attention.py

Builds the kernels (the full nvcc / ptxas output goes to
``chiprun_out/build_<source>.log``), then holds the forward and backward
kernels against their plain PyTorch versions at the main path's shapes and
at ragged ones (T not a multiple of the tile, head width padded), each
run three times with equal bits, and then times kernel,
plain version and PyTorch's SDPA at the main path's shapes (CUDA-graph
replay, as ``chip_smoke.py`` does), with the backward's device time split by
kernel (``torch.profiler``). A quick check for work on
``uurg_torch/csrc/flash_attention_*.cu``; ``chip_smoke.py`` stays the whole
proof.
"""
from __future__ import annotations

import os
import re
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (batch, heads, T, D): the UNet's sites first, then ragged T and padded D
CHECK_SHAPES = ((4, 2, 256, 64), (4, 2, 256, 256), (4, 2, 16, 256),
                (4, 2, 77, 40), (4, 2, 100, 72), (4, 2, 130, 160),
                (4, 2, 256, 192), (4, 2, 1024, 64), (2, 1, 1024, 256),
                (256, 1, 256, 256), (128, 1, 256, 256))
# (batch, T, D, with_lse): sampling forward, training forward, mid site
TIMED_SHAPES = ((256, 256, 256, False), (128, 256, 256, True),
                (256, 16, 256, False), (128, 16, 256, True))


def kernel_split(fn, iters: int = 20) -> dict[str, float]:
    """Device ms per call of ``fn`` by kernel name (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    split = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = re.search(r"attn_\w+", e.key)
            split[name.group(0) if name else e.key[:40]] = \
                e.device_time_total / iters / 1e3
    return split


def main() -> int:
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("needs a CUDA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from uurg_torch.ops import _build
    from uurg_torch.ops import flash_attention as FA

    print(f"== card: {cs.card_line()}; torch {torch.__version__}", flush=True)
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    try:
        _build.build_all()
    finally:
        for name, log in _build.build_logs.items():
            with open(os.path.join(out_dir, f"build_{name}.log"), "w") as f:
                f.write(log)
            for line in log.splitlines():
                if any(w in line for w in ("registers", "spill", "warning",
                                           "error", "Warning", "(C75")):
                    print(f"  [{name}] {line.strip()}", flush=True)

    gen = torch.Generator(device="cuda").manual_seed(0)
    failed = []
    for B, H, T, D in CHECK_SHAPES:
        q, k, v, g = (torch.randn(B, H, T, D, generator=gen, device="cuda",
                                  dtype=torch.bfloat16) for _ in range(4))
        tag = f"B={B} H={H} T={T} D={D}"
        try:
            o, lse = FA._attention_kernel(q, k, v, with_lse=True)
            torch.cuda.synchronize()
            cs.compare(f"fwd {tag}", o, FA.attention_plain(q, k, v))
            cs.check_lse(f"fwd {tag}", lse, q, k)
            o = o.contiguous()
            got = FA.attention_bwd(q, k, v, o, lse, g)
            torch.cuda.synchronize()
            want = FA.attention_bwd_plain(q, k, v, g)
            for n, a, b in zip("qkv", got, want):
                cs.rel_l2(f"bwd d{n} {tag}", a, b, cs.BWD_REL_L2)
            for _ in range(cs.RAGGED_REPEATS - 1):
                again = FA.attention_bwd(q, k, v, o, lse, g)
                o2, lse2 = FA._attention_kernel(q, k, v, with_lse=True)
                if not (all(torch.equal(a, b) for a, b in zip(got, again))
                        and torch.equal(o2.contiguous(), o)
                        and torch.equal(lse2, lse)):
                    cs.fail(f"{tag}: repeated runs differ in their bits")
        except RuntimeError as e:
            print(f"  FAILED {tag}: {e}", flush=True)
            failed.append(tag)
            if "CUDA error" in str(e) or "cuda" in str(e).lower():
                break      # the context is gone after a device fault
    if failed:
        print(f"== failed: {failed}", flush=True)
        return 1

    print("== times (device ms per call, CUDA-graph replay)", flush=True)
    for B, T, D, with_lse in TIMED_SHAPES:
        q, k, v, g = (torch.randn(B, 1, T, D, generator=gen, device="cuda",
                                  dtype=torch.bfloat16) for _ in range(4))
        ms, eager = cs.time_ms(
            lambda: FA._attention_kernel(q, k, v, with_lse=with_lse))
        plain = cs.time_ms(lambda: FA.attention_plain(q, k, v))[0]
        lib = cs.time_ms(lambda: F.scaled_dot_product_attention(q, k, v))[0]
        bound = max(4 * B * T * D * 2 / cs.HBM_BYTES_PER_S,
                    4 * B * T * T * D / cs.BF16_TC_FLOPS) * 1e3
        print(f"  fwd B={B} T={T} D={D} lse={with_lse}: kernel {ms:.4f} "
              f"(eager {eager:.4f}), plain {plain:.4f}, SDPA {lib:.4f}, "
              f"bound {bound:.4f}", flush=True)
        if not with_lse:
            continue
        o, lse = FA._attention_kernel(q, k, v, with_lse=True)
        ms, eager = cs.time_ms(lambda: FA.attention_bwd(q, k, v, o, lse, g))
        plain = cs.time_ms(lambda: FA.attention_bwd_plain(q, k, v, g))[0]
        fn, stream = cs.library_bwd(F.scaled_dot_product_attention,
                                    (q, k, v), g)
        lib = cs.time_ms(fn, stream=stream)[0]
        bound = max(7 * B * T * D * 2 / cs.HBM_BYTES_PER_S,
                    10 * B * T * T * D / cs.BF16_TC_FLOPS) * 1e3
        print(f"  bwd B={B} T={T} D={D}: kernel {ms:.4f} (eager "
              f"{eager:.4f}), plain {plain:.4f}, SDPA backward {lib:.4f}, "
              f"bound {bound:.4f}", flush=True)
        split = kernel_split(lambda: FA.attention_bwd(q, k, v, o, lse, g))
        print("    by kernel: " + ", ".join(
            f"{name} {t:.4f}" for name, t in sorted(split.items())),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
