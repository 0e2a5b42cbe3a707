#!/usr/bin/env python3
"""The port's attention kernels alone, on one GPU: build, check, time.

    python3 scripts/profile_torch_attention.py

Builds the kernels (the full nvcc / ptxas output goes to
``chiprun_out/build_<source>.log``), then holds the forward and backward
kernels against their plain PyTorch versions at the main paths' shapes and
at ragged ones (T not a multiple of the tile, head widths that are not a
multiple of 64), each run three times with equal bits, and each run again
on the layout DiT's MHSA gives (q, k, v views of one fused projection, a
token-major gradient), which must give the same bits as contiguous inputs.
Then it times kernel, plain version and PyTorch's SDPA at the main paths'
shapes (CUDA-graph replay, as ``chip_smoke.py`` does), DiT-XL/2's in turns
on contiguous inputs and on MHSA's views, with the backward's device time
split by kernel (``torch.profiler``). A quick check for work on
``uurg_torch/csrc/flash_attention_*.cu``; ``chip_smoke.py`` stays the whole
proof.
"""
from __future__ import annotations

import os
import re
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (batch, heads, T, D): the UNet's sites first, then ragged T and head
# widths that are not a multiple of 64, then DiT-XL/2's attention
CHECK_SHAPES = ((4, 2, 256, 64), (4, 2, 256, 256), (4, 2, 16, 256),
                (4, 2, 77, 40), (4, 2, 100, 72), (4, 2, 130, 160),
                (4, 2, 256, 192), (4, 2, 1024, 64), (2, 1, 1024, 256),
                (4, 2, 20, 20), (4, 3, 33, 8), (4, 2, 70, 248),
                (256, 1, 256, 256), (128, 1, 256, 256), (32, 16, 256, 72))
# (batch, T, D, with_lse): sampling forward, training forward, mid site
TIMED_SHAPES = ((256, 256, 256, False), (128, 256, 256, True),
                (256, 16, 256, False), (128, 16, 256, True))
# DiT-XL/2's attention (B, H, T, D), timed in turns on two layouts
DIT_SHAPE = (32, 16, 256, 72)


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


def check_shape(cs, FA, B, H, T, D, gen) -> None:
    """Kernels vs plain at (B, H, T, D), three runs with equal bits, and
    MHSA's views against contiguous copies of the same values."""
    import torch

    views = cs.mhsa_views(B, H, T, D, gen)
    q, k, v, g = (t.contiguous() for t in views)
    tag = f"B={B} H={H} T={T} D={D}"
    o, lse = FA._attention_kernel(q, k, v, with_lse=True)
    torch.cuda.synchronize()
    cs.compare(f"fwd {tag}", o, FA.attention_plain(q, k, v))
    cs.check_lse(f"fwd {tag}", lse, q, k)
    got = FA.attention_bwd(q, k, v, o, lse, g)
    torch.cuda.synchronize()
    want = FA.attention_bwd_plain(q, k, v, g)
    for n, a, b in zip("qkv", got, want):
        cs.rel_l2(f"bwd d{n} {tag}", a, b, cs.BWD_REL_L2)
    for _ in range(cs.RAGGED_REPEATS - 1):
        again = FA.attention_bwd(q, k, v, o, lse, g)
        o2, lse2 = FA._attention_kernel(q, k, v, with_lse=True)
        if not (all(torch.equal(a, b) for a, b in zip(got, again))
                and torch.equal(o2, o) and torch.equal(lse2, lse)):
            cs.fail(f"{tag}: repeated runs differ in their bits")
    ov, lsev = FA._attention_kernel(*views[:3], with_lse=True)
    gotv = FA.attention_bwd(*views[:3], ov, lsev, views[3])
    torch.cuda.synchronize()
    if not (torch.equal(ov, o) and torch.equal(lsev, lse)
            and all(torch.equal(a, b) for a, b in zip(gotv, got))):
        cs.fail(f"{tag}: MHSA's views and contiguous inputs differ in "
                f"their bits")
    print(f"  {tag}: views == contiguous (o {tuple(ov.stride())})",
          flush=True)


def time_dit(cs, FA, gen) -> None:
    """DiT-XL/2's attention on contiguous inputs and on MHSA's views, in
    turns (contiguous, views, views, contiguous), beside bf16 SDPA."""
    import torch
    import torch.nn.functional as F

    B, H, T, D = DIT_SHAPE
    views = cs.mhsa_views(B, H, T, D, gen)
    dense = tuple(t.contiguous() for t in views)
    n = B * H * T * D
    bounds = {"fwd": max(4 * n * 2 / cs.HBM_BYTES_PER_S,
                         4 * n * T / cs.BF16_TC_FLOPS) * 1e3,
              "bwd": max(7 * n * 2 / cs.HBM_BYTES_PER_S,
                         10 * n * T / cs.BF16_TC_FLOPS) * 1e3}
    for layout in ("contiguous", "views", "views", "contiguous"):
        q, k, v, g = dense if layout == "contiguous" else views
        o, lse = FA._attention_kernel(q, k, v, with_lse=True)
        fwd = cs.time_ms(lambda: FA._attention_kernel(q, k, v,
                                                      with_lse=True))
        bwd = cs.time_ms(lambda: FA.attention_bwd(q, k, v, o, lse, g))
        pads = cs.pad_ops(lambda: FA.attention_bwd(
            q, k, v, *FA._attention_kernel(q, k, v, with_lse=True), g))
        print(f"  DiT {DIT_SHAPE} {layout}: fwd {fwd[0]:.4f} (eager "
              f"{fwd[1]:.4f}), bwd {bwd[0]:.4f} (eager {bwd[1]:.4f}); "
              f"pad ops {pads}", flush=True)
    for layout, (q, k, v, g) in (("contiguous", dense), ("views", views)):
        lib_f = cs.time_ms(lambda: F.scaled_dot_product_attention(q, k, v))[0]
        fn, stream = cs.library_bwd(F.scaled_dot_product_attention,
                                    (q, k, v), g)
        lib_b = cs.time_ms(fn, stream=stream)[0]
        print(f"  DiT {DIT_SHAPE} {layout}: SDPA fwd {lib_f:.4f}, bwd "
              f"{lib_b:.4f}", flush=True)
    q, k, v, g = dense
    plain_f = cs.time_ms(lambda: FA.attention_plain(q, k, v))[0]
    print(f"  DiT {DIT_SHAPE}: plain fwd {plain_f:.4f}; bound fwd "
          f"{bounds['fwd']:.4f}, bwd {bounds['bwd']:.4f} (bytes at D = {D})",
          flush=True)
    q, k, v, g = views
    o, lse = FA._attention_kernel(q, k, v, with_lse=True)
    split = kernel_split(lambda: FA.attention_bwd(q, k, v, o, lse, g))
    print("    views bwd by kernel: " + ", ".join(
        f"{name} {t:.4f}" for name, t in sorted(split.items())), flush=True)


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
                if any(w in line for w in ("spill", "warning", "error",
                                           "Warning", "(C75")):
                    print(f"  [{name}] {line.strip()}", flush=True)

    gen = torch.Generator(device="cuda").manual_seed(0)
    failed = []
    for B, H, T, D in CHECK_SHAPES:
        try:
            check_shape(cs, FA, B, H, T, D, gen)
        except RuntimeError as e:
            print(f"  FAILED B={B} H={H} T={T} D={D}: {e}", flush=True)
            failed.append((B, H, T, D))
            if "CUDA error" in str(e) or "cuda" in str(e).lower():
                break      # the context is gone after a device fault
    if failed:
        print(f"== failed: {failed}", flush=True)
        return 1

    print("== times (device ms per call, CUDA-graph replay)", flush=True)
    time_dit(cs, FA, gen)
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
