#!/usr/bin/env python3
"""Where the time of the port's DiT-XL/2 SFR-on step goes, on one GPU.

    python3 scripts/profile_torch_dit.py [--steps 3] [--warmup 2] \\
        [--remat full|attn|dots|attn+dots] [--grid-steps 5]

Runs ``uurg_torch.workloads.dit_runner.dit_forget`` (adaga, ron, a packed
random mask of ~50% density, AdamW, EMA 0.9999) on DiT-XL/2 (seeded init
perturbed as ``chip_smoke.py`` phase 18 does, bf16 compute, batch 32 forget
+ 32 remain of seeded latents) under ``torch.profiler``, recording only the
steps after the warm-up. Prints the device time per step by kernel group,
the device busy share of the steps' wall time, the top kernels and the host
ops with the most self time, and the step's FLOPs (one phase's forward and
backward without remat, counted by ``torch.utils.flop_counter``, plus the
attention kernels' own count at the true head width 72) beside the time the
card's bf16 peak would need for them. Then the same for ``--grid-steps``
steps of the CFG sampler at batch 2 x 16 (``dit_sample_grid``'s).
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

GROUPS = (   # first match wins, on the lower-cased kernel name
    ("attention fwd kernel", ("attn_fwd_kernel",)),
    ("attention bwd kernels", ("attn_bwd_",)),
    ("optimizer / foreach", ("multi_tensor", "foreach")),
    ("GEMM", ("gemm", "cutlass", "cublas", "nvjet", "xmma", "sm90_")),
    ("LayerNorm", ("layer_norm",)),
    ("GELU", ("gelu",)),
    ("pad / transpose / cast copies", ("copy", "constant_pad", "cat")),
    ("reductions", ("reduce",)),
    ("elementwise", ("elementwise", "vectorized", "where", "index",
                     "philox", "distribution")),
)
BF16_TC_FLOPS = 989e12
ANNOTATIONS = ("ProfilerStep", "Optimizer.")


def group_of(name: str) -> str:
    low = name.lower()
    for group, keys in GROUPS:
        if any(k in low for k in keys):
            return group
    return "other"


def phase_flops(model, wl, x, y) -> tuple[float, float]:
    """(FLOPs of one phase's forward + backward without remat, of which the
    attention kernels'): matmuls and the patch convolution as PyTorch
    counts them, plus 4 B H T^2 D forward and 10 B H T^2 D backward a block
    at the true D (the hand-written kernels are invisible to the
    counter)."""
    import dataclasses

    import torch
    from torch.utils.flop_counter import FlopCounterMode

    cfg = model.cfg
    model.cfg = dataclasses.replace(cfg, remat=False)
    t = torch.zeros(x.shape[0], dtype=torch.long, device=x.device)
    noise = torch.zeros_like(x)
    with FlopCounterMode(display=False) as counter:
        wl.per_sample_loss(model, x, y, t, noise).mean().backward()
    model.cfg = cfg
    model.zero_grad(set_to_none=True)
    T = (cfg.input_size // cfg.patch_size) ** 2
    attn = 14 * x.shape[0] * T * T * cfg.hidden_size * cfg.depth
    return counter.get_total_flops() + attn, attn


def report(prof, steps: int, wall: float, label: str, lines: list[str]):
    import torch

    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None)
              == torch.autograd.DeviceType.CUDA
              and not e.key.startswith(ANNOTATIONS)]
    if not events:
        raise SystemExit("profiler recorded no device kernels")
    key = ("self_device_time_total"
           if hasattr(events[0], "self_device_time_total")
           else "self_cuda_time_total")
    busy_us = sum(getattr(e, key) for e in events)
    by_group: dict[str, float] = {}
    for e in events:
        by_group[group_of(e.key)] = by_group.get(group_of(e.key), 0.0) + \
            getattr(e, key)
    lines.append(f"{label}: wall {wall / steps * 1e3:.3f} ms/step, device "
                 f"busy {busy_us / steps / 1e3:.3f} ms/step "
                 f"({100 * busy_us / 1e6 / wall:.1f}% of wall)")
    lines.append("device time per step by group:")
    for g, us in sorted(by_group.items(), key=lambda kv: -kv[1]):
        lines.append(f"  {g:30s} {us / steps / 1e3:9.3f} ms  "
                     f"{100 * us / busy_us:5.1f}%")
    lines.append("top kernels (device ms per step, calls per step):")
    for e in sorted(events, key=lambda e: -getattr(e, key))[:20]:
        lines.append(f"  {getattr(e, key) / steps / 1e3:8.3f} ms "
                     f"{e.count / steps:7.1f}x  [{group_of(e.key)}] "
                     f"{e.key[:90]}")
    host = sorted((e for e in prof.key_averages()
                   if getattr(e, "device_type", None)
                   == torch.autograd.DeviceType.CPU),
                  key=lambda e: -e.self_cpu_time_total)[:12]
    lines.append("top host ops (self CPU ms per step, calls per step):")
    for e in host:
        lines.append(f"  {e.self_cpu_time_total / steps / 1e3:8.3f} ms "
                     f"{e.count / steps:8.1f}x  {e.key[:80]}")
    return busy_us


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--warmup", type=int, default=2)
    p.add_argument("--remat", default="full",
                   choices=["full", "attn", "dots", "attn+dots"])
    p.add_argument("--grid-steps", type=int, default=5)
    args = p.parse_args()
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    if not torch.cuda.is_available():
        print("needs a CUDA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import numpy as np

    from chip_smoke import (DIT_BATCH, DIT_COND_SCALE, DIT_NAME, SEED,
                            perturb_dit_)
    from uurg_torch.core.tree import pack_mask
    from uurg_torch.workloads import dit_runner as DR
    from uurg_torch.workloads.dit import DiTWorkload

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    policy = None if args.remat == "full" else args.remat
    wl = DiTWorkload.build(DIT_NAME, remat_policy=policy)
    model = perturb_dit_(wl.init_params(SEED))
    rng = np.random.default_rng(SEED)
    batch = (rng.standard_normal((DIT_BATCH, 32, 32, 4)).astype(np.float32),
             rng.integers(0, 1000, DIT_BATCH))
    x, y = DR.device_batch(batch, wl.device)
    flops, attn_flops = phase_flops(model, wl, x, y)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    mask = pack_mask({k: torch.rand(q.shape, generator=gen, device="cuda")
                      < 0.5 for k, q in model.named_parameters()})

    def same():
        while True:
            yield batch

    n = args.warmup + args.steps
    stamps = []
    make = DR.make_sfron_step

    def timed_make(*a, **k):
        step = make(*a, **k)

        def timed(*sa, **sk):
            out = step(*sa, **sk)
            if len(stamps) in (args.warmup - 1, n - 1):
                torch.cuda.synchronize()
            stamps.append(time.perf_counter())
            prof.step()
            return out

        return timed

    DR.make_sfron_step = timed_make
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=args.warmup,
                                   active=args.steps, repeat=1),
                 acc_events=True) as prof:
        DR.dit_forget(wl, model, same(), same(), n_iters=n, lr=1e-4,
                      forget_alpha=1e-3, unlearn_loss="adaga", mask=mask,
                      seed=SEED, log_freq=10 ** 6)
    DR.make_sfron_step = make
    wall = stamps[n - 1] - stamps[args.warmup - 1]
    lines = [f"card: {card}",
             f"{DIT_NAME}, remat {args.remat}, batch {DIT_BATCH} forget + "
             f"{DIT_BATCH} remain, {args.steps} steps after {args.warmup} "
             f"warm-up",
             f"step FLOPs (2 phases of forward + backward, no recompute): "
             f"{2 * flops:.4e} (attention {2 * attn_flops:.4e}); at the bf16"
             f" peak {2 * flops / BF16_TC_FLOPS * 1e3:.3f} ms; achieved "
             f"{2 * flops / (wall / args.steps) / 1e12:.1f} TFLOP/s on the "
             f"wall time"]
    report(prof, args.steps, wall, "SFR-on step", lines)

    sampler = wl.make_sampler(respacing=str(args.grid_steps),
                              cond_scale=DIT_COND_SCALE)
    labels = torch.arange(16, device="cuda") % 8
    sampler(model, labels, gen)                        # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof2:
        t0 = time.perf_counter()
        sampler(model, labels, gen)
        torch.cuda.synchronize()
        wall2 = time.perf_counter() - t0
    report(prof2, args.grid_steps, wall2,
           f"sampler step (CFG batch {2 * len(labels)})", lines)
    print("\n".join(lines), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
