#!/usr/bin/env python3
"""Where the time of the port's SFR-on unlearning step goes, on one GPU.

    python3 scripts/profile_torch_sfron.py [--steps 5] [--warmup 2]

Runs ``uurg_torch.workloads.ddpm_runner.sfron_forget`` (adaga, ron, a packed
random mask of ~50% density, forget alpha 10) on the full-width
cifar10_sfron CondUNet (seeded random init, bf16 compute, batch 128 forget +
128 remain, synthetic CIFAR-10 stand-in) under ``torch.profiler``, recording
only the steps after the warm-up. Prints the device time per step by kernel
group, the device busy share of the steps' wall time, the top kernels, and
the host ops with the most self time, and the step's FLOPs counted from
one phase's forward and backward
(``torch.utils.flop_counter`` for convolutions and matrix products, plus the
attention kernels' own count) beside the time the card's bf16 peak would
need for them. The full table goes to ``chiprun_out/profile_torch_sfron.txt``.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

GROUPS = (   # first match wins, on the lower-cased kernel name
    ("attention fwd kernel", ("attn_fwd_kernel",)),
    ("attention bwd kernels", ("attn_bwd_",)),
    ("GroupNorm fwd kernel", ("gn_fwd_",)),
    ("GroupNorm bwd kernel", ("gn_bwd_",)),
    ("optimizer / foreach", ("multi_tensor", "foreach")),
    ("convolution", ("conv", "implicit", "fprop", "dgrad", "wgrad", "cudnn",
                     "nhwc", "winograd", "xmma")),
    ("GEMM", ("gemm", "cutlass", "cublas", "nvjet")),
    ("elementwise / copy", ("elementwise", "vectorized", "copy", "cat",
                            "upsample", "pad", "reduce", "where", "index",
                            "philox", "distribution")),
)
BF16_TC_FLOPS = 989e12
# ranges the profiler lists among device events that are not kernels: the
# step markers and torch.optim's record_function around each step
ANNOTATIONS = ("ProfilerStep", "Optimizer.")


def group_of(name: str) -> str:
    low = name.lower()
    for group, keys in GROUPS:
        if any(k in low for k in keys):
            return group
    return "other"


def phase_flops(model, wl, batch: int, sites) -> tuple[float, float]:
    """(FLOPs of one phase's forward + backward at ``batch``, of which the
    attention kernels'): convolutions and matrix products as PyTorch counts
    them, plus 4*B*T*T*D forward and 10*B*T*T*D backward per attention
    site (the hand-written kernels are invisible to the counter)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    dev = wl.device
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.rand(batch, 32, 32, 3, generator=gen, device=dev) * 2 - 1
    c = torch.randint(0, 10, (batch,), generator=gen, device=dev)
    model.train()
    with FlopCounterMode(display=False) as counter:
        wl.train_loss_fn()(model, (x, c), gen).backward()
    model.zero_grad(set_to_none=True)
    attn = sum(14 * batch * (h * w) ** 2 * ch
               for kind, (ch, h, w), _ in sites if kind == "attn")
    return counter.get_total_flops() + attn, attn


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--warmup", type=int, default=2)
    args = p.parse_args()
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    if not torch.cuda.is_available():
        print("needs a CUDA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import numpy as np

    from chip_smoke import FORGET_ALPHA, SEED, SFRON_CONFIG, collect_sites
    from uurg_torch.core.config import Config
    from uurg_torch.core.tree import pack_mask
    from uurg_torch.workloads import ddpm_runner as R
    from uurg_torch.workloads.ddpm import DDPMWorkload

    class Run:
        seed = SEED
        ckpt_folder = None
        label_to_forget = 0
        forget_alpha = FORGET_ALPHA
        method = "ron"
        unlearn_loss = "adaga"

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    n = args.warmup + args.steps
    config = Config(SFRON_CONFIG).merged({"training": {
        "n_iters": n, "snapshot_freq": 10 ** 6, "log_freq": 10 ** 6}})
    wl = DDPMWorkload.from_config(config)
    model = R.load_params(Run, config, wl)
    sites = collect_sites(model, wl.device)
    flops, attn_flops = phase_flops(model, wl, config.training.batch_size,
                                    sites)
    gen = torch.Generator().manual_seed(SEED)
    mask = pack_mask({k: torch.rand(q.shape, generator=gen) < 0.5
                      for k, q in model.named_parameters()})
    del model

    stamps = []
    make = R.make_sfron_step

    def timed_make(*a, **k):
        step = make(*a, **k)

        def timed(*sa, **sk):
            out = step(*sa, **sk)
            # wait for the device only at the window's two ends, so the
            # steps inside it run as the runner runs them
            if len(stamps) in (args.warmup - 1, n - 1):
                torch.cuda.synchronize()
            stamps.append(time.perf_counter())
            prof.step()
            return out

        return timed

    R.make_sfron_step = timed_make
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=args.warmup,
                                   active=args.steps, repeat=1),
                 acc_events=True) as prof, \
            tempfile.TemporaryDirectory() as ckpt_dir:
        R.sfron_forget(Run, config, ckpt_dir, mask=mask)
    R.make_sfron_step = make
    wall = stamps[n - 1] - stamps[args.warmup - 1]
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
              and not e.key.startswith(ANNOTATIONS)]
    if not events:
        print("profiler recorded no device kernels", file=sys.stderr)
        return 1
    dev_key = ("self_device_time_total"
               if hasattr(events[0], "self_device_time_total")
               else "self_cuda_time_total")
    busy_us = sum(getattr(e, dev_key) for e in events)
    by_group: dict[str, float] = {}
    for e in events:
        by_group[group_of(e.key)] = by_group.get(group_of(e.key), 0.0) + \
            getattr(e, dev_key)
    steps = args.steps
    step_flops = 2 * flops
    print(f"card: {card}")
    print(f"SFR-on steps profiled: {steps} after {args.warmup} warm-up "
          f"(batch {config.training.batch_size} forget + "
          f"{config.training.batch_size} remain); wall "
          f"{wall / steps * 1e3:.3f} ms/step ({steps / wall:.3f} steps/s), "
          f"device busy {busy_us / steps / 1e3:.3f} ms/step "
          f"({100 * busy_us / 1e6 / wall:.1f}% of wall)")
    print(f"step FLOPs (2 phases of forward + backward): {step_flops:.4e} "
          f"(attention kernels {2 * attn_flops:.4e}); at the bf16 peak "
          f"{step_flops / BF16_TC_FLOPS * 1e3:.3f} ms; achieved "
          f"{step_flops / (wall / steps) / 1e12:.1f} TFLOP/s on the wall "
          f"time")
    print("device time per step by group:")
    for g, us in sorted(by_group.items(), key=lambda kv: -kv[1]):
        print(f"  {g:22s} {us / steps / 1e3:9.3f} ms  "
              f"{100 * us / busy_us:5.1f}%")
    top = sorted(events, key=lambda e: -getattr(e, dev_key))[:20]
    print("top kernels (device ms per step, calls per step):")
    for e in top:
        print(f"  {getattr(e, dev_key) / steps / 1e3:8.3f} ms "
              f"{e.count / steps:6.1f}x  [{group_of(e.key)}] {e.key[:90]}")
    host = sorted((e for e in prof.key_averages()
                   if getattr(e, "device_type", None)
                   == torch.autograd.DeviceType.CPU),
                  key=lambda e: -e.self_cpu_time_total)[:15]
    print("top host ops (self CPU ms per step, calls per step):")
    for e in host:
        print(f"  {e.self_cpu_time_total / steps / 1e3:8.3f} ms "
              f"{e.count / steps:7.1f}x  {e.key[:80]}")
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "profile_torch_sfron.txt"),
              "w") as f:
        f.write(f"{card}\n")
        f.write(prof.key_averages().table(sort_by=dev_key, row_limit=80))
    return 0


if __name__ == "__main__":
    sys.exit(main())
