#!/usr/bin/env python3
"""Where the time of the port's DDIM-50 CFG sampling goes, on one GPU.

    python3 scripts/profile_torch_sampling.py [--steps 5] [--batch 128]

Runs ``uurg_torch`` sampling of the full-width cifar10_sfron CondUNet
(seeded random init, bf16) under ``torch.profiler`` for a few DDIM steps
after a warm-up, and prints the device time by kernel group (the port's
attention and GroupNorm kernels, convolutions, GEMMs, elementwise, other),
the device busy share of the wall time, and the top kernels. The full table
goes to ``chiprun_out/profile_torch_sampling.txt``.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

GROUPS = (   # first match wins, on the lower-cased kernel name
    ("attention kernel", ("attn_fwd_kernel",)),
    ("GroupNorm kernel", ("gn_fwd_",)),
    ("convolution", ("conv", "implicit", "fprop", "cudnn", "nhwc",
                     "winograd")),
    ("GEMM", ("gemm", "cutlass", "cublas")),
    ("elementwise / copy", ("elementwise", "vectorized", "copy", "cat",
                            "upsample", "pad", "reduce", "where")),
)


def group_of(name: str) -> str:
    low = name.lower()
    for group, keys in GROUPS:
        if any(k in low for k in keys):
            return group
    return "other"


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--batch", type=int, default=128)
    args = p.parse_args()
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("needs a CUDA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import numpy as np

    from chip_smoke import SFRON_CONFIG
    from uurg_torch.core.config import Config
    from uurg_torch.workloads import ddpm_runner as R
    from uurg_torch.workloads.ddpm import DDPMWorkload

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    config = Config(SFRON_CONFIG)
    wl = DDPMWorkload.from_config(config)
    model = wl.init_params(0)
    labels = np.arange(args.batch) % 10

    def run(steps):
        R.sample_images(None, config, model, labels, num_steps=steps,
                        batch_size=args.batch, seed=0)

    run(2)                                            # warm-up: build, plans
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        run(args.steps)
        torch.cuda.synchronize()
        wall = time.time() - t0
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
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
    forwards = args.steps
    print(f"card: {card}")
    print(f"DDIM steps profiled: {args.steps} (one UNet forward each at batch "
          f"{2 * args.batch}); wall {wall * 1e3:.3f} ms, device busy "
          f"{busy_us / 1e3:.3f} ms ({100 * busy_us / 1e6 / wall:.1f}% of wall)")
    print("device time per UNet forward by group:")
    for g, us in sorted(by_group.items(), key=lambda kv: -kv[1]):
        print(f"  {g:20s} {us / forwards / 1e3:9.3f} ms  "
              f"{100 * us / busy_us:5.1f}%")
    top = sorted(events, key=lambda e: -getattr(e, dev_key))[:15]
    print("top kernels (device ms per forward, calls per forward):")
    for e in top:
        print(f"  {getattr(e, dev_key) / forwards / 1e3:8.3f} ms "
              f"{e.count / forwards:6.1f}x  [{group_of(e.key)}] {e.key[:90]}")
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out",
                           "profile_torch_sampling.txt"), "w") as f:
        f.write(f"{card}\n")
        f.write(prof.key_averages().table(sort_by=dev_key, row_limit=60))
    return 0


if __name__ == "__main__":
    sys.exit(main())
