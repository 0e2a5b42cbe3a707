#!/usr/bin/env python3
"""How often ``torch.profiler`` misses the one kernel of a GroupNorm
backward call, on one GPU.

    python3 scripts/check_one_launch.py [--reps 100]

``chip_smoke.py``'s phase 6 fails unless one ``group_norm_bwd`` call
enqueues exactly one kernel and nothing else (``one_launch``). It read that
from the profiler once; it reads it from a CUDA graph of the call now. This
script makes that call ``--reps`` times at each of the UNet's GroupNorm
shapes at the SFR-on batch (128, bf16), in four ways taken in turns, the
first three between two waits for the device under ``torch.profiler``:

- ``bare``: device activity only, the call right after the profiler
  starts, the profiler stopped right after the wait;
- ``cpu``: host activity recorded too, so that a missing kernel can be told
  from a missing launch: the host's kernel-launch calls are counted beside
  the device's kernels;
- ``padded``: as ``bare``, with ``PAD_S`` of host sleep after the profiler
  starts and before it stops;
- ``graph``: as ``one_launch`` does it, the call captured into a CUDA graph
  whose nodes are counted (``chip_smoke.enqueued_node_types``).

Each profiled way also counts the wrapper's own launches
(``group_norm_bwd.launches``, raised only after the launch returned no
error). Prints, for each way, how many calls showed 0, 1 or more device
activities (graph nodes), and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import collections
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PAD_S = 2e-3


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--reps", type=int, default=100)
    args = ap.parse_args()
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("needs a CUDA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from chip_smoke import (GN_SITES, GRAPH_KERNEL_NODE, TRAIN_BATCH,
                            enqueued_node_types)
    from uurg_torch.ops import _build
    from uurg_torch.ops import group_norm as GN

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    _build.build_all()
    gen = torch.Generator(device="cuda").manual_seed(0)
    calls = []
    for H, C, _ in GN_SITES:
        x = (torch.randn(TRAIN_BATCH, H, H, C, generator=gen, device="cuda")
             * 2 + 0.5).to(torch.bfloat16)
        g = torch.randn(TRAIN_BATCH, H, H, C, generator=gen,
                        device="cuda").to(torch.bfloat16)
        scale = torch.randn(C, generator=gen, device="cuda") * 0.2 + 1.0
        _, mean, rstd = GN.group_norm(x, scale, scale, groups=32,
                                      return_stats=True)
        calls.append((f"H=W={H} C={C}",
                      lambda x=x, s=scale, m=mean, r=rstd, g=g:
                      GN.group_norm_bwd(x, s, m, r, g)))
        # once before the count: the first call zeroes the fold's counters
        calls[-1][1]()

    def observe(fn, cpu: bool, pad: float) -> tuple[int, int, int]:
        """(device activities, host launch calls, wrapper launches) of one
        call of ``fn`` between two waits for the device."""
        if pad is None:                        # the graph way
            before = GN.group_norm_bwd.launches
            types = enqueued_node_types(fn)
            # a node of another type (a copy, a fill) is one too many
            dev = len(types) + any(t != GRAPH_KERNEL_NODE for t in types)
            return dev, 0, GN.group_norm_bwd.launches - before
        acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu
                                          else [])
        before = GN.group_norm_bwd.launches
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            if pad:
                time.sleep(pad)
            fn()
            torch.cuda.synchronize()
            if pad:
                time.sleep(pad)
        evs = prof.key_averages()
        dev = sum(e.count for e in evs
                  if e.device_type == torch.autograd.DeviceType.CUDA)
        host = sum(e.count for e in evs
                   if e.device_type == torch.autograd.DeviceType.CPU
                   and "LaunchKernel" in e.key)
        return dev, host, GN.group_norm_bwd.launches - before

    ways = {"bare": (False, 0.0), "cpu": (True, 0.0),
            "padded": (False, PAD_S), "graph": (False, None)}
    seen = {w: collections.Counter() for w in ways}
    misses = []
    t0 = time.time()
    for rep in range(args.reps):
        for tag, fn in calls:
            for way, (cpu, pad) in ways.items():
                dev, host, launched = observe(fn, cpu, pad)
                seen[way][min(dev, 2)] += 1
                if dev != 1 or launched != 1:
                    misses.append((way, tag, rep, dev, host, launched))
    print(f"{args.reps} reps x {len(calls)} shapes (batch {TRAIN_BATCH}, "
          f"bf16) a way, {time.time() - t0:.1f} s")
    for way, n in seen.items():
        print(f"  {way:7s} device activities seen: 0 in {n[0]}, 1 in {n[1]},"
              f" more in {n[2]} calls")
    for way, tag, rep, dev, host, launched in misses:
        print(f"  miss: {way} {tag} rep {rep}: {dev} device activities, "
              f"{host if way == 'cpu' else 'unrecorded'} host launch calls, "
              f"{launched} wrapper launches")
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
