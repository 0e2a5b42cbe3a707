#!/usr/bin/env python3
"""Where tensor parallel's peak memory goes in ``dit_forget``, on one GPU.

    python3 scripts/profile_torch_tp_memory.py [--steps 2] [--only one|tp]

Runs ``dit_forget`` at ``chip_smoke.py`` phase 23's settings (DiT-XL/2,
seeded and perturbed, adaga, AdamW 1e-4, EMA, a dense mask of density
0.5, batch 32 + 32) on one device and under ``parallelism="tp"`` on a
one-rank NCCL group (``mesh=data=1,model=1``), each in a process of its
own, and records the card's peak allocated memory in each interval
between the SFR-on step's stages: a loss's forward (up to its
``backward``), the backward, the gradients' all-reduce, the clip, the
optimizer step and the EMA update. The tensor-parallel run goes twice:
with PyTorch's default ``TORCH_NCCL_AVOID_RECORD_STREAMS`` (ProcessGroupNCCL
keeps each collective's tensors until its watchdog sees the work done)
and with it set to 0 (the caching allocator's stream records instead).
Prints each run's interval peaks beside one another, the card's name and
power limit; the last line is one JSON object.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUNS = {"one": ({}, None), "tp": ({}, "tp"),
        "tp_record_streams": ({"TORCH_NCCL_AVOID_RECORD_STREAMS": "0"},
                              "tp")}


def _run(parallelism: str | None, steps: int) -> dict:
    """The run in this process: ``[(interval, peak GiB)]`` in order, the
    run's peak and its host seconds."""
    import numpy as np
    import torch

    sys.path.insert(0, ROOT)
    import chip_smoke as C
    from uurg_torch.core import tree as TT
    from uurg_torch.unlearn import sfron as S
    from uurg_torch.workloads import dit_runner as DR
    from uurg_torch.workloads.dit import DiTWorkload

    marks: list = []

    def mark(name: str) -> None:
        torch.cuda.synchronize()
        marks.append((name, torch.cuda.max_memory_allocated() / 2 ** 30))
        torch.cuda.reset_peak_memory_stats()

    def around(name: str, fn):
        def wrapped(*a, **k):
            mark(f"before {name}")
            out = fn(*a, **k)
            mark(name)
            return out
        return wrapped

    torch.Tensor.backward = around("backward", torch.Tensor.backward)
    S.all_reduce_mean_ = around("all-reduce", S.all_reduce_mean_)
    TT.clip_by_global_norm_ = around("clip", TT.clip_by_global_norm_)
    torch.optim.AdamW.step = around("optimizer step", torch.optim.AdamW.step)
    S.ema_update = around("EMA update", S.ema_update)
    place = {}
    if parallelism:
        from uurg_torch.parallel import initialize_distributed, make_mesh
        from uurg_torch.parallel.dist import free_port

        initialize_distributed(f"127.0.0.1:{free_port()}", 1, 0, "cuda")
        place = {"mesh": make_mesh({"data": 1, "model": 1}),
                 "parallelism": parallelism}
    wl = DiTWorkload.build(C.DIT_NAME)
    rng = np.random.default_rng(C.SEED)

    def batch(low, high):
        return (torch.from_numpy(rng.standard_normal(
            (C.DIT_BATCH, 32, 32, 4)).astype(np.float32)),
            torch.from_numpy(rng.integers(low, high, C.DIT_BATCH)))

    fbs = [batch(0, 1) for _ in range(steps)]
    rbs = [batch(1, C.DIT_STANDIN_CLASSES) for _ in range(steps)]
    gen = torch.Generator(device="cuda").manual_seed(C.SEED)
    model = C.perturb_dit_(wl.init_params(C.SEED))
    mask = {n: torch.rand(p.shape, generator=gen, device="cuda") < 0.5
            for n, p in model.named_parameters()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated() / 2 ** 30
    t0 = time.perf_counter()
    DR.dit_forget(wl, model, iter(fbs), iter(rbs), n_iters=steps, lr=1e-4,
                  forget_alpha=1e-3, unlearn_loss="adaga", mask=mask,
                  seed=C.SEED, log_freq=10 ** 6, **place)
    mark("end")
    seconds = time.perf_counter() - t0
    if parallelism:
        torch.distributed.destroy_process_group()
    return {"marks": marks, "peak_gib": max(g for _, g in marks),
            "start_gib": base, "seconds": seconds}


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=2)
    p.add_argument("--only", choices=sorted(RUNS))
    args = p.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("CUDA is not available", file=sys.stderr)
        return 2
    if args.only:
        print(json.dumps(_run(RUNS[args.only][1], args.steps)))
        return 0
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    out = {}
    for name, (env, _) in RUNS.items():
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--steps", str(args.steps), "--only", name],
                           capture_output=True, text=True,
                           env={**os.environ, **env}, timeout=600)
        if r.returncode:
            print(r.stdout[-3000:], r.stderr[-3000:], flush=True)
            return r.returncode
        out[name] = json.loads(r.stdout.strip().splitlines()[-1])
    print(f"dit_forget, {args.steps} steps at 32 + 32: the largest peak "
          f"allocated GiB of each interval over the run, the interval named "
          f"by the stage that ends it (one device | tp | tp, record "
          f"streams); on {card}")
    worst = {name: {} for name in RUNS}
    for name in RUNS:
        for mark, gib in out[name]["marks"]:
            worst[name][mark] = max(gib, worst[name].get(mark, 0.0))
    for mark in dict.fromkeys(m for name in RUNS for m in worst[name]):
        cells = [f"{worst[name][mark]:8.3f}" if mark in worst[name]
                 else "     n/a" for name in RUNS]
        print(f"  {mark:24s} {' | '.join(cells)}")
    for name in RUNS:
        print(f"  {name}: peak {out[name]['peak_gib']:.3f} GiB, "
              f"{out[name]['seconds']:.2f} s", flush=True)
    print(json.dumps({"card": card, **{k: {"peak_gib": v["peak_gib"],
                                           "seconds": v["seconds"]}
                                       for k, v in out.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
