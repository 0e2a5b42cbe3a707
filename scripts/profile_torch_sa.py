#!/usr/bin/env python3
"""Where the time of the port's Selective Amnesia goes, on one GPU.

    python3 scripts/profile_torch_sa.py [--n_chunks 20] [--n_samples 256]
        [--batch_size 4] [--steps 5] [--warmup 2] [--pairs 10]

On the full-width cifar10_sa CondUNet (seeded random init, bf16 compute,
the synthetic CIFAR-10 stand-in):
1. ``uurg_torch.cli.fim.generate_fim`` at the CLI's defaults (20 chunks of
   50 timesteps x 256 examples, batch 4: 5,120 examples, each one forward
   and one backward at batch 50): host clock per chunk, between two waits
   for the device, the whole call, examples/s. Then one batch of it under
   ``torch.profiler``: device time per example by kernel group, the busy
   share, kernel launches and the host ops with the most self time.
2. ``ddpm_runner.sa_forget`` from the Fisher just written, at batch 128,
   under ``torch.profiler`` for ``--steps`` steps after ``--warmup``: the
   same table per step.
3. The EWC pull leaf by leaf with autograd (``ewc_plain``) in place of the
   port's ``workloads.ddpm.ewc_penalty`` (multi-tensor ops for all leaves
   in one ``autograd.Function``): SA steps profiled as in 2, then
   ``--pairs`` pairs of unprofiled turns of both, which form goes first
   alternating, each turn's median step on the host clock.
The full profiler tables go to ``chiprun_out/profile_torch_sa.txt``.
"""
from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def ewc_plain(model, fisher, params_mle):
    """The EWC pull ``sum F (p - p_mle)^2`` leaf by leaf with autograd."""
    return sum((fisher[k] * (p - params_mle[k]) ** 2).sum()
               for k, p in model.named_parameters())


def report(prof, n: int, wall: float, what: str, out) -> None:
    """Device ms per ``what`` by kernel group, busy share of ``wall`` (s,
    for ``n`` of them), launches and top host ops; the full table to
    ``out``."""
    import torch

    from profile_torch_sfron import ANNOTATIONS, group_of

    avgs = prof.key_averages()
    events = [e for e in avgs
              if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
              and not e.key.startswith(ANNOTATIONS)]
    if not events:
        raise RuntimeError("profiler recorded no device kernels")
    key = ("self_device_time_total"
           if hasattr(events[0], "self_device_time_total")
           else "self_cuda_time_total")
    busy = sum(getattr(e, key) for e in events) / 1e3        # ms
    groups: dict[str, float] = {}
    for e in events:
        g = group_of(e.key)
        groups[g] = groups.get(g, 0.0) + getattr(e, key) / 1e3
    host = [e for e in avgs
            if getattr(e, "device_type", None) == torch.autograd.DeviceType.CPU
            and not e.key.startswith(ANNOTATIONS)]
    launches = sum(e.count for e in host if "LaunchKernel" in e.key)
    print(f"  wall {wall / n * 1e3:.3f} ms/{what}, device busy "
          f"{busy / n:.3f} ms/{what} ({100 * busy / 1e3 / wall:.1f}% of "
          f"wall), {launches / n:.0f} kernel launches/{what}")
    print(f"  device time per {what} by group:")
    for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"    {g:22s} {ms / n:9.3f} ms  {100 * ms / busy:5.1f}%")
    print(f"  top host ops (self CPU ms per {what}, calls per {what}):")
    for e in sorted(host, key=lambda e: -e.self_cpu_time_total)[:12]:
        print(f"    {e.self_cpu_time_total / n / 1e3:8.3f} ms "
              f"{e.count / n:7.1f}x  {e.key[:80]}")
    out.write(f"== per {what}, {n} profiled\n")
    out.write(avgs.table(sort_by=key, row_limit=60) + "\n")


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--n_chunks", type=int, default=20)
    p.add_argument("--n_samples", type=int, default=256)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--warmup", type=int, default=2)
    p.add_argument("--pairs", type=int, default=10)
    args = p.parse_args()
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    if not torch.cuda.is_available():
        print("needs a CUDA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import numpy as np

    from chip_smoke import SA_CONFIG, SEED
    from uurg_torch.cli import fim
    from uurg_torch.core.config import Config
    from uurg_torch.unlearn import fisher as F
    from uurg_torch.workloads import ddpm as W
    from uurg_torch.workloads import ddpm_runner as R
    from uurg_torch.workloads.ddpm import DDPMWorkload

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"card: {card}")
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    out = open(os.path.join(ROOT, "chiprun_out", "profile_torch_sa.txt"), "w")
    out.write(f"{card}\n")
    folder = tempfile.mkdtemp(prefix="uurg_sa_profile_")

    class Args:
        ckpt_folder = folder
        n_chunks = args.n_chunks
        n_samples = args.n_samples
        batch_size = args.batch_size
        seed = SEED
        label_to_forget = 0

    # 1. the per-sample Fisher at the CLI's defaults
    config = Config(SA_CONFIG)
    batches = []
    make = F.make_per_sample_fisher_step

    def timed_make(loss_fn):
        step = make(loss_fn)

        def timed(fisher, model, batch, seed):
            step(fisher, model, batch, seed)
            torch.cuda.synchronize()
            batches.append((time.perf_counter(), int(batch[0].shape[0])))

        return timed

    F.make_per_sample_fisher_step = timed_make
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fim.generate_fim(Args, config)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_ex = sum(b for _, b in batches)
    per_batch = np.diff([t for t, _ in batches])
    per_chunk = len(batches) // args.n_chunks
    # chunk i ends at its last batch's stamp; chunk 1 pays the warm-up
    chunk_s = [batches[(i + 1) * per_chunk - 1][0]
               - batches[i * per_chunk - 1][0]
               for i in range(1, args.n_chunks)] or [float("nan")]
    print(f"SA Fisher: {args.n_chunks} chunks x {args.n_samples} examples "
          f"(batch {args.batch_size}) = {n_ex} examples in {wall:.3f} s "
          f"({n_ex / wall:.3f} examples/s, with init and file); median "
          f"{np.median(per_batch) / args.batch_size * 1e3:.3f} ms/example; "
          f"chunks 2-{args.n_chunks}: median {np.median(chunk_s):.3f} s, "
          f"min {min(chunk_s):.3f}, max {max(chunk_s):.3f}")
    F.make_per_sample_fisher_step = make
    # one batch of the same pass, under the profiler
    wl = DDPMWorkload.from_config(config)
    model = R.load_params(Args, config, wl).eval()
    step = F.make_per_sample_fisher_step(wl.elbo_chunk_loss_fn())
    chunk = wl.schedule.num_timesteps // args.n_chunks
    batch = R._device_batch(config, *R._load_train_dataset(Args, config)
                            .get_batch(np.arange(args.batch_size)), wl.device)
    batch += (torch.arange(chunk, device=wl.device).expand(args.batch_size,
                                                           chunk),)
    acc = {k: torch.zeros_like(q) for k, q in model.named_parameters()}
    step(acc, model, batch, SEED)
    torch.cuda.synchronize()
    with profile(activities=activities, acc_events=True) as prof:
        t0 = time.perf_counter()
        step(acc, model, batch, SEED)
        torch.cuda.synchronize()
        b_wall = time.perf_counter() - t0
    print(f"one batch of {args.batch_size} examples, profiled:")
    report(prof, args.batch_size, b_wall, "example", out)
    del model, acc

    # 2. SA steps from the Fisher of part 1 (sa_forget builds its step
    # with make_sfron_step)
    n = args.warmup + args.steps
    sa_cfg = config.merged({"training": {
        "n_iters": n, "snapshot_freq": 10 ** 6, "log_freq": 10 ** 6}})
    make_sa = R.make_sfron_step

    def sa_steps(profiled: bool) -> list[float]:
        """Run sa_forget for n steps; return each step's end on the host
        clock. ``profiled``: steps after the warm-up under the profiler,
        reported; else a wait for the device after every step."""
        stamps = []

        def timed_make_sa(*a, **k):
            step = make_sa(*a, **k)

            def timed(*sa, **sk):
                res = step(*sa, **sk)
                if not profiled or len(stamps) in (args.warmup - 1, n - 1):
                    torch.cuda.synchronize()
                stamps.append(time.perf_counter())
                if profiled:
                    sa_prof.step()
                return res

            return timed

        R.make_sfron_step = timed_make_sa
        try:
            if not profiled:
                R.sa_forget(Args, sa_cfg, os.path.join(folder, "sa"))
                return stamps
            with profile(activities=activities,
                         schedule=schedule(wait=0, warmup=args.warmup,
                                           active=args.steps, repeat=1),
                         acc_events=True) as sa_prof:
                R.sa_forget(Args, sa_cfg, os.path.join(folder, "sa"))
        finally:
            R.make_sfron_step = make_sa
        print(f"  {args.steps} steps profiled after {args.warmup} warm-up "
              f"(batch {config.training.batch_size}):")
        report(sa_prof, args.steps, stamps[n - 1] - stamps[args.warmup - 1],
               "step", out)
        return stamps

    print("SA steps, the port's EWC pull (multi-tensor ops):")
    sa_steps(True)

    # 3. the EWC pull leaf by leaf, against the port's multi-tensor form
    port_form = W.ewc_penalty
    forms = {"plain": ewc_plain, "foreach": port_form}
    turns = {k: [] for k in forms}
    try:
        W.ewc_penalty = ewc_plain
        print("SA steps, the EWC pull leaf by leaf:")
        sa_steps(True)
        for i in range(args.pairs):
            order = ("plain", "foreach") if i % 2 == 0 else ("foreach",
                                                            "plain")
            for name in order:
                W.ewc_penalty = forms[name]
                turns[name].append(float(np.median(np.diff(
                    sa_steps(False)[args.warmup - 1:]))))
    finally:
        W.ewc_penalty = port_form
    wins = sum(p > f for p, f in zip(turns["plain"], turns["foreach"]))
    print(f"EWC pull, {args.pairs} pairs of turns (order alternating), each "
          f"turn's median of {args.steps} steps after {args.warmup}, no "
          f"profiler; the multi-tensor form faster in {wins} of "
          f"{args.pairs} pairs:")
    for name, t in turns.items():
        q1, q2, q3 = np.percentile(t, [25, 50, 75]) * 1e3
        print(f"  {name:7s} median {q2:.3f} ms/step, quartiles {q1:.3f}-"
              f"{q3:.3f}; turns {[round(x * 1e3, 3) for x in t]}")
    shutil.rmtree(folder, ignore_errors=True)
    out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
