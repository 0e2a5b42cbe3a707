#!/usr/bin/env python3
"""DiT-XL/2 SFR-on step medians of two checkouts in turns, on one GPU.

    git archive PARENT | tar -x -C .chip_tree/parent
    python3 scripts/profile_torch_dit_turns.py .chip_tree/parent . \\
        [--remat full|attn] [--turns 4]

Runs each checkout's own ``chip_smoke.dit_train`` (``dit_forget`` on
DiT-XL/2 from a seeded, perturbed checkpoint, batch 32 forget + 32 remain,
2 warm-up steps, 1 profiled, 10 timed) in a process of its own, in the
order A B B A (``--turns`` 4) or A B B A A B ..., on the same stand-in
latents, checkpoint and mask: a seeded random mask of ~50% density written
once, as the phase-18 CLIs would write a Fisher mask. Host-clock step
medians of one call land on one card and one host, so a difference between
the two checkouts is read against the spread of each one's own turns.
Each turn also reports what can stall a step on the host: the Python
garbage collector's collections of generation 2 (count, longest, total
ms) and the CUDA caching allocator's retries and device allocations.
"""
from __future__ import annotations

import argparse
import gc
import os
import subprocess
import sys
import tempfile
import time


def one(tree: str, work: str, remat: str) -> None:
    """The timed steps of ``tree`` (run in a process of its own)."""
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    os.chdir(tree)
    import torch

    import chip_smoke as cs
    from uurg_torch.io.checkpoint import save_checkpoint
    from uurg_torch.models.dit import DiT_configs, init_dit

    data = os.path.join(work, "latents")
    if not os.path.isdir(data):
        data = cs.dit_stand_in(work)
    ckpt = os.path.join(work, "dit_xl2_seeded.pt")
    if not os.path.exists(ckpt):
        ckpt = cs.dit_checkpoint(work)
    mask_path = os.path.join(work, "mask_random_0.5")
    if not os.path.exists(mask_path):
        model = init_dit(cs.SEED, DiT_configs[cs.DIT_NAME](), "cpu")
        gen = torch.Generator().manual_seed(cs.SEED)
        save_checkpoint(mask_path, {
            k: torch.rand(p.shape, generator=gen) < 0.5
            for k, p in model.named_parameters()})
        del model
    torch.cuda.empty_cache()
    card = cs.card_line()
    full_gc = []                                 # ms of each gen-2 collection

    def on_gc(phase, info, start=[0.0]):
        if phase == "start":
            start[0] = time.perf_counter()
        elif info["generation"] == 2:
            full_gc.append((time.perf_counter() - start[0]) * 1e3)

    gc.callbacks.append(on_gc)
    out, _, _ = cs.dit_train(data, ckpt, mask_path,
                             None if remat == "full" else remat, card)
    gc.callbacks.remove(on_gc)
    stats = torch.cuda.memory_stats()
    print(f"RESULT {tree} remat {remat}: median {out['median_step_ms']:.3f} "
          f"ms, device work {out['busy_ms_profiled_step']:.3f} ms in the "
          f"profiled step, peak {out['peak_gib']:.3f} GiB, steps "
          f"{[round(t, 3) for t in out['step_ms']]}; gen-2 collections "
          f"{len(full_gc)} (longest {max(full_gc, default=0):.1f} ms, total "
          f"{sum(full_gc):.1f} ms); allocator retries "
          f"{stats.get('num_alloc_retries', 0)}, device allocations "
          f"{stats.get('num_device_alloc', 0)}; on {card}", flush=True)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("trees", nargs=2, help="checkout A, checkout B")
    p.add_argument("--remat", default="full", choices=("full", "attn"))
    p.add_argument("--turns", type=int, default=4)
    p.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--work", help=argparse.SUPPRESS)
    args = p.parse_args()
    if args.one:
        one(args.trees[0], args.work, args.remat)
        return 0
    pattern = (0, 1, 1, 0)
    order = [args.trees[pattern[i % 4]] for i in range(args.turns)]
    work = tempfile.mkdtemp(prefix="uurg_dit_turns_")
    failed = 0
    for tree in order:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), tree, tree, "--one",
             "--work", work, "--remat", args.remat],
            capture_output=True, text=True)
        lines = [ln for ln in proc.stdout.splitlines()
                 if ln.startswith("RESULT") or "remat" in ln]
        print("\n".join(lines) or proc.stdout[-2000:], flush=True)
        if proc.returncode != 0:
            print(proc.stderr[-4000:], flush=True)
            failed += 1
    subprocess.run(["rm", "-rf", work])
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
