#!/usr/bin/env python3
"""Phase 21 of ``chip_smoke.py`` alone, on one GPU: Stable Diffusion's
unlearning methods.

    python3 scripts/profile_torch_sd_methods.py

Builds the kernels, runs phase 20's ``sd_generate_fisher`` (its seeded PNG
folders, Fishers and mask at full width), then ``chip_smoke.
sd_methods_path``: the SD layout of ``generate_fisher_mask`` against the
Fisher CLI's mask, ``nsfw_removal``'s SFR-on step at batch 4 + 4 (steps/s,
device ms by kernel family, peak memory, exact launch counts) under the
mask dense and packed and under xattn, one full-width prox timed, and the
five method CLIs in process (~4 min with the build). Writes every number
to ``chiprun_out/sd_methods_phase.json``.
"""
from __future__ import annotations

import json
import os
import shutil
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from uurg_torch.core.device import resolve_device
    from uurg_torch.ops import _build

    t0 = time.time()
    _build.build_all()
    resolve_device("cuda")                  # TF32 off, as every entry point
    card = cs.card_line()
    print(f"built in {time.time() - t0:.1f} s; {card}; torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    work = tempfile.mkdtemp(prefix="uurg_sd_")
    try:
        fisher = cs.sd_fisher_cli(work, card)
        torch.cuda.empty_cache()
        t1 = time.time()
        out = cs.sd_methods_path(
            card, torch.Generator(device="cuda").manual_seed(cs.SEED), work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    secs = time.time() - t1
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "sd_methods_phase.json"),
              "w") as f:
        json.dump({"card": card, "fisher_cli": fisher, "sd_methods": out,
                   "phase_seconds": secs}, f, indent=1, default=str)
    print(f"phase 21 done in {secs:.1f} s ({time.time() - t0:.1f} s in "
          f"all) on {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
