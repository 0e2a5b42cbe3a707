#!/usr/bin/env python3
"""Phase 22 of ``chip_smoke.py`` alone, on one GPU: Stable Diffusion's
evaluation.

    python3 scripts/profile_torch_sd_eval.py

Builds the kernels, writes phase 20's seeded PNG folders and the seeded
full-width SD UNet as a CompVis ``final.pt`` (where the whole script reads
``nsfw_removal``'s), then runs ``chip_smoke.sd_eval_path``:
``generate_images`` (lms at the CLI's settings, ddim and plms at 4 steps;
exact launch counts, PNGs bit-equal to the phase's own sampler), the
decode timed, ``imageclassify``, ``nudenet_classes`` on recorded heads and
``compute_fid`` (~2 min with the build). Writes every number to
``chiprun_out/sd_eval_phase.json``.
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
    from uurg_torch.cli.sd_common import save_unet
    from uurg_torch.core.device import resolve_device
    from uurg_torch.models.sd_unet import SDUNetConfig, init_sd_unet
    from uurg_torch.ops import _build

    t0 = time.time()
    _build.build_all()
    resolve_device("cuda")                  # TF32 off, as every entry point
    card = cs.card_line()
    print(f"built in {time.time() - t0:.1f} s; {card}; torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    work = tempfile.mkdtemp(prefix="uurg_sd_eval_")
    try:
        cs.sd_png_folders(work)
        save_unet(os.path.join(work, "nsfw_removal", "final.pt"),
                  init_sd_unet(cs.SEED, SDUNetConfig(), "cuda"))
        torch.cuda.empty_cache()
        t1 = time.time()
        out = cs.sd_eval_path(card, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    secs = time.time() - t1
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "sd_eval_phase.json"),
              "w") as f:
        json.dump({"card": card, "sd_eval": out, "phase_seconds": secs}, f,
                  indent=1, default=str)
    print(f"phase 22 done in {secs:.1f} s ({time.time() - t0:.1f} s in "
          f"all) on {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
