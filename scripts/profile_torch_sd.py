#!/usr/bin/env python3
"""Phase 20 of ``chip_smoke.py`` alone, on one GPU: Stable Diffusion.

    python3 scripts/profile_torch_sd.py

Builds the kernels, then runs ``chip_smoke.sd_path``: the attention
kernels at the SD UNet's three (T, D) and GroupNorm at its 14 site shapes
at batch 4 against their plain versions, timed beside SDPA and
``F.group_norm`` (the backward's ``split`` sites on a line of their own),
the UNet against its plain path under both remat policies, a Fisher batch
by kernel family, the three samplers with the VAE's decode, and
``sd_generate_fisher`` (~2.5 min with the build). Prints the phase's
``kernels`` rows and writes every number to
``chiprun_out/sd_phase.json``.
"""
from __future__ import annotations

import json
import os
import shutil
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the four counters' sources and the Pallas kernels they replace
META = {name: {"source": source, "replaces": replaces}
        for name, source, replaces in (
            ("attention_fwd", "uurg_torch/csrc/flash_attention_fwd.cu",
             "uurg_tpu/ops/flash_attention.py:49"),
            ("attention_bwd", "uurg_torch/csrc/flash_attention_bwd.cu",
             "uurg_tpu/ops/flash_attention.py:113"),
            ("group_norm_fwd", "uurg_torch/csrc/group_norm.cu",
             "uurg_tpu/ops/group_norm.py:38"),
            ("group_norm_bwd", "uurg_torch/csrc/group_norm.cu",
             "uurg_tpu/ops/group_norm.py:60"))}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from uurg_torch.ops import _build

    t0 = time.time()
    _build.build_all()
    card = cs.card_line()
    print(f"built in {time.time() - t0:.1f} s; {card}; torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    work = tempfile.mkdtemp(prefix="uurg_sd_")
    try:
        sd = cs.sd_path(card, torch.Generator(device="cuda").manual_seed(
            cs.SEED), work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    rows = cs.sd_kernel_rows(sd, META)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "sd_phase.json"), "w") as f:
        json.dump({"card": card, "sd": sd, "kernels": rows}, f, indent=1,
                  default=str)
    print(json.dumps({"kernels": rows}))
    print(f"phase 20 done in {time.time() - t0:.1f} s on {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
