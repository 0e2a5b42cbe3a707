#!/usr/bin/env python3
"""Phase 25 of ``chip_smoke.py`` alone: ring attention and the DiT
pipeline on a one-rank NCCL group, on one GPU.

    python3 scripts/profile_torch_sp_pp.py

Builds the kernels, then runs ``chip_smoke.ring_loopback`` (the ring's
arithmetic over 2 and 4 ranks in this process at DiT-XL/2's and SD's
attention shapes and DiT's float32 one, against the plain attention, timed
beside one whole kernel call), phase 23's one-device and FSDP runs of
``dit_forget`` and ``nsfw_removal`` (``dp_dit``, ``dp_sd``) and phase 25's
runs against them (``sp_pp_dit``: ``sp`` on data=1,seq=1, ``pp`` on
stage=1 in 1 and 2 microbatches; ``sp_sd``: ``nsfw_removal`` under ``sp``
on seq=1). Prints what those functions print, each part's seconds and the
card's name and power limit; writes their records to
``chiprun_out/phase25.json``. Exits with the first failed gate's error.
"""
from __future__ import annotations

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    import torch
    import torch.distributed as dist

    import chip_smoke as C
    from uurg_torch.ops import _build
    from uurg_torch.parallel import initialize_distributed, make_mesh
    from uurg_torch.parallel.dist import free_port

    if not torch.cuda.is_available():
        print("CUDA is not available: this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    t0 = time.time()
    _build.build_all()
    print(f"built in {time.time() - t0:.1f} s", flush=True)
    card = C.card_line()
    print(f"{card}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)
    gen = torch.Generator(device="cuda").manual_seed(C.SEED)
    out = {"card": card}
    initialize_distributed(f"127.0.0.1:{free_port()}", 1, 0, "cuda")
    try:
        mesh = make_mesh({"data": 1, "model": 1})
        for part, run in (
                ("ring_loopback", lambda: C.ring_loopback(card, gen)),
                ("sp_pp_dit", lambda: C.sp_pp_dit(
                    card, *C.dp_dit(card, mesh)[1:])),
                ("sp_sd", lambda: C.sp_sd(
                    card, *C.dp_sd(card, mesh, gen)[1:]))):
            t = time.time()
            out[part] = run()
            out[f"{part}_s"] = time.time() - t
            print(f"{part}: {out[f'{part}_s']:.1f} s (with phase 23's runs "
                  f"it compares with)", flush=True)
            C._collect()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "phase25.json"), "w") as f:
        json.dump(out, f, indent=1, default=str)
    print(f"done in {time.time() - t0:.1f} s on {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
