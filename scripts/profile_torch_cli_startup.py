#!/usr/bin/env python3
"""What a new process of a port CLI pays before its work, on one GPU
machine: the seconds of ``import torch`` (and of the DDPM runner and the
trainer CLI after it, and of CUDA's start) in a fresh interpreter, three
times with one bytecode cache shared by the three (the first fills it) and
once without one; then ``python -m uurg_torch.cli.train --mode pretrain``
and ``--mode generate_fisher`` at ``configs/cifar10_sfron.yml``'s full width
(2 iterations; the stand-in data), the second under ``cProfile`` (its top
entries printed); last, one 2048 x 2048 ``scipy.linalg.sqrtm``, the host
work of an FID.

    python3 scripts/profile_torch_cli_startup.py

``chip_smoke.py`` phase 14b runs the north-star CLIs as processes: these
are the costs that set that phase's length. Prints the machine's
``PYTHON*`` variables, the card's name and power limit.
"""
from __future__ import annotations

import os
import pstats
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMPORTS = ("import sys, time; t = time.time(); import torch; a = time.time(); "
           "import uurg_torch.workloads.ddpm_runner, uurg_torch.cli.train; "
           "b = time.time(); torch.zeros(1, device='cuda'); "
           "torch.cuda.synchronize(); c = time.time(); "
           "print(f'import torch {a - t:.2f} s, the runner and CLI "
           "{b - a:.2f} s, CUDA start {c - b:.2f} s; bytecode cache "
           "{sys.pycache_prefix}')")


def run(cmd: list[str], env: dict, cwd: str) -> str:
    t0 = time.time()
    out = subprocess.run(cmd, cwd=cwd, env=env, capture_output=True,
                         text=True, timeout=600)
    print(f"[{time.time() - t0:.2f} s, exit {out.returncode}] "
          f"{' '.join(cmd[1:4])[:100]}", flush=True)
    if out.returncode != 0:
        print(out.stdout[-2000:], out.stderr[-3000:], flush=True)
        raise SystemExit(1)
    return out.stdout


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from uurg_torch.ops import _build

    print(cs.card_line(), {k: v for k, v in os.environ.items()
                           if k.startswith("PYTHON")}, flush=True)
    _build.build_all()
    work = tempfile.mkdtemp(prefix="uurg_startup_")
    try:
        measure(work, cs)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(cs.card_line())
    return 0


def measure(work: str, cs) -> None:
    env = dict(os.environ, PYTHONPATH=ROOT,
               PYTHONPYCACHEPREFIX=os.path.join(work, "pycache"))
    env.pop("PYTHONDONTWRITEBYTECODE", None)
    for _ in range(3):
        print(run([sys.executable, "-c", IMPORTS], env, work).strip())
    bare = dict(os.environ, PYTHONPATH=ROOT)
    print(run([sys.executable, "-c", IMPORTS], bare, work).strip(),
          "(the machine's own environment)")
    exp = os.path.join(work, "exp")
    common = ["--config", cs.SFRON_YML, "--exp", exp, "--seed", "0"]
    pre = run([sys.executable, "-m", "uurg_torch.cli.train", *common,
               "--mode", "pretrain", "--n_iters", "2"], env, work)
    pre = pre.strip().splitlines()[-1].removeprefix("done: ")
    prof = os.path.join(work, "fisher.prof")
    run([sys.executable, "-m", "cProfile", "-o", prof, "-m",
         "uurg_torch.cli.train", *common, "--mode", "generate_fisher",
         "--ckpt_folder", pre, "--threshold", "1.0"], env, work)
    pstats.Stats(prof).sort_stats("tottime").print_stats(15)
    import numpy as np
    import scipy.linalg

    a = np.random.default_rng(0).standard_normal((2048, 2048))
    t0 = time.time()
    scipy.linalg.sqrtm(a @ a.T / 2048)
    print(f"one 2048 x 2048 sqrtm: {time.time() - t0:.2f} s on "
          f"{os.cpu_count()} host cores", flush=True)


if __name__ == "__main__":
    sys.exit(main())
