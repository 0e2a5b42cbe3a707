#!/usr/bin/env python3
"""The port's GroupNorm forward kernel alone, on one GPU: build, check, time.

    python3 scripts/profile_torch_group_norm.py [--clusters]

Builds the kernels (the full nvcc / ptxas output goes to
``chiprun_out/build_<source>.log``) and prints the ptxas lines of
``group_norm.cu``; holds the forward against its plain PyTorch version at
the shapes off the main path that ``chip_smoke.py`` holds (fp32, ragged
slices, the ``sweep`` route, small batches; three runs with equal bits);
then, at the eleven shapes of a UNet forward at batch 256 in bf16, checks
and times the route the wrapper chooses and the ``sweep`` route (device ms
by CUDA-graph replay, and eager ms launched from Python), each beside its
bound and beside ``Tensor.copy_`` of x (the same bytes moved by PyTorch's
copy kernel, with no arithmetic: what the card's memory gives a kernel that
reads and writes once), and sums them over the forward's 51 sites. ``--clusters`` also times
the ``slab`` route at every cluster size that fits, to tune the choice. An
empty kernel's replay time is the floor under the small shapes. Ends with
the card's name and power limit. A quick check for work on
``uurg_torch/csrc/group_norm.cu``; ``chip_smoke.py`` stays the whole proof.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BATCH, GROUPS = 256, 32
# (H = W, C, sites in one forward of the full-width CIFAR-10 CondUNet)
SHAPES = ((32, 128, 8), (16, 256, 11), (32, 256, 2), (4, 256, 12),
          (32, 384, 1), (16, 512, 2), (8, 256, 7), (16, 384, 1), (4, 512, 3),
          (8, 512, 3), (16, 128, 1))


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--clusters", action="store_true",
                    help="time the slab route at every cluster size that fits")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from uurg_torch.ops import _build
    from uurg_torch.ops import group_norm as GN

    print(f"== card: {cs.card_line()}; torch {torch.__version__}", flush=True)
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    try:
        _build.build_all()
    finally:
        for name, log in _build.build_logs.items():
            with open(os.path.join(out_dir, f"build_{name}.log"), "w") as f:
                f.write(log)
            for line in log.splitlines():
                if name == "group_norm" and "Compiling" not in line or any(
                        w in line for w in ("warning", "error", "Warning")):
                    print(f"  [{name}] {line.strip()[:200]}", flush=True)

    gen = torch.Generator(device="cuda").manual_seed(0)
    print("== off the main path", flush=True)
    cs.check_gn_offpath(gen)

    empty = _build.function("group_norm", "uurg_empty_launch",
                            [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    floor_ms = cs.time_ms(lambda: empty(
        BATCH, 256, torch.cuda.current_stream().cuda_stream))[0]
    print(f"== an empty kernel ({BATCH} blocks of 256 threads) in a replayed "
          f"graph: {floor_ms:.4f} ms a launch", flush=True)

    print(f"== forward at batch {BATCH}, bf16, G = {GROUPS}: device ms a "
          f"launch by CUDA-graph replay (eager ms in brackets)", flush=True)
    rows = []
    for H, C, count in SHAPES:
        x = (torch.randn(BATCH, H, H, C, generator=gen, device="cuda") * 2
             + 0.5).to(torch.bfloat16)
        scale = torch.randn(C, generator=gen, device="cuda") * 0.2 + 1.0
        bias = torch.randn(C, generator=gen, device="cuda") * 0.2
        want = GN.group_norm_plain(x, scale, bias, GROUPS, 1e-6)
        chosen = GN._fwd_route(H * H, C, 2, GROUPS)
        routes = cs.gn_routes(H * H, C, 2, GROUPS)
        if not args.clusters:
            routes = routes[:2]
        numel = BATCH * H * H * C
        bound = (2 * numel * 2 + 2 * C * 4 + 2 * BATCH * GROUPS * 4) \
            / cs.HBM_BYTES_PER_S * 1e3
        row = {"H": H, "W": H, "C": C, "sites": count, "slab_kb": H * H * C // 512,
               "route": chosen[0], "cluster": chosen[1], "bound_ms": bound,
               "times": {}}
        for route in routes:
            def run(route=route):
                return GN._group_norm_kernel(x, scale, bias, GROUPS, 1e-6,
                                             route=route)

            key = f"{route[0]}{route[1]}"
            y = run()[0]
            torch.cuda.synchronize()
            cs.compare(f"H=W={H} C={C} {key}", y, want)
            row["times"][key] = cs.time_ms(run)
        ms, eager = row["times"][f"{chosen[0]}{chosen[1]}"]
        out = torch.empty_like(x)
        copy_ms = cs.time_ms(lambda: out.copy_(x))[0]
        row.update(ms=ms, eager_ms=eager, copy_ms=copy_ms,
                   sweep_ms=row["times"]["sweep1"][0])
        rows.append(row)
        print(f"  {H}x{H}x{C} x{count} ({row['slab_kb']} KB a sample): "
              f"{chosen[0]} S={chosen[1]} {ms:.4f} ({eager:.4f}) = "
              f"{ms / bound:.2f} x bound {bound:.4f}; copy_ {copy_ms:.4f}, "
              + ", ".join(
                  f"{k} {t:.4f} ({e:.4f})" for k, (t, e) in
                  row["times"].items() if k != f"{chosen[0]}{chosen[1]}"),
              flush=True)

    def total(key):
        return sum(r[key] * r["sites"] for r in rows)

    print(f"== per UNet forward ({sum(r['sites'] for r in rows)} sites): "
          f"chosen routes {total('ms'):.4f} ms (eager {total('eager_ms'):.4f})"
          f", sweep route {total('sweep_ms'):.4f} ms, bound "
          f"{total('bound_ms'):.4f} ms, a copy of x {total('copy_ms'):.4f} ms",
          flush=True)
    with open(os.path.join(out_dir, "profile_group_norm.json"), "w") as f:
        json.dump({"card": cs.card_line(), "empty_kernel_ms": floor_ms,
                   "per_shape": rows}, f, indent=1)
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
