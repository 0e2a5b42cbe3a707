#!/usr/bin/env python3
"""The port's GroupNorm kernels alone, on one GPU: build, check, time.

    python3 scripts/profile_torch_group_norm.py [--clusters]
    python3 scripts/profile_torch_group_norm.py --bwd [--clusters] [--batch 256]

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

``--bwd`` does the same for the backward kernel (one launch a call: dx,
and dscale and dbias folded over the batch): the off-path shapes of
``chip_smoke.py``'s phase 11, then the eleven shapes at batch 128 (one
SFR-on phase; ``--batch 256`` for the Fisher pass's), the chosen route,
``sweep`` and with ``--clusters`` every cluster size, each beside its bound
and beside ``torch.add(x, g, out=dx)``: the same bytes (two tensors read,
one written) with no arithmetic. Sums per UNet backward.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

GROUPS = 32


def time_routes(cs, label, routes, run, check, bound, count, yard_ms):
    """Check and time ``run(route)`` on each route (the chosen one first);
    print one line; return the shape's row."""
    times = {}
    for route in routes:
        key = f"{route[0]}{route[1]}"
        check(key, run(route))
        times[key] = cs.time_ms(lambda route=route: run(route))
    chosen = f"{routes[0][0]}{routes[0][1]}"
    ms, eager = times[chosen]
    print(f"  {label} x{count}: {routes[0][0]} S={routes[0][1]} {ms:.4f} "
          f"({eager:.4f}) = {ms / bound:.2f} x bound {bound:.4f}; yardstick "
          f"{yard_ms:.4f}, " + ", ".join(
              f"{k} {t:.4f} ({e:.4f})" for k, (t, e) in times.items()
              if k != chosen), flush=True)
    return {"sites": count, "route": routes[0][0], "cluster": routes[0][1],
            "bound_ms": bound, "ms": ms, "eager_ms": eager,
            "sweep_ms": times["sweep1"][0], "yard_ms": yard_ms,
            "times": times}


def forward(cs, GN, gen, batch, clusters):
    import torch

    print(f"== forward at batch {batch}, bf16, G = {GROUPS}: device ms a "
          f"launch by CUDA-graph replay (eager ms in brackets)", flush=True)
    rows = []
    for H, C, count in cs.GN_SITES:
        x = (torch.randn(batch, H, H, C, generator=gen, device="cuda") * 2
             + 0.5).to(torch.bfloat16)
        scale = torch.randn(C, generator=gen, device="cuda") * 0.2 + 1.0
        bias = torch.randn(C, generator=gen, device="cuda") * 0.2
        want = GN.group_norm_plain(x, scale, bias, GROUPS, 1e-6)
        routes = cs.gn_routes(H * H, C, 2, GROUPS)
        numel = batch * H * H * C
        bound = (2 * numel * 2 + 2 * C * 4 + 2 * batch * GROUPS * 4) \
            / cs.HBM_BYTES_PER_S * 1e3
        out = torch.empty_like(x)
        rows.append({"H": H, "W": H, "C": C, **time_routes(
            cs, f"{H}x{H}x{C} ({H * H * C // 512} KB a sample)",
            routes if clusters else routes[:2],
            lambda r: GN._group_norm_kernel(x, scale, bias, GROUPS, 1e-6,
                                            route=r),
            lambda key, got: cs.compare(f"H=W={H} C={C} {key}", got[0], want),
            bound, count, cs.time_ms(lambda: out.copy_(x))[0])})
    return rows, "a copy of x"


def backward(cs, GN, gen, batch, clusters):
    import torch

    print(f"== backward at batch {batch}, bf16, G = {GROUPS}: device ms a "
          f"launch by CUDA-graph replay (eager ms in brackets)", flush=True)
    rows = []
    for H, C, count in cs.GN_SITES:
        x = (torch.randn(batch, H, H, C, generator=gen, device="cuda") * 2
             + 0.5).to(torch.bfloat16)
        g = torch.randn(batch, H, H, C, generator=gen,
                        device="cuda").to(torch.bfloat16)
        scale = torch.randn(C, generator=gen, device="cuda") * 0.2 + 1.0
        _, mean, rstd = GN.group_norm_plain(x, scale, scale, GROUPS, 1e-6,
                                            True)
        want = GN.group_norm_bwd_plain(x, scale, mean, rstd, g)
        routes = cs.gn_routes(H * H, C, 2, GROUPS, backward=True)
        numel = batch * H * H * C
        bound = (3 * numel * 2 + 3 * C * 4 + 2 * batch * GROUPS * 4) \
            / cs.HBM_BYTES_PER_S * 1e3

        def check(key, got):
            tag = f"H=W={H} C={C} {key}"
            cs.compare(f"{tag} dx", got[0], want[0])
            cs.rel_l2(f"{tag} dscale", got[1], want[1], cs.GN_SUM_REL_L2)
            cs.rel_l2(f"{tag} dbias", got[2], want[2], cs.GN_SUM_REL_L2)

        dx = torch.empty_like(x)
        rows.append({"H": H, "W": H, "C": C, **time_routes(
            cs, f"{H}x{H}x{C} ({H * H * C // 256} KB of x and g a sample)",
            routes if clusters else routes[:2],
            lambda r: GN._group_norm_bwd_kernel(x, scale, mean, rstd, g,
                                                route=r),
            check, bound, count,
            cs.time_ms(lambda: torch.add(x, g, out=dx))[0])})
    return rows, "torch.add(x, g, out=dx)"


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--clusters", action="store_true",
                    help="time the slab route at every cluster size that fits")
    ap.add_argument("--bwd", action="store_true",
                    help="the backward kernel instead of the forward")
    ap.add_argument("--batch", type=int, default=None,
                    help="batch (default: 256 forward, 128 backward)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from uurg_torch.ops import _build
    from uurg_torch.ops import group_norm as GN

    batch = args.batch or (128 if args.bwd else 256)
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
    if args.bwd:
        cs.check_gn_bwd_offpath(gen)
    else:
        cs.check_gn_offpath(gen)

    empty = _build.function("group_norm", "uurg_empty_launch",
                            [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    floor_ms = cs.time_ms(lambda: empty(
        batch, 256, torch.cuda.current_stream().cuda_stream))[0]
    print(f"== an empty kernel ({batch} blocks of 256 threads) in a replayed "
          f"graph: {floor_ms:.4f} ms a launch", flush=True)

    rows, yard = (backward if args.bwd else forward)(cs, GN, gen, batch,
                                                     args.clusters)

    def total(key):
        return sum(r[key] * r["sites"] for r in rows)

    print(f"== per UNet {'backward' if args.bwd else 'forward'} at batch "
          f"{batch} ({sum(r['sites'] for r in rows)} sites): chosen routes "
          f"{total('ms'):.4f} ms (eager {total('eager_ms'):.4f}), sweep "
          f"route {total('sweep_ms'):.4f} ms, bound {total('bound_ms'):.4f} "
          f"ms, {yard} {total('yard_ms'):.4f} ms", flush=True)
    name = "profile_group_norm_bwd" if args.bwd else "profile_group_norm"
    with open(os.path.join(out_dir, f"{name}_b{batch}.json"), "w") as f:
        json.dump({"card": cs.card_line(), "batch": batch,
                   "empty_kernel_ms": floor_ms, "per_shape": rows}, f,
                  indent=1)
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
