#!/usr/bin/env python3
"""The port's GroupNorm kernels alone, on one GPU: build, check, time.

    python3 scripts/profile_torch_group_norm.py [--clusters]
    python3 scripts/profile_torch_group_norm.py --bwd [--clusters] [--batch 256]
    python3 scripts/profile_torch_group_norm.py --vae [--tree CHECKOUT]
    python3 scripts/profile_torch_group_norm.py --bwd --sd [--tree CHECKOUT]
        [--runs 66,132] [--tag NAME]

Builds the kernels (the full nvcc / ptxas output goes to
``chiprun_out/build_<source>.log``) and prints the ptxas lines of
``group_norm.cu``; holds the forward against its plain PyTorch version at
the shapes off the main path that ``chip_smoke.py`` holds (fp32, ragged
slices, the ``split`` route, small batches; three runs with equal bits);
then, at the eleven shapes of a UNet forward at batch 256 in bf16, checks
and times the route the wrapper chooses and the ``split`` route (device ms
by CUDA-graph replay, and eager ms launched from Python), each beside its
bound and beside ``Tensor.copy_`` of x (the same bytes moved by PyTorch's
copy kernel, with no arithmetic: what the card's memory gives a kernel that
reads and writes once), and sums them over the forward's 51 sites. ``--clusters`` also times
the ``slab`` route at every cluster size that fits, to tune the choice. An
empty kernel's replay time is the floor under the small shapes. Ends with
the card's name and power limit. A quick check for work on
``uurg_torch/csrc/group_norm.cu``; ``chip_smoke.py`` stays the whole proof.

``--vae`` times the forward where it takes the ``split`` route: at the
VAE's eight fp32 site shapes at batch 32 (the sites counted by one encode
and decode of the full VAE at 256 px; summed over an encode and a decode)
and at SD's five bf16 UNet sites that fit no cluster at batch 4, each
checked against the plain version, timed by CUDA-graph replay beside
``F.group_norm`` and beside its bound (one read of x and one write of y)
and the split route's floor (1.5 times that: x read twice). ``--tree``
imports ``uurg_torch`` from another checkout (an earlier commit unpacked
by ``git archive``), so that two versions can be timed in turns on one
card, each in its own process.

``--bwd`` does the same for the backward kernel (one launch a call: dx,
and dscale and dbias folded over the batch): the off-path shapes of
``chip_smoke.py``'s phase 11, then the eleven shapes at batch 128 (one
SFR-on phase; ``--batch 256`` for the Fisher pass's), the chosen route,
``split`` and with ``--clusters`` every cluster size, each beside its bound
and beside ``torch.add(x, g, out=dx)``: the same bytes (two tensors read,
one written) with no arithmetic. Sums per UNet backward.

``--bwd --sd`` times the backward at SD's 33 GroupNorm sites a UNet
backward that no cluster holds (nine bf16 shapes at batch 4,
``chip_smoke.SD_BWD_SPLIT_SITES``) on the route the wrapper chooses,
checked against the plain version, beside ``F.group_norm``'s backward, the
bound (x and g read once, dx written once) and the split route's two-read
floor (5/3 of it), per shape and summed; ``--runs`` also times the split
route at those runs a sample. With ``--tree`` (an earlier checkout) the
parent's route is timed the same way, so that two versions can be timed in
turns on one card, each in its own process; ``--tag`` names the JSON it
writes (``chiprun_out/profile_group_norm_bwd_sd_<tag>.json``).
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
    second = f"{routes[1][0]}{routes[1][1]}"
    return {"sites": count, "route": routes[0][0], "cluster": routes[0][1],
            "bound_ms": bound, "ms": ms, "eager_ms": eager,
            "alt_route": second, "alt_ms": times[second][0],
            "yard_ms": yard_ms, "times": times}


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
        routes = cs.gn_routes(H * H, C, 2, GROUPS, batch=batch)
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


def vae_and_sd(cs, GN, gen):
    """The forward at the VAE's fp32 sites (batch 32) and SD's bf16 sites
    that fit no cluster (batch 4), on the route the wrapper chooses."""
    import torch
    import torch.nn.functional as F

    from uurg_torch.models.autoencoder_kl import init_vae

    vae = init_vae(0, device="cuda")
    counts = cs.vae_gn_site_counts(vae)
    del vae
    torch.cuda.empty_cache()
    shapes = [(cs.VAE_BATCH, H, W, C, torch.float32, enc + dec)
              for (H, W, C), (enc, dec) in sorted(counts.items())]
    shapes += [(cs.SD_GN_BATCH, H, W, C, torch.bfloat16, 0)
               for H, W, C in cs.SD_GN_SITES]
    rows = []
    for B, H, W, C, dtype, sites in shapes:
        x = (torch.randn(B, H, W, C, generator=gen, device="cuda") * 2
             + 0.5).to(dtype)
        scale = torch.randn(C, generator=gen, device="cuda") * 0.2 + 1.0
        bias = torch.randn(C, generator=gen, device="cuda") * 0.2
        got = GN._group_norm_kernel(x, scale, bias, GROUPS, 1e-6)
        torch.cuda.synchronize()
        want = GN.group_norm_plain(x, scale, bias, GROUPS, 1e-6)
        tol = (cs.GN_FP32_ATOL, cs.GN_FP32_RTOL) if dtype == torch.float32 \
            else (cs.ATOL, cs.RTOL)
        cs.compare(f"{B}x{H}x{W}x{C} {dtype}", got[0], want, *tol)
        del got, want
        x_nchw = x.permute(0, 3, 1, 2)
        sl, bl = scale.to(dtype), bias.to(dtype)
        ms, eager = cs.time_ms(
            lambda: GN._group_norm_kernel(x, scale, bias, GROUPS, 1e-6), 5)
        lib = cs.time_ms(lambda: F.group_norm(x_nchw, GROUPS, sl, bl, 1e-6),
                         5)[0]
        bound = 2 * x.numel() * x.element_size() / cs.HBM_BYTES_PER_S * 1e3
        route = (GN._fwd_route(H * W, C, x.element_size(), GROUPS, B)
                 if hasattr(GN, "_split_count") else
                 GN._fwd_route(H * W, C, x.element_size(), GROUPS))
        rows.append({"B": B, "H": H, "W": W, "C": C, "dtype": str(dtype),
                     "sites": sites, "route": route, "ms": ms,
                     "eager_ms": eager, "library_ms": lib, "bound_ms": bound,
                     "floor_ms": 1.5 * bound})
        print(f"  {B}x{H}x{W}x{C} {str(dtype)[6:]} x{sites} ({route[0]}, "
              f"{route[1]}): {ms:.4f} ms (eager {eager:.4f}), F.group_norm "
              f"{lib:.4f}, bound {bound:.4f}, two-read floor "
              f"{1.5 * bound:.4f}", flush=True)
        del x, x_nchw
        torch.cuda.empty_cache()
    vae_rows = [r for r in rows if r["sites"]]
    for key in ("ms", "library_ms", "bound_ms", "floor_ms"):
        print(f"== VAE encode + decode ({sum(r['sites'] for r in vae_rows)} "
              f"sites) {key}: "
              f"{sum(r[key] * r['sites'] for r in vae_rows):.4f}", flush=True)
    return rows


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
        routes = cs.gn_routes(H * H, C, 2, GROUPS, backward=True,
                              batch=batch)
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


def sd_backward(cs, GN, gen, runs):
    """The backward at SD's split sites at batch 4, on the route the
    wrapper chooses (``_bwd_route`` took no batch before the split route:
    the parent's is asked without one)."""
    import torch
    import torch.nn.functional as F

    B = cs.SD_BATCH
    rows = []
    for H, W, C, sites in cs.SD_BWD_SPLIT_SITES:
        x = (torch.randn(B, H, W, C, generator=gen, device="cuda") * 2
             + 0.5).to(torch.bfloat16)
        g = torch.randn(B, H, W, C, generator=gen,
                        device="cuda").to(torch.bfloat16)
        scale = torch.randn(C, generator=gen, device="cuda") * 0.2 + 1.0
        bias = torch.randn(C, generator=gen, device="cuda") * 0.2
        _, mean, rstd = GN.group_norm_plain(x, scale, bias, GROUPS, 1e-6,
                                            True)
        try:
            route = GN._bwd_route(H * W, C, 2, GROUPS, B)
        except TypeError:
            route = GN._bwd_route(H * W, C, 2, GROUPS)
        want = GN.group_norm_bwd_plain(x, scale, mean, rstd, g)
        tag = f"{B}x{H}x{W}x{C} ({route[0]}, {route[1]})"

        def check(key, got):
            cs.compare(f"{tag} {key} dx", got[0], want[0])
            cs.rel_l2(f"{tag} {key} dscale", got[1], want[1],
                      cs.GN_SUM_REL_L2)
            cs.rel_l2(f"{tag} {key} dbias", got[2], want[2],
                      cs.GN_SUM_REL_L2)

        check("chosen", GN.group_norm_bwd(x, scale, mean, rstd, g))
        ms, eager = cs.time_ms(lambda: GN.group_norm_bwd(x, scale, mean,
                                                         rstd, g))
        alt = {}
        for S in runs:
            if route[0] != "split" or S > H * W:
                continue
            r = ("split", S)
            check(f"S={S}", GN._group_norm_bwd_kernel(x, scale, mean, rstd,
                                                      g, route=r))
            alt[S] = cs.time_ms(lambda r=r: GN._group_norm_bwd_kernel(
                x, scale, mean, rstd, g, route=r))[0]
        s16, b16 = scale.to(torch.bfloat16), bias.to(torch.bfloat16)
        lib, stream = cs.library_bwd(
            lambda a, w, b: F.group_norm(a, GROUPS, w, b, 1e-6),
            (x.permute(0, 3, 1, 2), s16, b16), g.permute(0, 3, 1, 2))
        lib_ms = cs.time_ms(lib, stream=stream)[0]
        numel = x.numel()
        bound = (3 * numel * 2 + 3 * C * 4 + 2 * B * GROUPS * 4) \
            / cs.HBM_BYTES_PER_S * 1e3
        rows.append({"B": B, "H": H, "W": W, "C": C, "sites": sites,
                     "route": list(route), "ms": ms, "eager_ms": eager,
                     "library_ms": lib_ms, "bound_ms": bound,
                     "floor_ms": 5 / 3 * bound, "runs_ms": alt})
        print(f"  {tag} x{sites}: {ms:.4f} ms (eager {eager:.4f}), "
              f"F.group_norm backward {lib_ms:.4f}, bound {bound:.4f}, "
              f"two-read floor {5 / 3 * bound:.4f}"
              + "".join(f"; S={k} {v:.4f}" for k, v in alt.items()),
              flush=True)
        del x, g, want, lib
        torch.cuda.empty_cache()
    for key in ("ms", "eager_ms", "library_ms", "bound_ms", "floor_ms"):
        print(f"== SD's {sum(r['sites'] for r in rows)} split sites a UNet "
              f"backward at batch {B}, {key}: "
              f"{sum(r[key] * r['sites'] for r in rows):.4f}", flush=True)
    return rows


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--clusters", action="store_true",
                    help="time the slab route at every cluster size that fits")
    ap.add_argument("--bwd", action="store_true",
                    help="the backward kernel instead of the forward")
    ap.add_argument("--batch", type=int, default=None,
                    help="batch (default: 256 forward, 128 backward)")
    ap.add_argument("--vae", action="store_true",
                    help="the forward at the VAE's and SD's split sites")
    ap.add_argument("--tree", default=None,
                    help="import uurg_torch from this checkout instead")
    ap.add_argument("--sd", action="store_true",
                    help="with --bwd: SD's split sites at batch 4")
    ap.add_argument("--runs", default="",
                    help="with --sd: also time the split route at these "
                         "runs a sample (comma-separated)")
    ap.add_argument("--tag", default="",
                    help="with --sd: a name for the JSON written")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs            # this checkout's, whatever --tree says

    if args.tree:
        sys.path.insert(0, os.path.abspath(args.tree))
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
    if args.bwd and args.sd:
        print(f"== SD's split sites, backward ({GN.__file__})", flush=True)
        rows = sd_backward(cs, GN, gen,
                           [int(r) for r in args.runs.split(",") if r])
        name = "profile_group_norm_bwd_sd" + (f"_{args.tag}" if args.tag
                                              else "")
        with open(os.path.join(out_dir, f"{name}.json"), "w") as f:
            json.dump({"card": cs.card_line(), "tree": args.tree,
                       "per_shape": rows}, f, indent=1)
        print(cs.card_line())
        return 0
    if args.vae:
        print(f"== the split sites ({GN.__file__})", flush=True)
        rows = vae_and_sd(cs, GN, gen)
        with open(os.path.join(out_dir, "profile_group_norm_vae.json"),
                  "w") as f:
            json.dump({"card": cs.card_line(), "tree": args.tree,
                       "per_shape": rows}, f, indent=1)
        print(cs.card_line())
        return 0
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
          f"{total('ms'):.4f} ms (eager {total('eager_ms'):.4f}), "
          f"{rows[0]['alt_route']} route {total('alt_ms'):.4f} ms, bound "
          f"{total('bound_ms'):.4f} ms, {yard} {total('yard_ms'):.4f} ms",
          flush=True)
    name = "profile_group_norm_bwd" if args.bwd else "profile_group_norm"
    with open(os.path.join(out_dir, f"{name}_b{batch}.json"), "w") as f:
        json.dump({"card": cs.card_line(), "batch": batch,
                   "empty_kernel_ms": floor_ms, "per_shape": rows}, f,
                  indent=1)
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
