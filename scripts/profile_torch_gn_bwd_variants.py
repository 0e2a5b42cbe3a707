#!/usr/bin/env python3
"""Variants of the GroupNorm backward kernel's batch fold, timed in turns.

    python3 scripts/profile_torch_gn_bwd_variants.py [--batch 128]
    python3 scripts/profile_torch_gn_bwd_variants.py --sd

Copies ``uurg_torch/`` into a temporary directory once per variant, patches
the copy's ``csrc/group_norm.cu`` or ``ops/group_norm.py`` (a patch that no
longer applies fails the run), builds it with its own nvcc and times the
backward on the wrapper's route at the eleven GroupNorm shapes of a UNet
backward (bf16, device ms by CUDA-graph replay), summed per UNet backward.
The order is the tree as it is, then each variant, then the tree again, so
that the two readings of the tree bound the card's drift. Variants:

- ``no_fold``: the batch fold cut out (dscale and dbias are not computed:
  timing only), the floor under the one-launch design;
- ``no_fence``: the arrival without its fence (unordered: timing only);
- ``two_launches``: the fold replaced by a second launch that sums the
  batch's rows in order, one thread a column (the earlier reduce kernel);
- ``fold8``, ``fold32``: groups of 8 or 32 samples instead of 16;
- ``chunks8``, ``chunks2``: a slice in up to 8 or 2 bulk copies, not 4;
- ``threads512``: 512 threads a slab block, not 256 (the route may change).

``--sd`` times the split route instead, at SD's 33 GroupNorm backward
sites a UNet backward that no cluster holds (nine bf16 shapes at batch 4,
``chip_smoke.SD_BWD_SPLIT_SITES``), summed per UNet backward, with the
variants of ``SD_VARIANTS``:

- ``blocks1``, ``blocks4``: one or four blocks an SM in all, not two;
- ``pixels8``, ``pixels32``: runs of at least 8 or 32 pixels, not 16;
- ``lanes_rows8``: fold_runs' lanes each adding at most 8 rows, not 16;
- ``fold_rows8``: fold_runs loading 8 rows a lane at once, not 16;
- ``lanes4``: four lanes a column whatever S (the forward's fold);
- ``unroll2``, ``unroll8``: 16-byte loads in flight a thread, not 4;
- ``no_group_fold``: the dx launch's fold of the group rows cut out (dx
  is wrong: timing only), the fold's cost.

Ends with the card's name and power limit.
"""
from __future__ import annotations

import argparse
import os
import re
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_FOLD_CALL = (r"  fold_batch\(old, part, part \+ static_cast<size_t>\(B\) \* 2 "
              r"\* C, work, counters, B, C,\n\s+fold, sample, (1|S)\);\n")
_REDUCE = '''__global__ void two_reduce_kernel(const float* part, float* out, int B,
                                  int C) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= 2 * C) return;
  float a = 0.f;
  for (int b = 0; b < B; ++b) a += part[static_cast<size_t>(b) * 2 * C + j];
  out[j] = a;
}

template <typename T>
int launch_bwd('''
_SLAB_END = ("ctr, B, HW, C, G, fold, S);\n  if (err != cudaSuccess) return "
             "static_cast<int>(err);\n")
# name -> [(file under uurg_torch/, regex, replacement)]
VARIANTS = {
    "no_fold": [("csrc/group_norm.cu", _FOLD_CALL, "")],
    "no_fence": [("csrc/group_norm.cu",
                  r"    __threadfence\(\);\n    old = atomicAdd",
                  "    old = atomicAdd")],
    "two_launches": [
        ("csrc/group_norm.cu", _FOLD_CALL, ""),
        ("csrc/group_norm.cu", r"template <typename T>\nint launch_bwd\(",
         _REDUCE),
        ("csrc/group_norm.cu", re.escape(_SLAB_END),
         _SLAB_END + "  two_reduce_kernel<<<(2 * C + 255) / 256, 256, 0, "
                     "stream>>>(wk + 2 * C, wk, B, C);\n")],
    "fold8": [("ops/group_norm.py", r"_FOLD_ROWS, _FOLD_GROUPS = 16, 64",
               "_FOLD_ROWS, _FOLD_GROUPS = 8, 64")],
    "fold32": [("ops/group_norm.py", r"_FOLD_ROWS, _FOLD_GROUPS = 16, 64",
                "_FOLD_ROWS, _FOLD_GROUPS = 32, 64")],
    "chunks8": [("csrc/group_norm.cu", r"kSlabChunks = 4;", "kSlabChunks = 8;"),
                ("csrc/group_norm.cu", r"kSlabChunkBytes = 16384;",
                 "kSlabChunkBytes = 8192;")],
    "chunks2": [("csrc/group_norm.cu", r"kSlabChunks = 4;", "kSlabChunks = 2;"),
                ("csrc/group_norm.cu", r"kSlabChunkBytes = 16384;",
                 "kSlabChunkBytes = 32768;")],
    "threads512": [("csrc/group_norm.cu", r"kSlabThreads = 256;",
                    "kSlabThreads = 512;"),
                   ("ops/group_norm.py", r"_SLAB_THREADS = 256 ",
                    "_SLAB_THREADS = 512 ")],
}


_BLOCKS = r"_BWD_SPLIT_BLOCKS, _BWD_MIN_PIXELS = 2 \* _SMS, 16"
_LANES = r"while \(lanes < 32 && lanes \* kFoldRows < S\) lanes <<= 1;"
_UNROLL = r"kSplitUnroll = 4;"
SD_VARIANTS = {
    "blocks1": [("ops/group_norm.py", _BLOCKS,
                 "_BWD_SPLIT_BLOCKS, _BWD_MIN_PIXELS = 1 * _SMS, 16")],
    "blocks4": [("ops/group_norm.py", _BLOCKS,
                 "_BWD_SPLIT_BLOCKS, _BWD_MIN_PIXELS = 4 * _SMS, 16")],
    "pixels8": [("ops/group_norm.py", _BLOCKS,
                 "_BWD_SPLIT_BLOCKS, _BWD_MIN_PIXELS = 2 * _SMS, 8")],
    "pixels32": [("ops/group_norm.py", _BLOCKS,
                  "_BWD_SPLIT_BLOCKS, _BWD_MIN_PIXELS = 2 * _SMS, 32")],
    "lanes_rows8": [("csrc/group_norm.cu", _LANES,
                     "while (lanes < 32 && lanes * 8 < S) lanes <<= 1;")],
    "fold_rows8": [("csrc/group_norm.cu", r"kFoldRows = 16;",
                    "kFoldRows = 8;")],
    "lanes4": [("csrc/group_norm.cu", _LANES, "lanes = 4;")],
    "unroll2": [("csrc/group_norm.cu", _UNROLL, "kSplitUnroll = 2;")],
    "unroll8": [("csrc/group_norm.cu", _UNROLL, "kSplitUnroll = 8;")],
    "no_group_fold": [(
        "csrc/group_norm.cu",
        r"  fold_runs\(grps \+ static_cast<size_t>\(sample\) \* S \* 2 \* G, "
        r"S, 2 \* G, 2 \* G, smem, lanes\);\n", "")],
}


def make_tree(base: str, name: str, variants: dict) -> str:
    """A copy of uurg_torch/ (without its build) under ``base``/``name``,
    patched as ``variants[name]`` says."""
    tree = os.path.join(base, name)
    shutil.copytree(os.path.join(ROOT, "uurg_torch"),
                    os.path.join(tree, "uurg_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    for rel, pattern, new in variants.get(name, []):
        path = os.path.join(tree, "uurg_torch", rel)
        with open(path) as f:
            text = f.read()
        text, n = re.subn(pattern, lambda _m: new, text)
        if n == 0:
            raise RuntimeError(f"{name}: patch {pattern[:40]!r} no longer "
                               f"applies to {rel}")
        with open(path, "w") as f:
            f.write(text)
    return tree


def time_tree(tree: str, batch: int, sd: bool) -> int:
    """In a child process: build ``tree``'s group_norm.cu and print the
    backward's times (at SD's split sites with ``sd``)."""
    sys.path.insert(0, tree)
    import torch

    sys.path.insert(1, ROOT)
    import chip_smoke as cs
    from uurg_torch.ops import _build
    from uurg_torch.ops import group_norm as GN

    _build.sources = lambda: [_build.CSRC / "group_norm.cu"]
    _build.build_all()
    for line in _build.build_logs.get("group_norm", "").splitlines():
        if re.search(r"[1-9]\d* bytes spill", line):
            print(f"  spill: {line.strip()}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    total, per = 0.0, []
    if sd:
        batch = cs.SD_BATCH
        sites_list = cs.SD_BWD_SPLIT_SITES
    else:
        sites_list = [(H, H, C, n) for H, C, n in cs.GN_SITES]
    for H, W, C, sites in sites_list:
        x = (torch.randn(batch, H, W, C, generator=gen, device="cuda") * 2
             + 0.5).to(torch.bfloat16)
        g = torch.randn(batch, H, W, C, generator=gen,
                        device="cuda").to(torch.bfloat16)
        scale = torch.randn(C, generator=gen, device="cuda") * 0.2 + 1.0
        _, mean, rstd = GN.group_norm_plain(x, scale, scale, 32, 1e-6, True)
        ms = cs.time_ms(lambda: GN._group_norm_bwd_kernel(
            x, scale, mean, rstd, g))[0]
        total += sites * ms
        route = GN._bwd_route(H * W, C, 2, 32, batch)
        per.append(f"{H}x{W}x{C} {ms:.4f}"
                   + (f" (S={route[1]})" if route[0] == "split" else ""))
    print(f"{os.path.basename(tree)}: {total:.4f} ms per UNet backward at "
          f"batch {batch} | " + ", ".join(per), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--sd", action="store_true",
                    help="the split route at SD's sites, SD_VARIANTS")
    ap.add_argument("--time-tree", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.time_tree:
        return time_tree(args.time_tree, args.batch, args.sd)
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs

    print(f"== card: {cs.card_line()}", flush=True)
    base = tempfile.mkdtemp(prefix="uurg_gn_variants_")
    try:
        variants = SD_VARIANTS if args.sd else VARIANTS
        for name in ["as_is", *variants, "as_is_again"]:
            tree = make_tree(base, name, variants)
            subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--time-tree", tree, "--batch", str(args.batch)]
                           + (["--sd"] if args.sd else []), check=True)
    finally:
        shutil.rmtree(base, ignore_errors=True)
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
