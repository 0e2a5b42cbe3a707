#!/usr/bin/env python3
"""Variants of the GroupNorm forward's split route, timed in turns.

    python3 scripts/profile_torch_gn_fwd_variants.py

Copies ``uurg_torch/`` into a temporary directory once per variant, patches
the copy's ``csrc/group_norm.cu`` (a patch that no longer applies fails the
run) or sets constants of its ``ops/group_norm.py`` in the timing process,
builds it with its own nvcc and times the
forward on the wrapper's route (device ms by CUDA-graph replay) at the
VAE's eight fp32 site shapes at batch 32, summed over an encode and a
decode, and at SD's five bf16 sites that fit no cluster at batch 4, summed.
The order is the tree as it is, then each variant, then the tree again, so
that the two readings of the tree bound the card's drift. Variants:

- ``forward_walk``: the normalise launch walks its run from the start, as
  the statistics launch did, instead of from the end;
- ``blocks2``, ``blocks8``: two or eight blocks an SM in all
  (``_SPLIT_BLOCKS``) instead of four;
- ``max1sm``: at most one SM's worth of runs a sample (``_SPLIT_MAX``)
  instead of two;
- ``unroll8``: the statistics loop unrolled eight times and the normalise
  launch's batches of eight loads, not four.

Ends with the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_WALK_BACK = '''  int k = (p1 - 1 - p0) / rows;        // this thread's last pixel: p0 + k rows
  for (; k >= kSplitUnroll - 1; k -= kSplitUnroll) {
    float v[kSplitUnroll][N];
#pragma unroll
    for (int u = 0; u < kSplitUnroll; ++u)
      Chunk<T>::load(x + base + static_cast<size_t>(p0 + (k - u) * rows) * C, v[u]);
#pragma unroll
    for (int u = 0; u < kSplitUnroll; ++u) {
#pragma unroll
      for (int i = 0; i < N; ++i) v[u][i] = v[u][i] * a[i] + b[i];
      Chunk<T>::store(y + base + static_cast<size_t>(p0 + (k - u) * rows) * C, v[u]);
    }
  }
  for (; k >= 0; --k) {'''
_WALK_FORWARD = '''  const int n = (p1 - 1 - p0) / rows + 1;
  int k = 0;
  for (; k + kSplitUnroll <= n; k += kSplitUnroll) {
    float v[kSplitUnroll][N];
#pragma unroll
    for (int u = 0; u < kSplitUnroll; ++u)
      Chunk<T>::load(x + base + static_cast<size_t>(p0 + (k + u) * rows) * C, v[u]);
#pragma unroll
    for (int u = 0; u < kSplitUnroll; ++u) {
#pragma unroll
      for (int i = 0; i < N; ++i) v[u][i] = v[u][i] * a[i] + b[i];
      Chunk<T>::store(y + base + static_cast<size_t>(p0 + (k + u) * rows) * C, v[u]);
    }
  }
  for (; k < n; ++k) {'''
# name -> [(file under uurg_torch/, regex, replacement)]
VARIANTS = {
    "forward_walk": [("csrc/group_norm.cu", re.escape(_WALK_BACK),
                      _WALK_FORWARD)],
    "blocks2": [], "blocks8": [], "max1sm": [],
    "unroll8": [("csrc/group_norm.cu", r"kSplitUnroll = 4;",
                 "kSplitUnroll = 8;"),
                ("csrc/group_norm.cu",
                 r"#pragma unroll 4\n  for \(int p = run_begin",
                 "#pragma unroll 8\n  for (int p = run_begin")],
}
# name -> {constant of ops/group_norm.py: its value, a function of _SMS}
SPLIT_RULE = {"blocks2": {"_SPLIT_BLOCKS": lambda sms: 2 * sms},
              "blocks8": {"_SPLIT_BLOCKS": lambda sms: 8 * sms},
              "max1sm": {"_SPLIT_MAX": lambda sms: sms}}


def make_tree(base: str, name: str) -> str:
    """A copy of uurg_torch/ (without its build) under ``base``/``name``,
    patched as ``VARIANTS[name]`` says."""
    tree = os.path.join(base, name)
    shutil.copytree(os.path.join(ROOT, "uurg_torch"),
                    os.path.join(tree, "uurg_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    for rel, pattern, new in VARIANTS.get(name, []):
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


def time_tree(tree: str, vae_sites: str) -> int:
    """In a child process: build ``tree``'s group_norm.cu and print the
    forward's times at the split sites (``vae_sites``: the VAE's site
    shapes with their counts, as JSON)."""
    sys.path.insert(0, ROOT)
    import chip_smoke as cs

    sys.path.insert(0, tree)
    import torch

    from uurg_torch.ops import _build
    from uurg_torch.ops import group_norm as GN

    for const, value in SPLIT_RULE.get(os.path.basename(tree), {}).items():
        setattr(GN, const, value(GN._SMS))
    GN._fwd_route.cache_clear()
    _build.sources = lambda: [_build.CSRC / "group_norm.cu"]
    _build.build_all()
    for line in _build.build_logs.get("group_norm", "").splitlines():
        if re.search(r"[1-9]\d* bytes spill", line):
            print(f"  spill: {line.strip()}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    sites = [(cs.VAE_BATCH, H, W, C, torch.float32, n)
             for H, W, C, n in json.loads(vae_sites)]
    sites += [(cs.SD_GN_BATCH, H, W, C, torch.bfloat16, 1)
              for H, W, C in cs.SD_GN_SITES]
    totals, per = {"vae": 0.0, "sd": 0.0}, []
    for B, H, W, C, dtype, n in sites:
        x = (torch.randn(B, H, W, C, generator=gen, device="cuda") * 2
             + 0.5).to(dtype)
        scale = torch.randn(C, generator=gen, device="cuda") * 0.2 + 1.0
        bias = torch.randn(C, generator=gen, device="cuda") * 0.2
        ms = cs.time_ms(lambda: GN._group_norm_kernel(x, scale, bias, 32,
                                                      1e-6), 5)[0]
        totals["vae" if dtype == torch.float32 else "sd"] += n * ms
        per.append(f"{H}x{W}x{C} {ms:.4f}")
        del x
        torch.cuda.empty_cache()
    print(f"{os.path.basename(tree)}: VAE encode + decode {totals['vae']:.4f} "
          f"ms, SD's five sites at batch {cs.SD_GN_BATCH} {totals['sd']:.4f} "
          f"ms | " + ", ".join(per), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--time-tree", help=argparse.SUPPRESS)
    ap.add_argument("--vae-sites", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.time_tree:
        return time_tree(args.time_tree, args.vae_sites)
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from uurg_torch.models.autoencoder_kl import init_vae

    print(f"== card: {cs.card_line()}", flush=True)
    # the VAE's site shapes, counted once by an encode and a decode here
    counts = cs.vae_gn_site_counts(init_vae(0, device="cuda"))
    vae_sites = json.dumps([[*shape, enc + dec] for shape, (enc, dec)
                            in sorted(counts.items())])
    base = tempfile.mkdtemp(prefix="uurg_gn_fwd_variants_")
    try:
        for name in ["as_is", *VARIANTS, "as_is_again"]:
            tree = make_tree(base, name)
            subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--time-tree", tree, "--vae-sites", vae_sites],
                           check=True)
    finally:
        shutil.rmtree(base, ignore_errors=True)
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
