#!/usr/bin/env python3
"""Variants of the xwide attention backward (padded head widths 320-512,
``uurg_torch/csrc/flash_attention_xwide_bwd.cu``), timed in turns.

    python3 scripts/profile_torch_attention_xwide_variants.py [--only NAME ...]

Copies ``uurg_torch/`` into a temporary directory once per variant, patches
the copy's ``csrc/flash_attention_xwide_bwd.cu`` (a patch that no longer
applies fails the run), builds every copy's source and the xwide forward's
at once (one nvcc each),
then in a child process per copy prints ptxas's registers and spills of
the key pass and the dq pass, the relative L2 error of dq, dk, dv against
``attention_bwd_plain`` at (2, 1, 100, 512) and (2, 1, 77, 320) in both
dtypes, and the device ms (CUDA-graph replay) of one backward call and of
each of its kernels (torch.profiler) at the CondUNet's (128, 1, 256, 512)
bf16 and the VAE's (32, 1, 1024, 512) float32. The order is the tree as it
is, each variant, then the tree again, so that the two readings of the
tree bound the card's drift. Variants:

- ``trunc_split``: the TF32 high part of a float32 operand truncated by
  masking its low 13 bits (one logic op; the tree rounds it to nearest by
  an add and the mask);
- ``cvt_split``: the high part by ``cvt.rna.tf32.f32``, as the xwide
  forward takes it (the same bits as the tree's);
- ``one_stream``: the key pass loads Q and dO once a tile (the gradient
  sweep multiplies whatever the ring holds): its results are wrong, its
  time says what the second read of Q and dO from L2 costs;
- ``two_stages``: rings of two stages in both passes and dtypes (the
  float32 key pass has two at width 512 already);
- ``six_stages``: rings of up to six stages where shared memory holds
  them (bf16), not four;
- ``unroll1``: the float32 gradient sweep's query loop not unrolled;
- ``scores_unroll2``: the float32 score sweep's column loop unrolled by 2
  (it is unrolled fully);
- ``unroll``: the float32 gradient sweep's query loop fully unrolled (it
  is unrolled by 2).

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
_CU = "csrc/flash_attention_xwide_bwd.cu"
VARIANTS = {
    "trunc_split": [
        (r"  hi = \(__float_as_uint\(x\) \+ 0x1000u\) & 0xffffe000u;",
         "  hi = __float_as_uint(x) & 0xffffe000u;")],
    "cvt_split": [
        (r"  hi = \(__float_as_uint\(x\) \+ 0x1000u\) & 0xffffe000u;",
         '  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(hi) : "f"(x));')],
    "one_stream": [
        (r"    if \(iq0 < T\)\n      keys_issue",
         "    if (iq0 < T && ic < Tiles<D, In>::NC)\n      keys_issue")],
    "two_stages": [
        (r"< 4 \? static_cast<int>\(\(kSmem - fixed\) / stage\)\n\s*: 4;",
         "< 2 ? static_cast<int>((kSmem - fixed) / stage) : 2;")],
    "six_stages": [
        (r"< 4 \? static_cast<int>\(\(kSmem - fixed\) / stage\)\n\s*: 4;",
         "< 6 ? static_cast<int>((kSmem - fixed) / stage) : 6;")],
    "unroll1": [
        (r"#pragma unroll 2\n        for \(int s = 0; s < kQ / 8; \+\+s\)",
         "#pragma unroll 1\n        for (int s = 0; s < kQ / 8; ++s)")],
    "scores_unroll2": [
        (r"#pragma unroll\n        for \(int s = 0; s < kC / 8; \+\+s\)",
         "#pragma unroll 2\n        for (int s = 0; s < kC / 8; ++s)")],
    "unroll": [
        (r"#pragma unroll 2\n        for \(int s = 0; s < kQ / 8; \+\+s\)",
         "#pragma unroll\n        for (int s = 0; s < kQ / 8; ++s)")],
}
# timing-only variants: their results are not the function's
WRONG = {"one_stream"}
CHECK = ((2, 1, 100, 512), (2, 1, 77, 320))
TIMED = (((128, 1, 256, 512), "bfloat16"), ((32, 1, 1024, 512), "float32"))


def make_tree(base: str, name: str) -> str:
    """A copy of uurg_torch/ (without its build) under ``base``/``name``,
    patched as ``VARIANTS[name]`` says."""
    tree = os.path.join(base, name)
    shutil.copytree(os.path.join(ROOT, "uurg_torch"),
                    os.path.join(tree, "uurg_torch"),
                    ignore=shutil.ignore_patterns("__pycache__", "build"))
    path = os.path.join(tree, "uurg_torch", _CU)
    with open(path) as f:
        text = f.read()
    for pattern, new in VARIANTS.get(name, []):
        text, n = re.subn(pattern, lambda m: new, text, flags=re.S)
        if n == 0:
            raise RuntimeError(f"{name}: patch {pattern[:40]!r} no longer "
                               f"applies to {_CU}")
    with open(path, "w") as f:
        f.write(text)
    return tree


def _source(_build):
    return _build.CSRC / "flash_attention_xwide_bwd.cu"


def _sources(_build):
    # the xwide forward gives the backward its o and lse
    return [_source(_build), _build.CSRC / "flash_attention_f32.cu"]


def build_tree(tree: str) -> int:
    """In a child process: build ``tree``'s xwide backward source."""
    sys.path.insert(0, tree)
    from uurg_torch.ops import _build

    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    from profile_torch_attention_xwide import ptxas_lines

    _build.sources = lambda: _sources(_build)
    _build.build_all()
    for line in ptxas_lines(_build.build_logs[_source(_build).stem],
                            lambda s: "dq" in s or "keys" in s):
        print(f"  {os.path.basename(tree)}: {line}", flush=True)
    return 0


def time_tree(tree: str) -> int:
    """In a child process: check ``tree``'s xwide backward (built by
    ``build_tree``) and print its times."""
    sys.path.insert(0, tree)
    import torch

    sys.path.insert(1, ROOT)
    import chip_smoke as cs
    from uurg_torch.ops import _build
    from uurg_torch.ops import flash_attention as FA

    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    from profile_torch_attention_xwide import kernel_ms

    torch.backends.cuda.matmul.allow_tf32 = False
    name = os.path.basename(tree)
    _build.sources = lambda: _sources(_build)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for dtype in (torch.float32, torch.bfloat16):
        for B, H, T, D in CHECK:
            q, k, v, g = (torch.randn(B, H, T, D, generator=gen,
                                      device="cuda", dtype=dtype)
                          for _ in range(4))
            o, lse = FA._attention_kernel(q, k, v, with_lse=True)
            got = FA.attention_bwd(q, k, v, o, lse, g)
            want = FA.attention_bwd_plain(q, k, v, g)
            errs = [((a.double() - b.double()).norm()
                     / b.double().norm()).item() for a, b in zip(got, want)]
            print(f"  {name} {str(dtype)[6:]} T={T} D={D}: rel dq dk dv "
                  + " ".join(f"{e:.3e}" for e in errs), flush=True)
    out = []
    for (B, H, T, D), dt in TIMED:
        dtype = getattr(torch, dt)
        q, k, v, g = (torch.randn(B, H, T, D, generator=gen, device="cuda",
                                  dtype=dtype) for _ in range(4))
        o, lse = FA._attention_kernel(q, k, v, with_lse=True)
        run = lambda: FA.attention_bwd(q, k, v, o, lse, g)  # noqa: E731
        ms = cs.time_ms(run, 10)[0]
        parts = kernel_ms(run)
        out.append(f"{dt} {ms:.4f} ms (" + ", ".join(
            f"{n.removeprefix('attn_bwd_xwide_').removeprefix('attn_')} "
            f"{t:.4f}" for n, t in parts.items()) + ")")
        del q, k, v, g, o, lse
    print(f"{name}{' (timing only)' if name in WRONG else ''}: "
          + " | ".join(out), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--time-tree", help=argparse.SUPPRESS)
    ap.add_argument("--build-tree", help=argparse.SUPPRESS)
    ap.add_argument("--only", nargs="*", help="variants to run (default all)")
    args = ap.parse_args()
    if args.time_tree:
        return time_tree(args.time_tree)
    if args.build_tree:
        return build_tree(args.build_tree)
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs

    print(f"== card: {cs.card_line()}", flush=True)
    base = tempfile.mkdtemp(prefix="uurg_xwide_bwd_variants_")
    try:
        names = ["as_is", *(args.only or VARIANTS)]
        trees = [make_tree(base, n) for n in names]
        builds = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                                    "--build-tree", t]) for t in trees]
        if any(p.wait() != 0 for p in builds):
            raise RuntimeError("a variant did not build")
        for tree in trees + [trees[0]]:
            subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--time-tree", tree], check=True)
    finally:
        shutil.rmtree(base, ignore_errors=True)
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
