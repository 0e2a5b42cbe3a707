#!/usr/bin/env python3
"""Variants of the xwide attention backward (padded head widths 320-512,
``uurg_torch/csrc/flash_attention_xwide_bwd.cu``), or with ``--forward`` of
the bf16 xwide forward (``uurg_torch/csrc/flash_attention_xwide_fwd.cu``),
timed in turns.

    python3 scripts/profile_torch_attention_xwide_variants.py [--forward]
        [--only NAME ...]

Copies ``uurg_torch/`` into a temporary directory once per variant, patches
the copy's ``csrc/flash_attention_xwide_bwd.cu`` (a patch that no longer
applies fails the run), builds every copy's source and the xwide forwards'
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

With ``--forward`` the copies patch ``flash_attention_xwide_fwd.cu``; each
child prints the forward's ptxas lines, its largest absolute error against
``attention_plain`` in bf16 at the same two shapes, and the device ms of
one forward at the CondUNet's (256, 1, 256, 512) and (128, 1, 256, 512).
Forward variants:

- ``keys32``: K and V in tiles of 32 keys, two of each in flight (the
  tree: 64 keys, one of each);
- ``whole_scores``: each warpgroup sums the scores over all of D, with no
  exchange and no barrier between the warpgroups (the tree: each over half
  of D, the halves meeting in shared memory);
- ``kv_once``: K and V loaded for an item's first key tile only, the
  later tiles multiplied on what the buffers hold (timing only: what
  loading K and V costs).

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
_FWD_CU = "csrc/flash_attention_xwide_fwd.cu"
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
FWD_VARIANTS = {
    "keys32": [
        (r"constexpr int kBK = 64;", "constexpr int kBK = 32;"),
        (r"constexpr int kStages = 1;", "constexpr int kStages = 2;")],
    "whole_scores": [
        (r"constexpr bool kSplitScores = true;",
         "constexpr bool kSplitScores = false;")],
    "kv_once": [
        (r"(          mbar_expect_tx\(b\.([kv])_full \+ 8 \* s, X::kKVBytes\);\n"
         r"          tma_load_tile<X::NC>\([^;]*;)",
         None)],
}
# timing-only variants: their results are not the function's
WRONG = {"one_stream", "kv_once"}
CHECK = ((2, 1, 100, 512), (2, 1, 77, 320))
TIMED = (((128, 1, 256, 512), "bfloat16"), ((32, 1, 1024, 512), "float32"))
FWD_TIMED = ((256, 1, 256, 512), (128, 1, 256, 512))


def make_tree(base: str, name: str, forward: bool = False) -> str:
    """A copy of uurg_torch/ (without its build) under ``base``/``name``,
    patched as ``VARIANTS[name]`` (``FWD_VARIANTS[name]`` with
    ``forward``) says."""
    tree = os.path.join(base, name)
    shutil.copytree(os.path.join(ROOT, "uurg_torch"),
                    os.path.join(tree, "uurg_torch"),
                    ignore=shutil.ignore_patterns("__pycache__", "build"))
    cu = _FWD_CU if forward else _CU
    path = os.path.join(tree, "uurg_torch", cu)
    with open(path) as f:
        text = f.read()
    for pattern, new in (FWD_VARIANTS if forward else VARIANTS).get(name, []):
        # new None: the match kept for the first key tile of an item only
        text, n = re.subn(pattern, lambda m: new if new is not None else (
            f"          if (j == 0) {{\n{m.group(1)}\n          }} else "
            f"mbar_arrive(b.{m.group(2)}_full + 8 * s);"), text, flags=re.S)
        if n == 0:
            raise RuntimeError(f"{name}: patch {pattern[:40]!r} no longer "
                               f"applies to {cu}")
    with open(path, "w") as f:
        f.write(text)
    return tree


def _source(_build):
    return _build.CSRC / "flash_attention_xwide_bwd.cu"


def _sources(_build):
    # the xwide forwards give the backward its o and lse
    return [_source(_build), _build.CSRC / "flash_attention_f32.cu",
            _build.CSRC / "flash_attention_xwide_fwd.cu"]


def build_tree(tree: str, forward: bool = False) -> int:
    """In a child process: build ``tree``'s xwide sources."""
    sys.path.insert(0, tree)
    from uurg_torch.ops import _build

    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    from profile_torch_attention_xwide import ptxas_lines

    _build.sources = lambda: _sources(_build)
    _build.build_all()
    name = "flash_attention_xwide_fwd" if forward else _source(_build).stem
    pick = (lambda s: True) if forward else (lambda s: "dq" in s or "keys" in s)
    for line in ptxas_lines(_build.build_logs[name], pick):
        print(f"  {os.path.basename(tree)}: {line}", flush=True)
    return 0


def time_tree_forward(tree: str) -> int:
    """In a child process: check ``tree``'s bf16 xwide forward (built by
    ``build_tree``) and print its times."""
    sys.path.insert(0, tree)
    import torch

    sys.path.insert(1, ROOT)
    import chip_smoke as cs
    from uurg_torch.ops import _build
    from uurg_torch.ops import flash_attention as FA

    name = os.path.basename(tree)
    _build.sources = lambda: _sources(_build)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for B, H, T, D in CHECK:
        q, k, v = (torch.randn(B, H, T, D, generator=gen, device="cuda",
                               dtype=torch.bfloat16) for _ in range(3))
        got = FA._attention_kernel(q, k, v, with_lse=False)[0].float()
        err = (got - FA.attention_plain(q, k, v).float()).abs().max().item()
        print(f"  {name} bf16 T={T} D={D}: max abs {err:.3e}", flush=True)
    out = []
    for B, H, T, D in FWD_TIMED:
        q, k, v = (torch.randn(B, H, T, D, generator=gen, device="cuda",
                               dtype=torch.bfloat16) for _ in range(3))
        ms = cs.time_ms(lambda: FA._attention_kernel(q, k, v,
                                                     with_lse=False), 10)[0]
        out.append(f"({B}, {H}, {T}, {D}) {ms:.4f} ms")
        del q, k, v
    print(f"{name}{' (timing only)' if name in WRONG else ''}: "
          + " | ".join(out), flush=True)
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
    ap.add_argument("--forward", action="store_true",
                    help="variants of the bf16 forward, not the backward")
    ap.add_argument("--only", nargs="*", help="variants to run (default all)")
    args = ap.parse_args()
    if args.time_tree:
        return (time_tree_forward if args.forward else time_tree)(
            args.time_tree)
    if args.build_tree:
        return build_tree(args.build_tree, args.forward)
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs

    print(f"== card: {cs.card_line()}", flush=True)
    base = tempfile.mkdtemp(prefix="uurg_xwide_bwd_variants_")
    try:
        fwd = ["--forward"] if args.forward else []
        names = ["as_is",
                 *(args.only or (FWD_VARIANTS if args.forward else VARIANTS))]
        trees = [make_tree(base, n, args.forward) for n in names]
        builds = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                                    "--build-tree", t, *fwd]) for t in trees]
        if any(p.wait() != 0 for p in builds):
            raise RuntimeError("a variant did not build")
        for tree in trees + [trees[0]]:
            subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--time-tree", tree, *fwd], check=True)
    finally:
        shutil.rmtree(base, ignore_errors=True)
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
