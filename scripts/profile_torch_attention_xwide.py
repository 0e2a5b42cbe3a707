#!/usr/bin/env python3
"""The float32 attention forward at head widths above 256 (the ``xwide``
route, the VAE's one head of width 512) alone, on one GPU: build, check,
time.

    python3 scripts/profile_torch_attention_xwide.py [--tree CHECKOUT]

Builds the kernels and prints the ptxas lines of the float32 source (its
registers and spills), holds the forward and its log-sum-exp against the
plain version at T = 16 to 4096 and D = 300 to 512 (relative L2 printed;
two runs compared bit for bit), then times the kernel by CUDA-graph replay
(and eagerly) at the VAE's (32, 1, 1024, 512) and SD's VAE's
(2, 1, 4096, 512), beside the plain version and float32 SDPA (TF32 off)
under each backend that takes the shape, with the FFMA bound and the floor
of three TF32 products. Last, the GroupNorm forward at the VAE's largest
site (32, 256, 256, 256) fp32, 2^31 bytes, against its plain version.
``--tree`` imports ``uurg_torch`` from another checkout (an earlier commit
unpacked by ``git archive``), so that two versions can be timed in turns on
one card, each in its own process. A quick check for work on the route;
``chip_smoke.py`` phase 19 stays the whole proof.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (B, T, D) at one head
CHECK_SHAPES = ((2, 16, 512), (2, 100, 512), (2, 1024, 512), (2, 4096, 512),
                (2, 100, 320), (2, 1024, 300), (3, 65, 384), (2, 33, 448))


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default=None,
                    help="import uurg_torch from this checkout instead")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs            # this checkout's, whatever --tree says

    if args.tree:
        sys.path.insert(0, os.path.abspath(args.tree))
    from uurg_torch.ops import _build
    from uurg_torch.ops import flash_attention as FA
    from uurg_torch.ops import group_norm as GN

    print(cs.card_line(), FA.__file__, flush=True)
    t0 = time.time()
    _build.build_all()
    print(f"build {time.time() - t0:.1f} s")
    lines = _build.build_logs.get("flash_attention_f32", "").splitlines()
    for i, line in enumerate(lines):
        if "Function properties" in line and "xwide" in line:
            print(line.strip()[-40:], "|", lines[i + 1].strip(), "|",
                  lines[i + 2].strip()[:60])
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(0)

    def rel(a, b):
        return ((a.double() - b.double()).norm() / b.double().norm()).item()

    for B, T, D in CHECK_SHAPES:
        q, k, v = (torch.randn(B, 1, T, D, generator=g, device="cuda")
                   for _ in range(3))
        o, lse = FA._attention_kernel(q, k, v, with_lse=True)
        o2, _ = FA._attention_kernel(q, k, v, with_lse=True)
        torch.cuda.synchronize()
        p = FA.attention_plain(q, k, v)
        s = torch.matmul(q, k.transpose(-1, -2)) * D ** -0.5
        lref = torch.logsumexp(s, -1).reshape(B, T)
        print(f"B={B} T={T} D={D}: rel {rel(o, p):.3e} lse "
              f"{(lse - lref).abs().max().item():.3e} equal "
              f"{torch.equal(o, o2)} finite {torch.isfinite(o).all().item()}",
              flush=True)
    for B, H, T, D in cs.XWIDE_TIMED:
        q, k, v = (torch.randn(B, H, T, D, generator=g, device="cuda")
                   for _ in range(3))
        ms, eager = cs.time_ms(
            lambda: FA._attention_kernel(q, k, v, with_lse=False), 10)
        plain = cs.time_ms(lambda: FA.attention_plain(q, k, v), 10)[0]
        sdpa = cs.sdpa_by_backend(q, k, v)
        flops = 4 * B * H * T * T * D
        print(f"({B}, {H}, {T}, {D}): kernel {ms:.4f} ms (eager "
              f"{eager:.4f}), plain {plain:.4f}, fp32 SDPA "
              + ", ".join(f"{b} {t:.4f}" for b, t in sdpa.items())
              + f"; FFMA bound {flops / cs.FP32_FLOPS * 1e3:.4f}, three TF32 "
              f"products {3 * flops / cs.TF32_TC_FLOPS * 1e3:.4f}; "
              f"{flops / ms / 1e9:.1f} TFLOP/s", flush=True)
        del q, k, v
    x = torch.randn(32, 256, 256, 256, generator=g, device="cuda")
    sc = torch.rand(256, generator=g, device="cuda") + 0.5
    bi = torch.randn(256, generator=g, device="cuda")
    y, m, r = GN._group_norm_kernel(x, sc, bi, 32, 1e-6)
    torch.cuda.synchronize()
    yp, mp, rp = GN.group_norm_plain(x, sc, bi, 32, 1e-6, True)
    print("gn 2^31:", x.numel() * 4 == 2 ** 31, "y rel", rel(y, yp), "mean",
          rel(m, mp), "rstd", rel(r, rp), "last rows",
          (y[-1, -1] - yp[-1, -1]).abs().max().item())
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
