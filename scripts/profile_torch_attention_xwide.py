#!/usr/bin/env python3
"""The float32 attention forward at head widths above 256 (the ``xwide``
route, the VAE's one head of width 512) alone, on one GPU: build, check,
time.

    python3 scripts/profile_torch_attention_xwide.py

Builds the kernels and prints the ptxas lines of the float32 source (its
registers and spills), holds the forward and its log-sum-exp against the
plain version at T = 16 to 4096 and D = 320 to 512 (relative L2 printed;
two runs compared bit for bit), times the kernel, the plain version and
float32 SDPA (TF32 off) at the VAE's (32, 1, 1024, 512) with CUDA events
around 10 eager calls each, and holds the GroupNorm forward at the VAE's
largest site (32, 256, 256, 256) fp32, 2^31 bytes, against its plain
version. A quick check for work on the route; ``chip_smoke.py`` phase 19
stays the whole proof (it times by CUDA-graph replay).
"""
from __future__ import annotations

import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (B, T, D) at one head
CHECK_SHAPES = ((2, 16, 512), (2, 100, 512), (2, 1024, 512), (2, 4096, 512),
                (2, 100, 320), (2, 1024, 300), (3, 65, 384), (2, 33, 448))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from uurg_torch.ops import _build
    from uurg_torch.ops import flash_attention as FA
    from uurg_torch.ops import group_norm as GN

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    t0 = time.time()
    _build.build_all()
    print(f"build {time.time() - t0:.1f} s")
    for line in _build.build_logs.get("flash_attention_f32",
                                      "").splitlines():
        if "xwide" in line or "spill" in line or "registers" in line:
            print(line.strip()[:200])
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
    q, k, v = (torch.randn(32, 1, 1024, 512, generator=g, device="cuda")
               for _ in range(3))
    for name, fn in (
            ("kernel", lambda: FA._attention_kernel(q, k, v,
                                                    with_lse=False)),
            ("plain", lambda: FA.attention_plain(q, k, v)),
            ("sdpa", lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k, v))):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        for _ in range(10):
            fn()
        e1.record()
        torch.cuda.synchronize()
        print(name, e0.elapsed_time(e1) / 10, "ms")
    x = torch.randn(32, 256, 256, 256, generator=g, device="cuda")
    sc = torch.rand(256, generator=g, device="cuda") + 0.5
    bi = torch.randn(256, generator=g, device="cuda")
    y, m, r = GN._group_norm_kernel(x, sc, bi, 32, 1e-6)
    torch.cuda.synchronize()
    print("gn route", GN._fwd_route(256 * 256, 256, 4, 32))
    yp, mp, rp = GN.group_norm_plain(x, sc, bi, 32, 1e-6, True)
    print("gn 2^31:", x.numel() * 4 == 2 ** 31, "y rel", rel(y, yp), "mean",
          rel(m, mp), "rstd", rel(r, rp), "last rows",
          (y[-1, -1] - yp[-1, -1]).abs().max().item())
    return 0


if __name__ == "__main__":
    sys.exit(main())
