#!/usr/bin/env python3
"""The attention at padded head widths 320-512 (the ``xwide`` kernels: the
float32 and bf16 forward, and the backward in both dtypes) alone, on one
GPU: build, check, time.

    python3 scripts/profile_torch_attention_xwide.py [--tree CHECKOUT]
        [--backward | --forward]

Builds the kernels and prints the ptxas lines of the xwide forwards (the
float32 one in ``flash_attention_f32.cu``, the bf16 one in
``flash_attention_xwide_fwd.cu``) and of every kernel of
``flash_attention_xwide_bwd.cu`` (registers, spills). Then, in order:

- unless ``--backward``: the bf16 forward against the plain version
  (chip_smoke's ATOL and RTOL) and its log-sum-exp against
  ``torch.logsumexp`` at widths 320-512 and T from 16 to 1024 (ragged ones
  too; three runs bit for bit), timed by CUDA-graph replay (and eagerly)
  at the CondUNet's (256, 1, 256, 512) and (128, 1, 256, 512)
  (``model.ch: 256`` at its CFG and training batches) beside the plain
  version and bf16 SDPA (the backend its dispatcher picks), with the bytes
  and operations bounds; ``--forward`` stops here;
- unless ``--backward``: the float32 forward and its log-sum-exp against
  the plain version at T = 16 to 4096 and D = 300 to 512 (relative L2
  printed; two runs compared bit for bit), timed at the VAE's (32, 1, 1024,
  512) and SD's VAE's (2, 1, 4096, 512) beside the plain version and
  float32 SDPA (TF32 off) under each backend that takes the shape, with
  the FFMA bound and the floor of three TF32 products;
- the backward in both dtypes against ``attention_bwd_plain`` at widths
  320-512 and T from 16 to 1024 (ragged ones too; two runs bit for bit),
  timed at the CondUNet's (128, 1, 256, 512) bf16 and the VAE's (32, 1,
  1024, 512) float32 beside the plain path and SDPA's backward under each
  backend that takes the shape, with the bound and the design's floor
  (bf16: one bf16 product at 989 TFLOP/s, float32: three TF32 products at
  495);
- unless ``--backward``: the GroupNorm forward at the VAE's largest site
  (32, 256, 256, 256) fp32, 2^31 bytes, against its plain version.

``--tree`` imports ``uurg_torch`` from another checkout (an earlier commit
unpacked by ``git archive``), so that two versions can be timed in turns on
one card, each in its own process. A quick check for work on the route;
``chip_smoke.py`` phases 19 and 19b stay the whole proof. Exits 1 if a
check fails.
"""
from __future__ import annotations

import argparse
import os
import sys
import time
import warnings

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (B, T) of the bf16 forward's checks at each width 320-512
BF16_FWD_CHECK = ((2, 16), (2, 100), (2, 256), (3, 65), (2, 1024))
# (B, T, D) at one head
CHECK_SHAPES = ((2, 16, 512), (2, 100, 512), (2, 1024, 512), (2, 4096, 512),
                (2, 100, 320), (2, 1024, 300), (3, 65, 384), (2, 33, 448))
BWD_CHECK = ((2, 16, 512), (2, 100, 512), (2, 256, 512), (2, 1024, 512),
             (2, 77, 320), (2, 256, 320), (3, 65, 384), (2, 33, 448),
             (2, 200, 448), (2, 130, 300))
BWD_TIMED = (((128, 1, 256, 512), "bfloat16"), ((32, 1, 1024, 512), "float32"))


def ptxas_lines(log: str, match) -> list[str]:
    lines = log.splitlines()
    out = []
    for i, line in enumerate(lines):
        if "Function properties" in line and match(line):
            out.append(line.strip()[-60:] + " | " + lines[i + 1].strip()
                       + " | " + lines[i + 2].strip()[:70])
    return out


def kernel_ms(fn, iters: int = 5) -> dict:
    """Device ms a call of ``fn`` by kernel (the name cut at its template
    arguments), from torch.profiler over ``iters`` calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = e.cuda_time_total
        if us:
            name = e.key.replace("(anonymous namespace)::", "")
            name = name.replace("void ", "").split("<")[0].split("(")[0]
            out[name] = out.get(name, 0.0) + us / 1e3 / iters
    return out


def bf16_forward(cs, FA, g, failed: list) -> None:
    """The bf16 xwide forward: checks at BF16_FWD_CHECK and every width,
    then the CondUNet's two shapes timed beside SDPA and the bounds."""
    import torch
    import torch.nn.functional as F

    for D in cs.XW_WIDTHS:
        for B, T in BF16_FWD_CHECK:
            q, k, v = (torch.randn(B, 1, T, D, generator=g, device="cuda",
                                   dtype=torch.bfloat16) for _ in range(3))
            runs = [FA._attention_kernel(q, k, v, with_lse=True)
                    for _ in range(cs.RAGGED_REPEATS)]
            torch.cuda.synchronize()
            o, lse = runs[0]
            equal = all(torch.equal(o, r[0]) and torch.equal(lse, r[1])
                        for r in runs[1:])
            want = FA.attention_plain(q, k, v).float()
            err = (o.float() - want).abs()
            s = torch.matmul(q.float(), k.float().transpose(-1, -2)) \
                * D ** -0.5
            lse_err = (lse - torch.logsumexp(s, -1).reshape(B, T)) \
                .abs().max().item()
            ok = (bool(torch.isfinite(o).all()) and equal
                  and not (err > cs.ATOL + cs.RTOL * want.abs()).any()
                  and lse_err <= cs.LSE_ATOL)
            if not ok:
                failed.append(f"bf16 forward {(B, T, D)}")
            print(f"bf16 fwd B={B} T={T} D={D}: max abs {err.max().item():.3e}"
                  f" (tolerance {cs.ATOL:g} + {cs.RTOL:g}|plain|), lse "
                  f"{lse_err:.3e}, {cs.RAGGED_REPEATS} runs equal {equal}",
                  flush=True)
            del q, k, v, runs, o, lse, want, err, s
    for B, H, T, D in (cs.XW_UNET_CFG, cs.XW_UNET_TRAIN):
        q, k, v = (torch.randn(B, H, T, D, generator=g, device="cuda",
                               dtype=torch.bfloat16) for _ in range(3))

        def run():
            return FA._attention_kernel(q, k, v, with_lse=False)

        ms, eager = cs.time_ms(run, 10)
        lse_ms = cs.time_ms(
            lambda: FA._attention_kernel(q, k, v, with_lse=True), 10)[0]
        plain = cs.time_ms(lambda: FA.attention_plain(q, k, v), 5)[0]
        sdpa = cs.time_ms(
            lambda: F.scaled_dot_product_attention(q, k, v), 10)[0]
        backend = cs.sdpa_backend_names(q, k, v)["backend"]
        n = B * H * T * D
        bytes_ms = 4 * n * 2 / cs.HBM_BYTES_PER_S * 1e3
        ops_ms = 4 * n * T / cs.BF16_TC_FLOPS * 1e3
        print(f"bf16 fwd ({B}, {H}, {T}, {D}): kernel {ms:.4f} ms (eager "
              f"{eager:.4f}; with the log-sum-exp {lse_ms:.4f}), plain "
              f"{plain:.4f}, bf16 SDPA {sdpa:.4f} ({backend}); bound "
              f"{max(bytes_ms, ops_ms):.4f} (bytes {bytes_ms:.4f}, operations "
              f"{ops_ms:.4f}); {4 * n * T / ms / 1e9:.1f} TFLOP/s, "
              f"{4 * n * 2 / ms / 1e6:.1f} GB/s of the bound's bytes; kernels "
              f"a call {cs.kernels_a_call(run)}", flush=True)
        del q, k, v


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default=None,
                    help="import uurg_torch from this checkout instead")
    group = ap.add_mutually_exclusive_group()
    group.add_argument("--backward", action="store_true",
                       help="the backward alone")
    group.add_argument("--forward", action="store_true",
                       help="the bf16 forward alone")
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
    print(f"build {time.time() - t0:.1f} s; nvcc a source: "
          + ", ".join(f"{n} {t:.1f} s" for n, t in sorted(
              getattr(_build, "build_seconds", {}).items())))
    for name in sorted(_build.build_logs):
        log = _build.build_logs[name]
        pick = (lambda line: True) if name.startswith("flash_attention_xwide") \
            else (lambda line: "xwide" in line)
        for line in ptxas_lines(log, pick):
            print(f"{name}: {line}")
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(0)
    failed = []

    def rel(a, b):
        return ((a.double() - b.double()).norm() / b.double().norm()).item()

    if not args.backward:
        bf16_forward(cs, FA, g, failed)
    if args.forward:
        print(cs.card_line())
        if failed:
            print("FAILED:", ", ".join(failed))
        return 1 if failed else 0

    if not args.backward:
        for B, T, D in CHECK_SHAPES:
            q, k, v = (torch.randn(B, 1, T, D, generator=g, device="cuda")
                       for _ in range(3))
            o, lse = FA._attention_kernel(q, k, v, with_lse=True)
            o2, _ = FA._attention_kernel(q, k, v, with_lse=True)
            torch.cuda.synchronize()
            p = FA.attention_plain(q, k, v)
            s = torch.matmul(q, k.transpose(-1, -2)) * D ** -0.5
            lref = torch.logsumexp(s, -1).reshape(B, T)
            r = rel(o, p)
            if not (r <= cs.F32_FWD_REL and torch.equal(o, o2)):
                failed.append(f"forward {(B, T, D)}")
            print(f"B={B} T={T} D={D}: rel {r:.3e} lse "
                  f"{(lse - lref).abs().max().item():.3e} equal "
                  f"{torch.equal(o, o2)} finite "
                  f"{torch.isfinite(o).all().item()}", flush=True)
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
                  + f"; FFMA bound {flops / cs.FP32_FLOPS * 1e3:.4f}, three "
                  f"TF32 products {3 * flops / cs.TF32_TC_FLOPS * 1e3:.4f}; "
                  f"{flops / ms / 1e9:.1f} TFLOP/s", flush=True)
            del q, k, v

    for dtype in (torch.float32, torch.bfloat16):
        tol = cs.F32_BWD_REL if dtype == torch.float32 else cs.BWD_REL_L2
        for B, T, D in BWD_CHECK:
            q, k, v, gr = (torch.randn(B, 1, T, D, generator=g, device="cuda",
                                       dtype=dtype) for _ in range(4))
            o, lse = FA._attention_kernel(q, k, v, with_lse=True)
            got = FA.attention_bwd(q, k, v, o, lse, gr)
            again = FA.attention_bwd(q, k, v, o, lse, gr)
            torch.cuda.synchronize()
            want = FA.attention_bwd_plain(q, k, v, gr)
            errs = [rel(a, b) for a, b in zip(got, want)]
            equal = all(torch.equal(a, b) for a, b in zip(got, again))
            if not (max(errs) <= tol and equal):
                failed.append(f"backward {str(dtype)[6:]} {(B, T, D)}")
            print(f"bwd {str(dtype)[6:]} B={B} T={T} D={D}: rel dq dk dv "
                  + " ".join(f"{e:.3e}" for e in errs)
                  + f" (tolerance {tol:g}) equal {equal}", flush=True)
            del q, k, v, gr, o, lse, got, again, want

    from torch.nn.attention import SDPBackend, sdpa_kernel

    for (B, H, T, D), name in BWD_TIMED:
        dtype = getattr(torch, name)
        q, k, v, gr = (torch.randn(B, H, T, D, generator=g, device="cuda",
                                   dtype=dtype) for _ in range(4))
        o, lse = FA._attention_kernel(q, k, v, with_lse=True)
        def run():
            return FA.attention_bwd(q, k, v, o, lse, gr)

        ms, eager = cs.time_ms(run, 10)
        plain = cs.time_ms(lambda: FA.attention_bwd_plain(q, k, v, gr), 5)[0]
        lib = {}
        for backend in cs.SDPA_BACKENDS:
            be = getattr(SDPBackend, backend, None)

            def fwd(*a, be=be):
                with sdpa_kernel([be]):
                    return torch.nn.functional.scaled_dot_product_attention(
                        *a)

            try:
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore")
                    fn, stream = cs.library_bwd(fwd, (q, k, v), gr)
                    fn()
                torch.cuda.synchronize()
            except RuntimeError:
                continue
            lib[backend.lower()] = cs.time_ms(fn, 10, stream=stream)[0]
        flops = 10 * B * H * T * T * D
        size = 2 if dtype == torch.bfloat16 else 4
        bytes_ms = 7 * B * H * T * D * size / cs.HBM_BYTES_PER_S * 1e3
        if dtype == torch.bfloat16:
            floor = flops / cs.BF16_TC_FLOPS * 1e3
            what = "one bf16 product"
        else:
            floor = 3 * flops / cs.TF32_TC_FLOPS * 1e3
            what = (f"three TF32 products; FFMA bound "
                    f"{flops / cs.FP32_FLOPS * 1e3:.4f}")
        print(f"bwd {name} ({B}, {H}, {T}, {D}): kernel {ms:.4f} ms (eager "
              f"{eager:.4f}), plain {plain:.4f}, SDPA backward "
              + ", ".join(f"{b} {t:.4f}" for b, t in lib.items())
              + f"; bytes {bytes_ms:.4f}, floor {floor:.4f} ({what}); "
              f"{flops / ms / 1e9:.1f} TFLOP/s; kernels a call "
              f"{cs.kernels_a_call(run)}", flush=True)
        print("  by kernel: " + ", ".join(
            f"{n} {t:.4f}" for n, t in kernel_ms(run).items()), flush=True)
        del q, k, v, gr, o, lse

    if not args.backward:
        x = torch.randn(32, 256, 256, 256, generator=g, device="cuda")
        sc = torch.rand(256, generator=g, device="cuda") + 0.5
        bi = torch.randn(256, generator=g, device="cuda")
        y, m, r = GN._group_norm_kernel(x, sc, bi, 32, 1e-6)
        torch.cuda.synchronize()
        yp, mp, rp = GN.group_norm_plain(x, sc, bi, 32, 1e-6, True)
        print("gn 2^31:", x.numel() * 4 == 2 ** 31, "y rel", rel(y, yp),
              "mean", rel(m, mp), "rstd", rel(r, rp), "last rows",
              (y[-1, -1] - yp[-1, -1]).abs().max().item())
    print(cs.card_line())
    if failed:
        print("FAILED:", ", ".join(failed))
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
