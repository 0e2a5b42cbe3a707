#!/usr/bin/env python3
"""Where the time of the port's frozen VAE goes, on one GPU.

    python3 scripts/profile_torch_vae.py [--batch 32] [--res 256] [--calls 2]

Builds ``VAEConfig()`` (the CompVis first stage DiT and SD use, seeded
init, fp32, TF32 off), warms up one encode (a posterior draw) of ``--batch``
seeded images at ``--res`` px and one decode of their latents, then records
``--calls`` of each under ``torch.profiler``. Prints, for encode and decode
apart, the host clock a call, the device time a call by kernel group (the
float32 attention kernel, the GroupNorm kernel, convolutions, elementwise
work, copies), the device busy share, the top kernels and host ops, and the
convolutions' FLOPs (from their shapes) beside the time the card's float32
rate (67 TFLOP/s) would need for them.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

GROUPS = (   # first match wins, on the lower-cased kernel name
    ("attention fwd kernel (xwide)", ("attn_fwd_xwide",)),
    ("GroupNorm fwd kernel", ("gn_fwd",)),
    ("convolution", ("conv", "fprop", "dgrad", "implicit", "xmma", "sm90_",
                     "winograd", "cudnn", "gemm", "cutlass", "nvjet")),
    ("pad / layout copies", ("copy", "constant_pad", "nchw", "nhwc", "cat")),
    ("upsample", ("upsample", "nearest")),
    ("elementwise", ("elementwise", "vectorized", "sigmoid", "mul", "add",
                     "exp", "clamp", "philox", "distribution", "normal")),
)
FP32_FLOPS = 67e12


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--res", type=int, default=256)
    p.add_argument("--calls", type=int, default=2)
    args = p.parse_args()
    import torch
    import torch.nn as nn
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("needs a CUDA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import chip_smoke as cs
    import profile_torch_dit as pdit
    from uurg_torch.core.device import resolve_device
    from uurg_torch.models.autoencoder_kl import init_vae
    from uurg_torch.ops import _build

    pdit.GROUPS = GROUPS                     # its report() groups by these
    _build.build_all()
    dev = resolve_device("cuda")
    vae = init_vae(0, device=dev)
    flops = {"n": 0}

    def count(mod, inp, out):
        flops["n"] += 2 * out.numel() * mod.weight[0].numel()

    for mod in vae.modules():
        if isinstance(mod, nn.Conv2d):
            mod.register_forward_hook(count)
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.rand(args.batch, args.res, args.res, 3, generator=gen,
                   device=dev) * 2 - 1
    with torch.inference_mode():
        z = vae.encode(x, generator=gen)
    lines = [f"card: {cs.card_line()}; torch {torch.__version__}; VAE "
             f"encode / decode at batch {args.batch}, {args.res} px, fp32, "
             f"TF32 off"]
    for kind, call in (("encode", lambda: vae.encode(x, generator=gen)),
                       ("decode", lambda: vae.decode(z))):
        with torch.inference_mode():
            call()                                        # warm-up
            torch.cuda.synchronize()
            flops["n"] = 0
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(args.calls):
                    call()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
        conv = flops["n"] / args.calls
        pdit.report(prof, args.calls, wall, f"VAE {kind}", lines)
        lines.append(f"  convolutions: {conv / 1e12:.3f} TFLOP a call, "
                     f"{conv / FP32_FLOPS * 1e3:.3f} ms at the fp32 peak; "
                     f"{args.batch * args.calls / wall:.3f} images/s on the "
                     f"host clock (profiled)")
    print("\n".join(lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
