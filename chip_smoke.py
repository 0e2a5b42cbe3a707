#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``uurg_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):

1. Card, PyTorch, CUDA and nvcc versions.
2. Build every kernel under ``uurg_torch/csrc/`` (one nvcc per source, in
   parallel) and print the ptxas register/spill report.
3. Find the shapes the sampling path gives each kernel (hooks on one small
   forward of the full-width model), then at batch 256 (CFG 2 x 128) hold
   each kernel against its plain PyTorch version on the same bf16 inputs and
   time kernel, plain version and the PyTorch library call (SDPA,
   ``F.group_norm``) with CUDA events around a CUDA-graph replay (device
   time), and the kernel also launched eagerly from Python.
4. One forward at batch 8 with the kernels against the same model on its
   plain path.
5. The main path: ``ddpm_runner.sample_images`` on the full-width
   ``configs/cifar10_sfron.yml`` CondUNet (seeded random init), DDIM-50 with
   classifier-free guidance 2.0, 128 labels over 10 classes. The kernel
   launch counters are zeroed just before and read just after; every
   attention and GroupNorm site must have gone through its kernel.

Prints the kernels JSON line and the card's name and power limit, then as
the last line ``{"ok": true, "device": {...}}``. Per-shape details go to
``chiprun_out/chip_smoke_detail.json``. Exits non-zero without CUDA or
outside a checkout of the repository.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM3 rate, bf16
# tensor-core rate, fp32 rate outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
BF16_TC_FLOPS = 989e12
FP32_FLOPS = 67e12

SAMPLING_BATCH = 128     # configs/cifar10_sfron.yml sampling.batch_size
DDIM_STEPS = 50
COND_SCALE = 2.0
SEED = 0

# configs/cifar10_sfron.yml, the sections the sampling path reads (held equal
# to the YAML by tests/test_torch_sampling.py; PyYAML is not needed here)
SFRON_CONFIG = {
    "data": {"dataset": "CIFAR10", "image_size": 32, "channels": 3,
             "n_classes": 10, "rescaled": True},
    "model": {"in_channels": 3, "out_ch": 3, "ch": 128, "ch_mult": [1, 2, 2, 2],
              "num_res_blocks": 2, "attn_resolutions": [16], "dropout": 0.1,
              "var_type": "fixedlarge", "resamp_with_conv": True,
              "cond_drop_prob": 0.1},
    "diffusion": {"beta_schedule": "linear", "beta_start": 0.0001,
                  "beta_end": 0.02, "num_diffusion_timesteps": 1000},
    "sampling": {"batch_size": SAMPLING_BATCH},
}

# kernel tolerances against the plain version in bf16:
# |kernel - plain| <= ATOL + RTOL * |plain|. Both round their output to bf16
# (relative step 2**-8 = 0.0039) after fp32 arithmetic summed in another
# order, and the attention kernel rounds unnormalised probabilities to bf16
# where the plain version rounds normalised ones; 1e-2 covers one to two
# output roundings.
ATOL, RTOL = 1e-2, 1e-2
# whole-model check at batch 8 (kernels vs plain path, both bf16): relative
# L2 error of the eps output. bf16 roundings at ~150 layers compound.
MODEL_REL_L2 = 2e-2


def fail(msg: str) -> None:
    raise RuntimeError(msg)


def sh(cmd: list[str]) -> str:
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
    return (out.stdout or out.stderr).strip()


def card_line() -> str:
    return sh(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"])


def _events_ms(run, iters: int) -> float:
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_ms(fn, iters: int = 20) -> tuple[float, float]:
    """(device ms, eager ms) per call of ``fn``, back to back on the same
    inputs. Device time replays the calls captured in a CUDA graph, so the
    host's launch cost is not in it; eager time launches from Python as the
    sampling path does, and exceeds the device time wherever a call's
    kernels finish faster than the host can launch them."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    device = _events_ms(graph.replay, iters)

    def eager():
        for _ in range(iters):
            fn()

    eager()
    return device, _events_ms(eager, iters)


def compare(name: str, got, want) -> float:
    import torch

    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        fail(f"{name}: kernel output is not finite")
    err = (got - want).abs()
    max_abs = err.max().item()
    print(f"  {name}: max_abs_err {max_abs:.3e} "
          f"(tolerance {ATOL:g} + {RTOL:g}*|plain|)", flush=True)
    if (err > ATOL + RTOL * want.abs()).any():
        fail(f"{name}: kernel disagrees with its plain version")
    return max_abs


def collect_sites(model, device):
    """The (kind, shape) of every attention and GroupNorm call in one forward,
    read by hooks at batch 2 and scaled to the CFG batch later."""
    import torch

    from uurg_torch.models import layers

    sites = []
    hooks = []
    for m in model.modules():
        if isinstance(m, layers.GroupNorm32):
            hooks.append(m.register_forward_pre_hook(
                lambda mod, args: sites.append(
                    ("gn", tuple(args[0].shape[1:]), mod.num_groups))))
        elif isinstance(m, layers.SelfAttention2D):
            hooks.append(m.register_forward_pre_hook(
                lambda mod, args: sites.append(
                    ("attn", tuple(args[0].shape[1:]), 1))))
    x = torch.randn(2, 32, 32, 3, device=device)
    t = torch.tensor([10, 500], device=device)
    c = torch.tensor([1, 2], device=device)
    with torch.inference_mode():
        model(x, t, c, torch.tensor([True, False], device=device))
    for h in hooks:
        h.remove()
    return sites


def check_kernels(sites, batch: int, gen) -> list[dict]:
    import torch
    import torch.nn.functional as F

    from uurg_torch.ops.flash_attention import attention, attention_plain
    from uurg_torch.ops.group_norm import group_norm, group_norm_plain

    dev = torch.device("cuda")
    rows = []
    shapes = sorted({(k, s, g) for k, s, g in sites})
    for kind, (C, H, W), groups in shapes:
        count = sum(1 for s in sites if s == (kind, (C, H, W), groups))
        if kind == "attn":
            T, D = H * W, C
            q, k, v = (torch.randn(batch, 1, T, D, generator=gen, device=dev,
                                   dtype=torch.bfloat16) for _ in range(3))
            got = attention(q, k, v)
            torch.cuda.synchronize()
            max_abs = compare(f"attention B={batch} T={T} D={D}",
                              got, attention_plain(q, k, v))
            run = (lambda: attention(q, k, v),
                   lambda: attention_plain(q, k, v),
                   lambda: F.scaled_dot_product_attention(q, k, v))
            nbytes = 4 * batch * T * D * 2
            ops, peak = 4 * batch * T * T * D, BF16_TC_FLOPS
            shape = {"B": batch, "H": 1, "T": T, "D": D}
            name = "attention_fwd"
        else:
            x = (torch.randn(batch, H, W, C, generator=gen, device=dev) * 2
                 + 0.5).to(torch.bfloat16)
            scale = torch.randn(C, generator=gen, device=dev) * 0.2 + 1.0
            bias = torch.randn(C, generator=gen, device=dev) * 0.2
            got = group_norm(x, scale, bias, groups=groups)
            torch.cuda.synchronize()
            max_abs = compare(
                f"group_norm B={batch} H={H} W={W} C={C}", got,
                group_norm_plain(x, scale, bias, groups, 1e-6))
            x_nchw = x.permute(0, 3, 1, 2)
            s16, b16 = scale.to(torch.bfloat16), bias.to(torch.bfloat16)
            run = (lambda: group_norm(x, scale, bias, groups=groups),
                   lambda: group_norm_plain(x, scale, bias, groups, 1e-6),
                   lambda: F.group_norm(x_nchw, groups, s16, b16, 1e-6))
            numel = batch * H * W * C
            nbytes = 2 * numel * 2 + 2 * C * 4 + 2 * batch * groups * 4
            ops, peak = 4 * numel, FP32_FLOPS
            shape = {"B": batch, "H": H, "W": W, "C": C, "G": groups}
            name = "group_norm_fwd"
        ms, eager_ms = time_ms(run[0])
        plain_ms, lib_ms = time_ms(run[1])[0], time_ms(run[2])[0]
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / peak * 1e3
        rows.append({
            "name": name, "shape": shape, "sites_per_forward": count,
            "ms": ms, "eager_ms": eager_ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "bytes_ms": bytes_ms, "ops_ms": ops_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "max_abs_err": max_abs,
        })
        print(f"  {name} {shape} x{count}/forward: kernel {ms:.4f} ms "
              f"(eager {eager_ms:.4f} ms), plain {plain_ms:.4f} ms, "
              f"library {lib_ms:.4f} ms, bound {max(bytes_ms, ops_ms):.4f} "
              f"ms ({rows[-1]['bound_by']})", flush=True)
    return rows


def summarise(rows: list[dict], launches: dict, meta: dict) -> list[dict]:
    """One entry per kernel; times are per UNet forward: the sum over the
    forward's sites of the per-launch time at that site's shape."""
    out = []
    for name, info in meta.items():
        mine = [r for r in rows if r["name"] == name]
        if not mine:
            fail(f"{name}: no site of the sampling path reached it")

        def total(key):
            return sum(r[key] * r["sites_per_forward"] for r in mine)

        bytes_ms, ops_ms = total("bytes_ms"), total("ops_ms")
        out.append({
            "name": name, "route": "cuda", "source": info["source"],
            "replaces": info["replaces"], "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": total("ms"), "eager_ms": total("eager_ms"),
            "plain_ms": total("plain_ms"),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": total("library_ms"),
            "per": ("UNet forward at batch 256: sum over its sites of the "
                    "device ms per launch (CUDA-graph replay); eager_ms "
                    "launches from Python"),
        })
    return out


def model_check(model, gen) -> float:
    import torch

    from uurg_torch.models import layers
    from uurg_torch.ops.flash_attention import attention_plain
    from uurg_torch.ops.group_norm import group_norm_plain

    dev = torch.device("cuda")
    x = torch.randn(8, 32, 32, 3, generator=gen, device=dev)
    t = torch.randint(0, 1000, (8,), generator=gen, device=dev)
    c = torch.randint(0, 10, (8,), generator=gen, device=dev)
    keep = torch.arange(8, device=dev) % 2 == 0
    with torch.inference_mode():
        got = model(x, t, c, keep)
        kernels = (layers.attention, layers.group_norm)
        layers.attention = attention_plain
        layers.group_norm = (lambda x, s, b, *, groups, eps:
                             group_norm_plain(x, s, b, groups, eps))
        try:
            want = model(x, t, c, keep)
        finally:
            layers.attention, layers.group_norm = kernels
    if not torch.isfinite(got).all():
        fail("batch-8 forward with kernels is not finite")
    rel = ((got - want).norm() / want.norm()).item()
    print(f"  batch-8 forward, kernels vs plain path: rel L2 err {rel:.3e} "
          f"(tolerance {MODEL_REL_L2:g}), max_abs_err "
          f"{(got - want).abs().max().item():.3e}", flush=True)
    if rel > MODEL_REL_L2:
        fail("the model with kernels disagrees with its plain path")
    return rel


def main() -> int:
    if not os.path.isdir(os.path.join(ROOT, "uurg_torch", "csrc")):
        print("chip_smoke.py must run from a checkout of the repository "
              "(uurg_torch/ not found beside it)", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("CUDA is not available: chip_smoke.py needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import numpy as np

    from uurg_torch.core.config import Config
    from uurg_torch.ops import _build
    from uurg_torch.ops.flash_attention import attention
    from uurg_torch.ops.group_norm import group_norm
    from uurg_torch.workloads import ddpm_runner as R
    from uurg_torch.workloads.ddpm import DDPMWorkload

    t_start = time.time()
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"== card: {card}", flush=True)
    print(f"== torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"nvcc: {sh([_build._nvcc(), '--version']).splitlines()[-1]}",
          flush=True)

    print("== build", flush=True)
    t0 = time.time()
    _build.build_all()
    print(f"  built {len(_build.sources())} sources in "
          f"{time.time() - t0:.1f} s", flush=True)
    for name, log in sorted(_build.build_logs.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  [{name}] {line.strip()}")

    config = Config(SFRON_CONFIG)
    wl = DDPMWorkload.from_config(config)          # CUDA, bf16 compute

    class Args:
        ckpt_folder = None
        seed = SEED

    model = R.load_params(Args, config, wl)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"== model: full-width CondUNet, {n_params} parameters, "
          f"seeded random init", flush=True)
    sites = collect_sites(model, wl.device)
    n_attn = sum(1 for s in sites if s[0] == "attn")
    n_gn = sum(1 for s in sites if s[0] == "gn")
    print(f"  sites per forward: {n_attn} attention, {n_gn} GroupNorm",
          flush=True)

    print("== kernels vs plain versions (bf16, CFG batch "
          f"{2 * SAMPLING_BATCH})", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = check_kernels(sites, 2 * SAMPLING_BATCH, gen)

    print("== whole model, kernels vs plain path", flush=True)
    model_rel = model_check(model, gen)

    print(f"== main path: sample_images, DDIM-{DDIM_STEPS}, CFG "
          f"{COND_SCALE}, {SAMPLING_BATCH} labels", flush=True)
    labels = np.arange(SAMPLING_BATCH) % config.data.n_classes
    R.sample_images(Args, config, model, labels[:8], num_steps=2,
                    cond_scale=COND_SCALE, batch_size=SAMPLING_BATCH,
                    seed=SEED)                         # warm-up, not counted
    finite = []
    hook = model.register_forward_hook(
        lambda mod, args, out: finite.append(torch.isfinite(out).all()))
    torch.cuda.synchronize()
    attention.launches = 0
    group_norm.launches = 0
    t0 = time.time()
    imgs = R.sample_images(Args, config, model, labels,
                           num_steps=DDIM_STEPS, cond_scale=COND_SCALE,
                           seed=SEED)
    elapsed = time.time() - t0
    launches = {"attention_fwd": attention.launches,
                "group_norm_fwd": group_norm.launches}
    hook.remove()
    if not (isinstance(imgs, np.ndarray) and imgs.dtype == np.uint8
            and imgs.shape == (SAMPLING_BATCH, 32, 32, 3)):
        fail(f"sample_images returned {type(imgs)} "
             f"{getattr(imgs, 'dtype', None)} {getattr(imgs, 'shape', None)}")
    if len(finite) != DDIM_STEPS or not all(bool(f) for f in finite):
        fail("a UNet output of the sampling loop is not finite")
    if imgs.std() == 0:
        fail("sampled images are constant")
    want = {"attention_fwd": n_attn * DDIM_STEPS,
            "group_norm_fwd": n_gn * DDIM_STEPS}
    print(f"  launches: {launches} (expected {want})")
    if launches != want:
        fail("not every attention/GroupNorm site went through its kernel")
    print(f"  {SAMPLING_BATCH} images in {elapsed:.3f} s: "
          f"{SAMPLING_BATCH / elapsed:.3f} imgs/s on {card}; every UNet "
          f"output finite; image mean {imgs.mean():.2f} std "
          f"{imgs.std():.2f}", flush=True)

    meta = {
        "attention_fwd": {
            "source": "uurg_torch/csrc/flash_attention_fwd.cu",
            "replaces": "uurg_tpu/ops/flash_attention.py:49"},
        "group_norm_fwd": {
            "source": "uurg_torch/csrc/group_norm.cu",
            "replaces": "uurg_tpu/ops/group_norm.py:38"},
    }
    kernels = summarise(rows, launches, meta)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke_detail.json"),
              "w") as f:
        json.dump({"card": card, "torch": torch.__version__,
                   "cuda": torch.version.cuda, "per_shape": rows,
                   "kernels": kernels, "model_rel_l2": model_rel,
                   "sampling": {"images": SAMPLING_BATCH,
                                "steps": DDIM_STEPS, "seconds": elapsed,
                                "imgs_per_s": SAMPLING_BATCH / elapsed},
                   "total_seconds": time.time() - t_start}, f, indent=1)
    print(f"== done in {time.time() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
