"""Host-side DDPM runner: weights in, images out.

Port of ``uurg_tpu/workloads/ddpm_runner.py`` (serving part:
``load_params`` and ``sample_images``). One device; the multi-device
sampler arrives with the multi-device slice.
"""
from __future__ import annotations

import logging
import os

import numpy as np
import torch

from uurg_torch.data.transforms import inverse_data_transform
from uurg_torch.io.jax_interop import load_reference_checkpoint
from uurg_torch.models.unet_cond import CondUNet
from uurg_torch.workloads.ddpm import DDPMWorkload

log = logging.getLogger("uurg_torch.ddpm")


def load_params(args, config, wl: DDPMWorkload,
                use_ema: bool = False) -> CondUNet:
    """The model from ``<ckpt_folder>/ckpts/ckpt.pth`` (reference list
    format), or a fresh model seeded by ``args.seed`` when no folder is
    given or it holds no checkpoint. An Orbax checkpoint from a JAX run has
    to be exported to ``ckpt.pth`` first (``cli/export_torch.py``)."""
    path = getattr(args, "ckpt_folder", None)
    if not path:
        return wl.init_params(args.seed)
    torch_path = os.path.join(path, "ckpts", "ckpt.pth")
    if os.path.exists(torch_path):
        model = CondUNet(wl.unet_cfg)
        step = load_reference_checkpoint(torch_path, model, use_ema=use_ema)
        log.info("loaded %s (step %d, ema=%s)", torch_path, step, use_ema)
        return model.to(wl.device).eval()
    if os.path.isdir(os.path.join(path, "ckpts", "ckpt")):
        raise FileNotFoundError(
            f"{path} holds an Orbax checkpoint; export it with "
            f"cli/export_torch.py to {torch_path} first")
    log.warning("no checkpoint under %s — initializing fresh params", path)
    return wl.init_params(args.seed)


def to_uint8(config, x: torch.Tensor) -> torch.Tensor:
    """Model-range images -> uint8 (inverse transform, x255, round)."""
    return (inverse_data_transform(config, x) * 255.0).round().to(torch.uint8)


def sample_images(args, config, model: CondUNet, labels: np.ndarray,
                  *, num_steps: int = 50, method: str = "ddim",
                  cond_scale: float = 2.0, batch_size: int | None = None,
                  seed: int = 0) -> np.ndarray:
    """Batched class-conditional sampling -> uint8 NHWC images.

    Runs on the model's device. The last batch is padded to the batch size
    with class 0 and the padding is dropped from the output."""
    device = next(model.parameters()).device
    wl = DDPMWorkload.from_config(config, dtype=model.cfg.dtype, device=device)
    sampler = wl.make_sampler(num_steps=num_steps, cond_scale=cond_scale,
                              method=method)
    bs = batch_size or config.sampling.batch_size
    generator = torch.Generator(device=device).manual_seed(seed)
    out = []
    for start in range(0, len(labels), bs):
        chunk = np.asarray(labels[start:start + bs])
        lab = torch.as_tensor(np.pad(chunk, (0, bs - len(chunk))),
                              dtype=torch.long, device=device)
        x = sampler(model, lab, generator)
        out.append(to_uint8(config, x[:len(chunk)]).cpu())
    return torch.cat(out).numpy()
