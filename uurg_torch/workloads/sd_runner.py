"""Host-side SD runners (the reference's SD/train-scripts).

Port of the part of ``uurg_tpu/workloads/sd_runner.py`` that the Fisher
pass needs, :func:`encode_image_folder`: data enters the SD losses as
latents and contexts pre-encoded by the frozen VAE and text encoder.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from uurg_torch.workloads.sd import SDWorkload


def encode_image_folder(wl: SDWorkload, images: np.ndarray,
                        prompts: Sequence[str], generator: torch.Generator,
                        batch_size: int = 8
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """(z, context) on the workload's device: [-1, 1] NHWC images encoded
    ``batch_size`` at a time (a posterior draw from ``generator``) and the
    prompts embedded, both under ``torch.inference_mode`` and returned as
    ordinary tensors, which autograd may save."""
    zs = []
    with torch.inference_mode():
        for i in range(0, len(images), batch_size):
            x = torch.from_numpy(np.ascontiguousarray(
                images[i:i + batch_size], np.float32)).to(wl.device)
            zs.append(wl.vae.encode(x, generator=generator))
        z = torch.cat(zs)
        ctx = wl.get_learned_conditioning(prompts)
    return z.clone(), ctx.clone()
