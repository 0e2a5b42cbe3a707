"""Data-range transforms (port of ``uurg_tpu/data/transforms.py``).

Images are float32 NHWC in [0, 1]; ``data_transform`` rescales to [-1, 1]
when the config asks (``rescaled: true``), with optional uniform/gaussian
dequantization drawn from an explicit generator.
"""
from __future__ import annotations

import torch


def data_transform(cfg, x: torch.Tensor,
                   generator: torch.Generator | None = None) -> torch.Tensor:
    d = cfg.data
    if d.get("uniform_dequantization", False):
        if generator is None:
            raise ValueError("uniform dequantization needs a generator")
        u = torch.rand(x.shape, generator=generator, device=x.device)
        x = (x * 255.0 + u) / 256.0
    if d.get("gaussian_dequantization", False):
        if generator is None:
            raise ValueError("gaussian dequantization needs a generator")
        x = x + torch.randn(x.shape, generator=generator, device=x.device) * 0.01
    if d.get("rescaled", False):
        x = 2.0 * x - 1.0
    return x


def inverse_data_transform(cfg, x: torch.Tensor) -> torch.Tensor:
    if cfg.data.get("rescaled", False):
        x = (x + 1.0) / 2.0
    return torch.clamp(x, 0.0, 1.0)
