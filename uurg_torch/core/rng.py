"""RNG helpers: antithetic timestep sampling and conditioning-dropout masks.

Port of ``uurg_tpu/core/rng.py``. Every draw comes from an explicit
``torch.Generator`` (the JAX package threads ``jax.random`` keys). The two
streams never match bit for bit, so tests inject t, noise and keep.
"""
from __future__ import annotations

import torch


def antithetic_timesteps(generator: torch.Generator, batch: int,
                         num_timesteps: int) -> torch.Tensor:
    """Sample ``t ~ U[0, T)`` antithetically: draw n//2+1 and mirror as
    T-1-t, cut to n (DDPM/runners/diffusion.py:1091-1094). int64 on the
    generator's device."""
    half = batch // 2 + 1
    t = torch.randint(0, num_timesteps, (half,), generator=generator,
                      device=generator.device)
    return torch.cat([t, num_timesteps - t - 1])[:batch]


def cond_keep_mask(generator: torch.Generator, batch: int,
                   cond_drop_prob: float) -> torch.Tensor:
    """Bernoulli keep-mask for classifier-free-guidance label dropout: True
    where the class label is KEPT (reference prob_mask_like,
    DDPM/models/diffusion.py:8-14 with prob = 1 - cond_drop_prob)."""
    dev = generator.device
    if cond_drop_prob <= 0.0:
        return torch.ones((batch,), dtype=torch.bool, device=dev)
    if cond_drop_prob >= 1.0:
        return torch.zeros((batch,), dtype=torch.bool, device=dev)
    return torch.rand((batch,), generator=generator, device=dev) >= cond_drop_prob
