"""RNG helpers: antithetic timestep sampling and conditioning-dropout masks.

Port of ``uurg_tpu/core/rng.py``. Every draw comes from an explicit
``torch.Generator`` (the JAX package threads ``jax.random`` keys). The two
streams never match bit for bit, so tests inject t, noise and keep.
"""
from __future__ import annotations

import torch


def step_seed(seed: int, step: int) -> int:
    """The generator seed of one step or batch: a function of (seed, step)
    alone, so a resumed run draws what the uninterrupted one would have
    (the JAX package folds the step into its key, or splits it once a
    batch). Both are mixed into every bit (the splitmix64 finaliser): the
    CPU generator seeds its Mersenne Twister from the low 32 bits only."""
    z = ((seed % 2**32) * 2**32 + step % 2**32 + 0x9E3779B97F4A7C15) % 2**64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) % 2**64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) % 2**64
    return (z ^ (z >> 31)) % 2**63


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
