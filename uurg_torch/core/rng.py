"""RNG helpers: antithetic timestep sampling, conditioning-dropout masks and
the seeded random weights of the evaluation networks.

Port of ``uurg_tpu/core/rng.py``. Every draw comes from an explicit
``torch.Generator`` (the JAX package threads ``jax.random`` keys). The two
streams never match bit for bit, so tests inject t, noise and keep.

Under a batch split (:func:`uurg_torch.parallel.mesh.split_batches`) the
draws of a batch's rows are made for the global batch, from the same
generator state on every rank, and cut to this rank's rows, so a data-
parallel step draws what the one-device step draws (JAX's partitionable
threefry gives the same). Without one nothing changes.
"""
from __future__ import annotations

from typing import Callable

import torch

from uurg_torch.parallel.mesh import batch_split, local_rows


def rows(draw: Callable[[int], torch.Tensor], n: int) -> torch.Tensor:
    """``draw(N)`` of the global batch's ``N`` rows, cut to the ``n`` rows
    of this rank (``draw(n)`` on one device)."""
    split = batch_split()
    if split.count == 1:
        return draw(n)
    return local_rows(draw(n * split.count), split)


def randn_rows(shape, generator: torch.Generator, device=None,
               dtype=None) -> torch.Tensor:
    """Standard normal of ``shape``, drawn for the global batch along
    dimension 0."""
    shape = tuple(shape)
    return rows(lambda b: torch.randn((b,) + shape[1:], generator=generator,
                                      device=device, dtype=dtype), shape[0])


def rand_rows(shape, generator: torch.Generator, device=None) -> torch.Tensor:
    """Uniform [0, 1) of ``shape``, drawn for the global batch along
    dimension 0."""
    shape = tuple(shape)
    return rows(lambda b: torch.rand((b,) + shape[1:], generator=generator,
                                     device=device), shape[0])


def randint_rows(high: int, n: int, generator: torch.Generator,
                 device=None) -> torch.Tensor:
    """``n`` integers uniform in [0, high), drawn for the global batch."""
    return rows(lambda b: torch.randint(0, high, (b,), generator=generator,
                                        device=device), n)


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
    generator's device; drawn for the global batch under a split."""

    def draw(b):
        t = torch.randint(0, num_timesteps, (b // 2 + 1,),
                          generator=generator, device=generator.device)
        return torch.cat([t, num_timesteps - t - 1])[:b]

    return rows(draw, batch)


def cond_keep_mask(generator: torch.Generator, batch: int,
                   cond_drop_prob: float) -> torch.Tensor:
    """Bernoulli keep-mask for classifier-free-guidance label dropout: True
    where the class label is KEPT (reference prob_mask_like,
    DDPM/models/diffusion.py:8-14 with prob = 1 - cond_drop_prob); drawn
    for the global batch under a split."""
    dev = generator.device
    if cond_drop_prob <= 0.0:
        return torch.ones((batch,), dtype=torch.bool, device=dev)
    if cond_drop_prob >= 1.0:
        return torch.zeros((batch,), dtype=torch.bool, device=dev)
    return rand_rows((batch,), generator, dev) >= cond_drop_prob


def seeded_init_(model: torch.nn.Module, seed: int,
                 conv_gain: float = 1.0) -> torch.nn.Module:
    """Seeded random weights in place, for an evaluation network run
    without its published checkpoint: normal convolutions of variance
    ``conv_gain / fan_in`` (1: LeCun, flax's default; 2: He, which keeps
    the scale of activations through a plain stack of ReLU layers),
    LeCun-normal linear layers, zero linear biases; BatchNorm keeps its
    identity statistics. Returns the model in eval mode. Its metrics are
    not comparable to published ones."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (torch.nn.Conv2d, torch.nn.Linear)):
                gain = conv_gain if isinstance(mod, torch.nn.Conv2d) else 1.0
                mod.weight.normal_(0.0, (gain / mod.weight[0].numel()) ** 0.5,
                                   generator=gen)
                if mod.bias is not None:
                    mod.bias.zero_()
    return model.eval()
