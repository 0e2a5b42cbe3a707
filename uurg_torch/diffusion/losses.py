"""Epsilon-prediction losses and the adaptive ("adaga") re-weighting.

Port of ``uurg_tpu/diffusion/losses.py`` (DDPM/functions/losses.py:5-72):
- per-sample loss = sum over (H, W, C) of squared eps error
- batch loss = mean over batch
- adaptive weighting: coef_i = 1 / (loss_i^lambda + eps), detached;
  ad_loss_i = coef_i / sum(coef) * loss_i * batch_size
"""
from __future__ import annotations

import math
from typing import Callable

import torch
import torch.distributed as dist

from uurg_torch.diffusion.schedules import DiffusionSchedule
from uurg_torch.parallel.mesh import batch_split


def noise_estimation_loss(
    apply_fn: Callable[..., torch.Tensor],
    schedule: DiffusionSchedule,
    x0: torch.Tensor,
    t: torch.Tensor,
    noise: torch.Tensor,
    *apply_args,
    keepdim: bool = False,
    **apply_kwargs,
) -> torch.Tensor:
    """eps-MSE loss: ``apply_fn(x_t, t, *args, **kwargs)`` predicts eps.
    ``keepdim=True`` returns the per-sample vector (needed by adaga)."""
    x_t = schedule.q_sample(x0, t, noise)
    eps_hat = apply_fn(x_t, t, *apply_args, **apply_kwargs)
    per_sample = torch.sum(torch.square(noise - eps_hat),
                           dim=tuple(range(1, x0.ndim)))
    return per_sample if keepdim else per_sample.mean()


def adaptive_weights(per_sample_loss: torch.Tensor, lambd: float,
                     eps: float = 1e-8) -> torch.Tensor:
    """Detached normalized inverse-power weights (sum to batch size). The
    weights couple the batch: under a batch split the sum and the size are
    the global batch's, the sum all-reduced over the data axis only (ranks
    that share rows on another axis count them once)."""
    coef = 1.0 / (torch.pow(per_sample_loss.detach(), lambd) + eps)
    total, n = coef.sum(), per_sample_loss.shape[0]
    split = batch_split()
    if split.count > 1:
        dist.all_reduce(total, group=split.group)
        n *= split.count
    return coef / total * n


def adaptive_loss(per_sample_loss: torch.Tensor, lambd: float,
                  eps: float = 1e-8, keepdim: bool = False) -> torch.Tensor:
    """adaga loss from a per-sample loss vector. The reference uses
    eps=1e-8 in DDPM but 1e-15 in Classification/DiT."""
    ad = adaptive_weights(per_sample_loss, lambd, eps) * per_sample_loss
    return ad if keepdim else ad.mean()


def cosine_alpha_decay(base: float, step, total: int) -> float:
    """Cosine decay of forget_alpha: base*(1+cos(pi*step/total))/2
    (DDPM/functions/losses.py:71-72)."""
    return base * (1.0 + math.cos(math.pi * step / total)) / 2.0


def linear_alpha_decay(base: float, step, total: int,
                       power: float = 1.0) -> float:
    """(1 - step/total)^power decay (Classification/unlearn/sfron.py:39-43)."""
    return base * (1.0 - step / total) ** power
