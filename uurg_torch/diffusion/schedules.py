"""Beta schedules and precomputed diffusion constants.

Port of ``uurg_tpu/diffusion/schedules.py``: schedules are built in float64
with numpy, then cast once to the working dtype (DDPM/runners/diffusion.py
numerics).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


def get_beta_schedule(
    beta_schedule: str,
    *,
    beta_start: float,
    beta_end: float,
    num_diffusion_timesteps: int,
) -> np.ndarray:
    """Supported: linear | quad | const | jsd | sigmoid (reference parity)."""
    T = num_diffusion_timesteps
    if beta_schedule == "quad":
        betas = np.linspace(beta_start**0.5, beta_end**0.5, T, dtype=np.float64) ** 2
    elif beta_schedule == "linear":
        betas = np.linspace(beta_start, beta_end, T, dtype=np.float64)
    elif beta_schedule == "const":
        betas = beta_end * np.ones(T, dtype=np.float64)
    elif beta_schedule == "jsd":
        betas = 1.0 / np.linspace(T, 1, T, dtype=np.float64)
    elif beta_schedule == "sigmoid":
        x = np.linspace(-6, 6, T)
        betas = 1.0 / (1.0 + np.exp(-x)) * (beta_end - beta_start) + beta_start
    else:
        raise NotImplementedError(beta_schedule)
    assert betas.shape == (T,)
    return betas


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    """All per-timestep constants needed by losses and samplers."""

    betas: torch.Tensor                # (T,)
    alphas_cumprod: torch.Tensor       # (T,)
    logvar: torch.Tensor               # (T,) fixedlarge/fixedsmall sampling logvar

    @property
    def num_timesteps(self) -> int:
        return self.betas.shape[0]

    def alpha_bar(self, t) -> torch.Tensor:
        """alphas_cumprod gathered at integer timesteps ``t`` (any shape)."""
        return self.alphas_cumprod[t]

    def alpha_bar_padded(self, t) -> torch.Tensor:
        """``compute_alpha`` semantics (DDPM/functions/denoising.py:4-7):
        a prepended 1 so t = -1 yields alpha_bar = 1."""
        ones = torch.ones((1,), dtype=self.alphas_cumprod.dtype,
                          device=self.alphas_cumprod.device)
        return torch.cat([ones, self.alphas_cumprod])[t + 1]

    def q_sample(self, x0: torch.Tensor, t: torch.Tensor,
                 noise: torch.Tensor) -> torch.Tensor:
        """Forward-process sample x_t = sqrt(abar) x0 + sqrt(1-abar) eps."""
        a = self.alpha_bar(t).reshape((-1,) + (1,) * (x0.ndim - 1))
        return x0 * torch.sqrt(a) + noise * torch.sqrt(1.0 - a)


def make_schedule(
    beta_schedule: str = "linear",
    beta_start: float = 1e-4,
    beta_end: float = 2e-2,
    num_diffusion_timesteps: int = 1000,
    var_type: str = "fixedlarge",
    dtype: torch.dtype = torch.float32,
    device: str | torch.device = "cpu",
) -> DiffusionSchedule:
    betas64 = get_beta_schedule(
        beta_schedule,
        beta_start=beta_start,
        beta_end=beta_end,
        num_diffusion_timesteps=num_diffusion_timesteps,
    )
    alphas = 1.0 - betas64
    alphas_cumprod = np.cumprod(alphas)
    alphas_cumprod_prev = np.concatenate([[1.0], alphas_cumprod[:-1]])
    posterior_variance = betas64 * (1.0 - alphas_cumprod_prev) / (1.0 - alphas_cumprod)
    if var_type == "fixedlarge":
        logvar = np.log(betas64)
    elif var_type == "fixedsmall":
        logvar = np.log(np.maximum(posterior_variance, 1e-20))
    else:
        raise NotImplementedError(var_type)

    def cast(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    return DiffusionSchedule(betas=cast(betas64),
                             alphas_cumprod=cast(alphas_cumprod),
                             logvar=cast(logvar))
