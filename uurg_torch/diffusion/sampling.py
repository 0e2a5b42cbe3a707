"""DDIM / DDPM samplers.

Port of ``uurg_tpu/diffusion/sampling.py``: the ``lax.scan`` over timesteps
becomes a Python loop, and classifier-free guidance stays one batched 2N
forward. Noise comes from an explicit ``torch.Generator`` or from an
injected ``noise`` tensor of shape (num_steps, *x.shape), step i using
``noise[i]``.
"""
from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from uurg_torch.diffusion.schedules import DiffusionSchedule

# model_fn(x_t, t_int_vector) -> eps prediction, conditioning closed over.
ModelFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def make_step_sequence(num_timesteps: int, num_steps: int,
                       kind: str = "uniform", offset: int = 0) -> np.ndarray:
    """Sub-sequence of timesteps for accelerated sampling (ascending).

    ``uniform`` matches DDPM/runners/diffusion.py skip = T // timesteps,
    seq = range(0, T, skip); ``quad`` is the quadratic spacing variant;
    ``offset=1`` is the LDM convention (1, 1+skip, ...).
    """
    if kind == "uniform":
        skip = num_timesteps // num_steps
        seq = np.arange(0, num_timesteps, skip)
    elif kind == "quad":
        seq = (np.linspace(0, np.sqrt(num_timesteps * 0.8), num_steps) ** 2)
        seq = seq.astype(int)
    else:
        raise NotImplementedError(kind)
    return seq + offset


def _seq_pairs(seq: Sequence[int]) -> tuple[np.ndarray, np.ndarray]:
    """(t, t_next) pairs in sampling (descending) order, t_next[-1] = -1."""
    seq = np.asarray(seq, dtype=np.int32)
    seq_next = np.concatenate([[-1], seq[:-1]]).astype(np.int32)
    return seq[::-1].copy(), seq_next[::-1].copy()


def _step_noise(i: int, x: torch.Tensor, generator: torch.Generator | None,
                noise: torch.Tensor | None) -> torch.Tensor:
    if noise is not None:
        return noise[i]
    return torch.randn(x.shape, generator=generator, device=x.device,
                       dtype=x.dtype)


def ddim_sample(
    model_fn: ModelFn,
    schedule: DiffusionSchedule,
    x_init: torch.Tensor,
    seq: Sequence[int],
    *,
    eta: float = 0.0,
    generator: torch.Generator | None = None,
    noise: torch.Tensor | None = None,
) -> torch.Tensor:
    """Generalized (DDIM) sampling, eta in [0, 1]
    (DDPM/functions/denoising.py:10-33)."""
    ts, ts_next = _seq_pairs(seq)
    if eta != 0.0 and generator is None and noise is None:
        raise ValueError("eta > 0 requires a generator or injected noise")
    n = x_init.shape[0]
    x = x_init
    for i, (t, t_next) in enumerate(zip(ts.tolist(), ts_next.tolist())):
        t_vec = torch.full((n,), t, dtype=torch.int32, device=x.device)
        at = schedule.alpha_bar_padded(t)
        at_next = schedule.alpha_bar_padded(t_next)
        et = model_fn(x, t_vec)
        x0_t = (x - et * torch.sqrt(1.0 - at)) / torch.sqrt(at)
        c1 = eta * torch.sqrt((1 - at / at_next) * (1 - at_next) / (1 - at))
        c2 = torch.sqrt((1.0 - at_next) - c1**2)
        z = _step_noise(i, x, generator, noise) if eta != 0.0 else 0.0
        x = torch.sqrt(at_next) * x0_t + c1 * z + c2 * et
    return x


def ddpm_sample(
    model_fn: ModelFn,
    schedule: DiffusionSchedule,
    x_init: torch.Tensor,
    seq: Sequence[int],
    *,
    generator: torch.Generator | None = None,
    noise: torch.Tensor | None = None,
) -> torch.Tensor:
    """Ancestral sampling with x0-clamping (DDPM/functions/denoising.py:
    36-69: beta_t from the respaced alpha ratio, fixedlarge logvar, no noise
    at t == 0)."""
    ts, ts_next = _seq_pairs(seq)
    if generator is None and noise is None:
        raise ValueError("ddpm sampling requires a generator or injected noise")
    n = x_init.shape[0]
    x = x_init
    for i, (t, t_next) in enumerate(zip(ts.tolist(), ts_next.tolist())):
        t_vec = torch.full((n,), t, dtype=torch.int32, device=x.device)
        at = schedule.alpha_bar_padded(t)
        atm1 = schedule.alpha_bar_padded(t_next)
        beta_t = 1.0 - at / atm1
        e = model_fn(x, t_vec)
        x0 = torch.sqrt(1.0 / at) * x - torch.sqrt(1.0 / at - 1.0) * e
        x0 = torch.clamp(x0, -1.0, 1.0)
        mean = (torch.sqrt(atm1) * beta_t * x0
                + torch.sqrt(1.0 - beta_t) * (1.0 - atm1) * x) / (1.0 - at)
        z = _step_noise(i, x, generator, noise)
        nonzero = float(t > 0)
        x = mean + nonzero * torch.exp(0.5 * torch.log(beta_t)) * z
    return x


def cfg_model_fn(
    apply_fn: Callable[..., torch.Tensor],
    labels: torch.Tensor,
    cond_scale: float,
) -> ModelFn:
    """Classifier-free guidance as ONE batched double-forward.

    ``apply_fn(x, t, c, cond_keep)`` must honour a boolean per-sample
    keep-mask selecting the null class embedding when False. Output is
    ``(1 + s) * cond - s * uncond`` (DDPM/models/diffusion.py:340-355).
    """
    def fn(x, t):
        if cond_scale == 0.0:
            keep = torch.ones_like(labels, dtype=torch.bool)
            return apply_fn(x, t, labels, keep)
        n = x.shape[0]
        keep = torch.cat([torch.ones(n, dtype=torch.bool, device=x.device),
                          torch.zeros(n, dtype=torch.bool, device=x.device)])
        out = apply_fn(torch.cat([x, x]), torch.cat([t, t]),
                       torch.cat([labels, labels]), keep)
        cond, uncond = out[:n], out[n:]
        return (1.0 + cond_scale) * cond - cond_scale * uncond

    return fn
