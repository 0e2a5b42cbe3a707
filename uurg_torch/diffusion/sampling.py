"""DDIM, DDPM, PLMS and LMS samplers.

Port of ``uurg_tpu/diffusion/sampling.py``: the ``lax.scan`` over timesteps
becomes a Python loop, and classifier-free guidance stays one batched 2N
forward. Noise comes from an explicit ``torch.Generator`` or from an
injected ``noise`` tensor of shape (num_steps, *x.shape), step i using
``noise[i]``. ``ddim_sample_till``, ``plms_sample`` and ``lms_sample`` are
SD's (its workload's ``make_sampler`` and ``make_quick_sampler``).
"""
from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from uurg_torch.core.rng import randn_rows
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
    return randn_rows(x.shape, generator, x.device, x.dtype)


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


def ddim_sample_till(
    model_fn: ModelFn,
    schedule: DiffusionSchedule,
    x_init: torch.Tensor,
    seq: Sequence[int],
    till: int,
    *,
    eta: float = 0.0,
    generator: torch.Generator | None = None,
    noise: torch.Tensor | None = None,
) -> torch.Tensor:
    """Partial DDIM denoise: from the top of ``seq`` down, stopping after
    the step at DDIM index ``till - 1`` (the latent at about the noise level
    of ``seq[till - 1]``); ``till == 0`` runs the whole chain
    (SD/ldm/models/diffusion/ddim.py:241-281, the ``till_T`` early break
    behind train-esd.py's ``quick_sample_till_t``). ``noise[i]`` is step
    i's draw when injected."""
    ts, ts_next = _seq_pairs(seq)
    if eta != 0.0 and generator is None and noise is None:
        raise ValueError("eta > 0 requires a generator or injected noise")
    till = int(till)
    n_run = len(ts) - till + 1 if till > 0 else len(ts)
    n = x_init.shape[0]
    x = x_init
    for i in range(n_run):
        t, t_next = int(ts[i]), int(ts_next[i])
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


def plms_sample(
    model_fn: ModelFn,
    schedule: DiffusionSchedule,
    x_init: torch.Tensor,
    seq: Sequence[int],
) -> torch.Tensor:
    """PLMS (pseudo linear multistep) sampling, deterministic
    (SD/ldm/models/diffusion/plms.py, ``p_sample_plms``): the first step is
    a pseudo improved Euler (a second model call at t_next, the two eps
    averaged), the next ones the Adams-Bashforth combinations of order 2, 3
    and then 4 of the last eps values."""
    ts, ts_next = _seq_pairs(seq)
    n = x_init.shape[0]

    def t_vec(t: int) -> torch.Tensor:
        return torch.full((n,), t, dtype=torch.int32, device=x_init.device)

    def x_prev(x, e, t: int, t_next: int):
        at = schedule.alpha_bar_padded(t)
        at_next = schedule.alpha_bar_padded(t_next)
        x0_t = (x - e * torch.sqrt(1.0 - at)) / torch.sqrt(at)
        return torch.sqrt(at_next) * x0_t + torch.sqrt(1.0 - at_next) * e

    t0, tn0 = int(ts[0]), int(ts_next[0])
    e_t = model_fn(x_init, t_vec(t0))
    e_next = model_fn(x_prev(x_init, e_t, t0, tn0), t_vec(max(tn0, 0)))
    x = x_prev(x_init, (e_t + e_next) / 2.0, t0, tn0)
    hist = [e_t, e_t, e_t]                 # most recent first
    for i in range(1, len(ts)):
        t, t_next = int(ts[i]), int(ts_next[i])
        e_t = model_fn(x, t_vec(t))
        order = min(i, 3)
        if order == 1:
            e_prime = (3.0 * e_t - hist[0]) / 2.0
        elif order == 2:
            e_prime = (23.0 * e_t - 16.0 * hist[0] + 5.0 * hist[1]) / 12.0
        else:
            e_prime = (55.0 * e_t - 59.0 * hist[0] + 37.0 * hist[1]
                       - 9.0 * hist[2]) / 24.0
        x = x_prev(x, e_prime, t, t_next)
        hist = [e_t, hist[0], hist[1]]
    return x


def lms_coefficients(sigmas: np.ndarray, order: int = 4) -> np.ndarray:
    """Integrated Lagrange-basis coefficients of sigma-space linear
    multistep sampling (diffusers ``LMSDiscreteScheduler.
    get_lms_coefficient``, SD/eval-scripts/generate-images.py:86-91).
    ``sigmas``: the N descending noise levels and the trailing 0. Returns
    (N, order) float64: row i weights the newest ``min(i + 1, order)``
    eps-derivatives (column 0 the newest), the unused columns zero. The
    degree <= 3 basis polynomials are integrated analytically, where
    diffusers integrates by adaptive quadrature."""
    sigmas = np.asarray(sigmas, np.float64)
    n = len(sigmas) - 1
    out = np.zeros((n, order), np.float64)
    for i in range(n):
        cur = min(i + 1, order)
        for j in range(cur):
            roots = [sigmas[i - k] for k in range(cur) if k != j]
            denom = float(np.prod([sigmas[i - j] - r for r in roots]))
            # monic numerator polynomial, integrated analytically
            # (atleast_1d: np.poly([]) is a 0-d scalar at order 1)
            anti = np.polyint(np.atleast_1d(np.poly(roots)))
            out[i, j] = (np.polyval(anti, sigmas[i + 1])
                         - np.polyval(anti, sigmas[i])) / (denom or 1.0)
    return out


def lms_sample(
    model_fn: ModelFn,
    schedule: DiffusionSchedule,
    x_init: torch.Tensor,
    num_steps: int,
    *,
    order: int = 4,
) -> torch.Tensor:
    """LMS sampling in sigma space, the diffusers ``LMSDiscreteScheduler``
    protocol of the reference's generation evaluator
    (SD/eval-scripts/generate-images.py:86-91,150-180): float timesteps
    ``linspace(T - 1, 0, num_steps)`` with sigmas interpolated linearly
    between the training levels and a trailing 0; ``x_init`` unit noise,
    scaled here by the first sigma; the model input scaled by
    ``1 / sqrt(sigma^2 + 1)`` and ``model_fn`` given float32 timesteps; each
    step adds the row of :func:`lms_coefficients` dotted with the
    eps-derivative history. The last sigma is 0, so the result is the
    predicted x0, decodable as ``ddim``'s and ``plms``'s."""
    ab = schedule.alphas_cumprod.double().cpu().numpy()
    full_sigmas = np.sqrt((1.0 - ab) / ab)
    T = len(ab)
    timesteps = np.linspace(T - 1, 0, num_steps, dtype=np.float64)
    sigmas = np.concatenate(
        [np.interp(timesteps, np.arange(T), full_sigmas), [0.0]])
    coeffs = torch.as_tensor(lms_coefficients(sigmas, order),
                             dtype=torch.float32, device=x_init.device)
    ts32 = np.asarray(timesteps, np.float32)
    sig32 = torch.as_tensor(sigmas[:-1], dtype=torch.float32,
                            device=x_init.device)
    n = x_init.shape[0]
    x = x_init * sig32[0]
    hist = torch.zeros((order,) + tuple(x_init.shape), dtype=x_init.dtype,
                       device=x_init.device)
    for i in range(num_steps):
        sigma = sig32[i]
        t_vec = torch.full((n,), float(ts32[i]), dtype=torch.float32,
                           device=x.device)
        eps = model_fn(x / torch.sqrt(sigma * sigma + 1.0), t_vec)
        # the derivative with respect to sigma; for eps prediction it IS
        # eps, routed through x0 as the reference does for its rounding
        x0 = x - sigma * eps
        d = (x - x0) / sigma
        hist = torch.cat([d[None], hist[:-1]])
        x = x + torch.tensordot(coeffs[i], hist, dims=1)
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
