"""ADM-style Gaussian diffusion with learned variance (for DiT).

Port of ``uurg_tpu/diffusion/gaussian.py`` (the vendored ADM library of
DiT/diffusion/gaussian_diffusion.py:144-873 and respace.py:12-129):
eps-mean parameterisation, LEARNED_RANGE variance, the hybrid MSE + VB
training loss with the frozen-mean trick, ancestral and DDIM sampling, and
timestep respacing with the rescaled-t map.

The constants are built in float64 numpy exactly as the JAX module builds
them and cast once to float32 tensors on the device, so a gathered constant
is bit-equal to the JAX package's. The model function's signature is
``model_fn(x, t, **kwargs) -> (B, H, W, 2C)`` (eps | raw variance) for
learned-sigma models, or ``(B, H, W, C)`` for fixed variance. Random draws
come from an explicit ``torch.Generator`` or are injected (``noise`` of
``training_losses``; ``x_T`` and ``step_noise`` of the samplers), since the
two packages' streams never match bit for bit.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


def linear_beta_schedule(T: int, scale_ref: int = 1000,
                         max_beta: float = 0.999) -> np.ndarray:
    """ADM linear schedule scaled for any T, clipped to ``max_beta`` (the
    ADM scaling gives betas > 1 for very short schedules)."""
    scale = scale_ref / T
    betas = np.linspace(scale * 1e-4, scale * 2e-2, T, dtype=np.float64)
    return np.clip(betas, 0.0, max_beta)


def cosine_beta_schedule(T: int, max_beta: float = 0.999) -> np.ndarray:
    f = lambda t: np.cos((t / T + 0.008) / 1.008 * np.pi / 2) ** 2  # noqa: E731
    t = np.arange(T)
    return np.clip(1 - f(t + 1) / f(t), 0, max_beta)


def normal_kl(mean1, logvar1, mean2, logvar2):
    """KL(N1 || N2) elementwise (DiT/diffusion/diffusion_utils.py)."""
    return 0.5 * (-1.0 + logvar2 - logvar1 + torch.exp(logvar1 - logvar2)
                  + torch.square(mean1 - mean2) * torch.exp(-logvar2))


def approx_standard_normal_cdf(x):
    return 0.5 * (1.0 + torch.tanh(
        math.sqrt(2.0 / math.pi) * (x + 0.044715 * torch.pow(x, 3))))


def discretized_gaussian_log_likelihood(x, means, log_scales):
    """Log-likelihood of 8-bit-discretised data under N(means,
    exp(2 * log_scales))."""
    centered = x - means
    inv_stdv = torch.exp(-log_scales)
    cdf_plus = approx_standard_normal_cdf(inv_stdv * (centered + 1.0 / 255.0))
    cdf_min = approx_standard_normal_cdf(inv_stdv * (centered - 1.0 / 255.0))
    log_cdf_plus = torch.log(torch.clamp(cdf_plus, min=1e-12))
    log_one_minus_cdf_min = torch.log(torch.clamp(1.0 - cdf_min, min=1e-12))
    log_delta = torch.log(torch.clamp(cdf_plus - cdf_min, min=1e-12))
    return torch.where(x < -0.999, log_cdf_plus,
                       torch.where(x > 0.999, log_one_minus_cdf_min,
                                   log_delta))


def _mean_flat(x: torch.Tensor) -> torch.Tensor:
    return x.mean(dim=tuple(range(1, x.ndim)))


@dataclasses.dataclass(frozen=True)
class GaussianDiffusion:
    """Precomputed constants, float32 tensors on ``device``, gathered per
    t."""

    betas: np.ndarray
    learn_sigma: bool = True
    # respacing: positions in this (possibly shortened) schedule -> the
    # original model's timesteps (identity when not respaced)
    timestep_map: np.ndarray | None = None
    rescale_timesteps: bool = False
    original_num_steps: int | None = None
    device: torch.device | str = "cpu"

    def __post_init__(self):
        betas = np.asarray(self.betas, np.float64)
        object.__setattr__(self, "betas", betas)
        T = len(betas)
        alphas = 1.0 - betas
        acp = np.cumprod(alphas)
        acp_prev = np.append(1.0, acp[:-1])
        c = {}
        c["alphas_cumprod"] = acp
        c["alphas_cumprod_prev"] = acp_prev
        c["sqrt_alphas_cumprod"] = np.sqrt(acp)
        c["sqrt_one_minus_alphas_cumprod"] = np.sqrt(1 - acp)
        c["sqrt_recip_alphas_cumprod"] = np.sqrt(1.0 / acp)
        c["sqrt_recipm1_alphas_cumprod"] = np.sqrt(1.0 / acp - 1)
        pv = betas * (1.0 - acp_prev) / (1.0 - acp)
        c["posterior_variance"] = pv
        c["posterior_log_variance_clipped"] = np.log(
            np.append(pv[1], pv[1:])) if T > 1 else np.log(pv)
        c["posterior_mean_coef1"] = betas * np.sqrt(acp_prev) / (1.0 - acp)
        c["posterior_mean_coef2"] = ((1.0 - acp_prev) * np.sqrt(alphas)
                                     / (1.0 - acp))
        c["log_betas"] = np.log(np.maximum(betas, 1e-20))
        dev = torch.device(self.device)
        object.__setattr__(self, "device", dev)
        object.__setattr__(self, "_c", {
            k: torch.from_numpy(v).to(torch.float32).to(dev)
            for k, v in c.items()})
        if self.timestep_map is None:
            object.__setattr__(self, "timestep_map", np.arange(T))
        if self.original_num_steps is None:
            object.__setattr__(self, "original_num_steps", T)
        object.__setattr__(self, "_tmap", torch.as_tensor(
            np.asarray(self.timestep_map), dtype=torch.int64, device=dev))

    # -- helpers -----------------------------------------------------------

    @property
    def num_timesteps(self) -> int:
        return len(self.betas)

    def _g(self, name: str, t, shape):
        """Constant ``name`` at t, broadcast to batch shape."""
        return self._c[name][t].reshape((-1,) + (1,) * (len(shape) - 1))

    def _model_t(self, t):
        """Respaced t -> the original model's t (SpacedDiffusion)."""
        mt = self._tmap[t]
        if self.rescale_timesteps:
            mt = mt.to(torch.float32) * (1000.0 / self.original_num_steps)
        return mt

    def q_sample(self, x0, t, noise):
        return (self._g("sqrt_alphas_cumprod", t, x0.shape) * x0
                + self._g("sqrt_one_minus_alphas_cumprod", t, x0.shape)
                * noise)

    def q_posterior(self, x0, x_t, t):
        mean = (self._g("posterior_mean_coef1", t, x_t.shape) * x0
                + self._g("posterior_mean_coef2", t, x_t.shape) * x_t)
        var = self._g("posterior_variance", t, x_t.shape)
        logvar = self._g("posterior_log_variance_clipped", t, x_t.shape)
        return mean, var, logvar

    def predict_x0_from_eps(self, x_t, t, eps):
        return (self._g("sqrt_recip_alphas_cumprod", t, x_t.shape) * x_t
                - self._g("sqrt_recipm1_alphas_cumprod", t, x_t.shape) * eps)

    def _split_model_out(self, out, x_t):
        C = x_t.shape[-1]
        if self.learn_sigma:
            if out.shape[-1] != 2 * C:
                raise ValueError(f"learned sigma wants {2 * C} output "
                                 f"channels, got {out.shape[-1]}")
            return out[..., :C], out[..., C:]
        return out, None

    def _model_logvar(self, var_raw, t, shape):
        """LEARNED_RANGE: v in [-1, 1] interpolates [posterior_log,
        log_beta]."""
        min_log = self._g("posterior_log_variance_clipped", t, shape)
        max_log = self._g("log_betas", t, shape)
        frac = (var_raw + 1.0) / 2.0
        return frac * max_log + (1.0 - frac) * min_log

    def p_mean_variance(self, model_fn, x_t, t, clip_denoised=True, **kwargs):
        out = model_fn(x_t, self._model_t(t), **kwargs)
        eps, var_raw = self._split_model_out(out, x_t)
        if self.learn_sigma:
            logvar = self._model_logvar(var_raw, t, x_t.shape)
        else:
            logvar = self._g("posterior_log_variance_clipped", t, x_t.shape)
        x0 = self.predict_x0_from_eps(x_t, t, eps)
        if clip_denoised:
            x0 = torch.clamp(x0, -1.0, 1.0)
        mean, _, _ = self.q_posterior(x0, x_t, t)
        return mean, logvar, x0, eps

    # -- training losses ---------------------------------------------------

    def vb_term(self, model_fn, x0, x_t, t, **kwargs):
        """L_t = KL(q(x_{t-1}|x_t, x0) || p(x_{t-1}|x_t)) in bits/dim, the
        decoder NLL at t == 0 (gaussian_diffusion.py _vb_terms_bpd)."""
        true_mean, _, true_logvar = self.q_posterior(x0, x_t, t)
        mean, logvar, _, _ = self.p_mean_variance(
            model_fn, x_t, t, clip_denoised=False, **kwargs)
        kl = _mean_flat(normal_kl(true_mean, true_logvar, mean, logvar))
        nll = -discretized_gaussian_log_likelihood(x0, mean, 0.5 * logvar)
        nll = _mean_flat(nll)
        return torch.where(t == 0, nll, kl) / math.log(2.0)

    def training_losses(self, model_fn, x0, t, noise=None, *,
                        generator: torch.Generator | None = None,
                        keepdim: bool = False, **kwargs):
        """Hybrid loss: per-sample mean eps-MSE + VB (frozen-mean trick:
        eps is detached inside the VB model call, so the VB gradient trains
        the variance channels only). ``noise`` is drawn from ``generator``
        when not given."""
        if noise is None:
            noise = torch.randn(x0.shape, generator=generator,
                                device=x0.device, dtype=x0.dtype)
        x_t = self.q_sample(x0, t, noise)
        out = model_fn(x_t, self._model_t(t), **kwargs)
        eps, var_raw = self._split_model_out(out, x_t)
        total = _mean_flat(torch.square(noise - eps))
        if self.learn_sigma:
            frozen = torch.cat([eps.detach(), var_raw], dim=-1)
            total = total + self.vb_term(lambda *a, **k: frozen, x0, x_t, t)
        return total if keepdim else total.mean()

    # -- sampling ----------------------------------------------------------

    def _draw(self, shape, generator, given):
        if given is not None:
            return given
        return torch.randn(shape, generator=generator, device=self.device)

    def p_sample_loop(self, model_fn, shape, generator=None, *,
                      x_T=None, step_noise=None, clip_denoised=True,
                      **kwargs):
        """Ancestral sampling over every respaced step, from ``x_T``; the
        per-step noise is ``step_noise[i]`` (i counts the steps taken) or
        drawn from ``generator``."""
        x = self._draw(shape, generator, x_T)
        for i, ts in enumerate(range(self.num_timesteps - 1, -1, -1)):
            t = torch.full((shape[0],), ts, dtype=torch.int64,
                           device=x.device)
            mean, logvar, _, _ = self.p_mean_variance(
                model_fn, x, t, clip_denoised, **kwargs)
            noise = self._draw(x.shape, generator,
                               None if step_noise is None else step_noise[i])
            x = mean + float(ts > 0) * torch.exp(0.5 * logvar) * noise
        return x

    def ddim_sample_loop(self, model_fn, shape, generator=None, *, eta=0.0,
                         x_T=None, step_noise=None, clip_denoised=True,
                         **kwargs):
        x = self._draw(shape, generator, x_T)
        for i, ts in enumerate(range(self.num_timesteps - 1, -1, -1)):
            t = torch.full((shape[0],), ts, dtype=torch.int64,
                           device=x.device)
            _, _, x0, eps = self.p_mean_variance(
                model_fn, x, t, clip_denoised, **kwargs)
            abar = self._g("alphas_cumprod", t, x.shape)
            abar_prev = self._g("alphas_cumprod_prev", t, x.shape)
            sigma = (eta * torch.sqrt((1 - abar_prev) / (1 - abar))
                     * torch.sqrt(1 - abar / abar_prev))
            mean = (torch.sqrt(abar_prev) * x0
                    + torch.sqrt(1 - abar_prev - sigma ** 2) * eps)
            noise = self._draw(x.shape, generator,
                               None if step_noise is None else step_noise[i])
            x = mean + float(ts > 0) * sigma * noise
        return x


def space_timesteps(num_timesteps: int, section_counts) -> list[int]:
    """ADM respacing spec parser (DiT/diffusion/respace.py:12-63): "ddimN",
    a comma list of per-section counts, or an int N."""
    if isinstance(section_counts, str):
        if section_counts.startswith("ddim"):
            desired = int(section_counts[len("ddim"):])
            for i in range(1, num_timesteps):
                if len(range(0, num_timesteps, i)) == desired:
                    return list(range(0, num_timesteps, i))
            raise ValueError(f"cannot create exactly {desired} ddim steps")
        section_counts = ([int(x) for x in section_counts.split(",")]
                          if section_counts else [num_timesteps])
    elif isinstance(section_counts, int):
        section_counts = [section_counts]
    size_per = num_timesteps // len(section_counts)
    extra = num_timesteps % len(section_counts)
    start, all_steps = 0, []
    for i, count in enumerate(section_counts):
        size = size_per + (1 if i < extra else 0)
        if size < count:
            raise ValueError(f"cannot divide section of {size} into {count}")
        stride = 1 if count <= 1 else (size - 1) / (count - 1)
        cur, taken = 0.0, []
        for _ in range(count):
            taken.append(start + round(cur))
            cur += stride
        all_steps += taken
        start += size
    return all_steps


def make_diffusion(timestep_respacing: str | int = "",
                   num_timesteps: int = 1000,
                   learn_sigma: bool = True,
                   schedule: str = "linear",
                   device: torch.device | str = "cpu") -> GaussianDiffusion:
    """DiT ``create_diffusion`` (DiT/diffusion/__init__.py:10-46), its
    constants on ``device``."""
    betas = (linear_beta_schedule(num_timesteps) if schedule == "linear"
             else cosine_beta_schedule(num_timesteps))
    if timestep_respacing in ("", None):
        return GaussianDiffusion(betas=betas, learn_sigma=learn_sigma,
                                 device=device)
    use = sorted(space_timesteps(num_timesteps, timestep_respacing))
    last_abar = 1.0
    acp = np.cumprod(1.0 - betas)
    new_betas = []
    for i in use:
        new_betas.append(1 - acp[i] / last_abar)
        last_abar = acp[i]
    return GaussianDiffusion(
        betas=np.asarray(new_betas), learn_sigma=learn_sigma,
        timestep_map=np.asarray(use), original_num_steps=num_timesteps,
        device=device)
