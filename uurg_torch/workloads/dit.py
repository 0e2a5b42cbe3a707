"""DiT workload: latent-space class forgetting on ImageNet
(reference: DiT/forget.py, DiT/generate_fisher.py, DiT/generate_mask.py).

Port of ``uurg_tpu/workloads/dit.py``. Latents arrive already VAE-encoded
and scaled by ``VAE_SCALE`` (the reference encodes each batch through a
frozen AutoencoderKL, DiT/forget.py:265-267; the VAE comes with a later
slice of the port). Loss functions have the engine's signature
``loss_fn(model, batch, generator) -> scalar`` with ``batch = (x, y)``: x
float32 NHWC latents, y int64 labels, both on the workload's device. The
timesteps are drawn uniformly and the noise normally from ``generator``;
:meth:`DiTWorkload.per_sample_loss` takes them injected.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable

import torch

from uurg_torch.core.device import resolve_device
from uurg_torch.core.rng import randint_rows, randn_rows
from uurg_torch.diffusion.gaussian import GaussianDiffusion, make_diffusion
from uurg_torch.diffusion.losses import adaptive_loss
from uurg_torch.diffusion.timestep_sampler import (sample_timesteps,
                                                   update_with_all_losses)
from uurg_torch.models.dit import DiT, DiTConfig, DiT_configs, init_dit

VAE_SCALE = 0.18215


@dataclasses.dataclass
class DiTWorkload:
    cfg: DiTConfig
    diffusion: GaussianDiffusion
    device: torch.device
    lambd: float = 0.5
    # the forward override, (model, x, t, y, cond_keep) -> model output:
    # the pipelined forward under parallelism="pp"
    # (parallel/pipeline.py dit_apply_pipelined); None: ``model(...)``
    apply_fn: Callable | None = None

    @classmethod
    def build(cls, name: str = "DiT-XL/2", image_size: int = 256,
              num_classes: int = 1000, lambd: float = 0.5,
              dtype: torch.dtype = torch.bfloat16,
              device: str | torch.device | None = None,
              **overrides) -> "DiTWorkload":
        """``overrides`` go to :class:`DiTConfig` (e.g.
        ``remat_policy="attn"``). ``device`` defaults to CUDA and raises
        without it."""
        dev = resolve_device(device)
        cfg = dataclasses.replace(
            DiT_configs[name](), input_size=image_size // 8,
            num_classes=num_classes, dtype=dtype, **overrides)
        return cls(cfg=cfg,
                   diffusion=make_diffusion("", 1000, learn_sigma=True,
                                            device=dev),
                   device=dev, lambd=lambd)

    def init_params(self, seed: int) -> DiT:
        """A seeded fresh model on this workload's device."""
        return init_dit(seed, self.cfg, self.device)

    def forward(self, model: DiT, x, t, y, cond_keep=None) -> torch.Tensor:
        """The model's output through :attr:`apply_fn` when one is set,
        else ``model(x, t, y, cond_keep)``: every loss and the sampler
        call the model here."""
        if self.apply_fn is not None:
            return self.apply_fn(model, x, t, y, cond_keep)
        return model(x, t, y, cond_keep)

    @contextlib.contextmanager
    def applying(self, apply_fn: Callable):
        """:attr:`apply_fn` set to ``apply_fn`` within the block, restored
        after it."""
        before, self.apply_fn = self.apply_fn, apply_fn
        try:
            yield self
        finally:
            self.apply_fn = before

    # -- losses ------------------------------------------------------------

    def _draw(self, x: torch.Tensor, generator: torch.Generator):
        t = randint_rows(self.diffusion.num_timesteps, x.shape[0], generator,
                         x.device)
        noise = randn_rows(x.shape, generator, x.device, x.dtype)
        return t, noise

    def per_sample_loss(self, model: DiT, x: torch.Tensor, y: torch.Tensor,
                        t: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        """The hybrid MSE + VB loss per sample at GIVEN timesteps and noise,
        every label kept."""
        return self.diffusion.training_losses(
            lambda x_t, tv: self.forward(model, x_t, tv, y), x, t, noise,
            keepdim=True)

    def _per_sample(self, model, batch, generator):
        x, y = batch
        return self.per_sample_loss(model, x, y, *self._draw(x, generator))

    def train_loss_fn(self) -> Callable:
        def fn(model, batch, generator):
            return self._per_sample(model, batch, generator).mean()
        return fn

    def train_loss_with_sampler_fn(self, uniform_prob: float = 0.001
                                   ) -> Callable:
        """The loss-second-moment resampled training loss (ADM's loss-aware
        sampler, DiT/diffusion/timestep_sampler.py:120-150):
        ``fn(model, batch, generator, sampler_state) -> (loss,
        new_sampler_state)``, the importance-weighted per-sample mean and
        the updated ring buffer."""

        def fn(model, batch, generator, sampler_state):
            x, y = batch
            t, w = sample_timesteps(sampler_state, generator, x.shape[0],
                                    uniform_prob)
            noise = randn_rows(x.shape, generator, x.device, x.dtype)
            per = self.per_sample_loss(model, x, y, t, noise)
            new_state = update_with_all_losses(sampler_state, t, per)
            return (w * per).mean(), new_state

        return fn

    def ga_forget_loss_fn(self) -> Callable:
        """-mean(training_losses) (DiT/forget.py:269-272)."""
        def fn(model, batch, generator):
            return -self._per_sample(model, batch, generator).mean()
        return fn

    def adaga_forget_loss_fn(self) -> Callable:
        """-adaptive_loss over the per-sample hybrid losses
        (DiT/forget.py:38-50, eps 1e-15)."""
        def fn(model, batch, generator):
            per = self._per_sample(model, batch, generator)
            return -adaptive_loss(per, self.lambd, eps=1e-15)
        return fn

    def rl_forget_loss_fn(self, label_to_forget: int) -> Callable:
        """Random-label forgetting: the forget-class output pushed toward
        the detached output under the pseudo class ``(label_to_forget + 1)
        % num_classes``, all channels."""
        pseudo = (label_to_forget + 1) % self.cfg.num_classes

        def fn(model, batch, generator):
            x, y = batch
            t, noise = self._draw(x, generator)
            x_t = self.diffusion.q_sample(x, t, noise)
            out = self.forward(model, x_t, t, y)
            with torch.no_grad():
                target = self.forward(model, x_t, t,
                                      torch.full_like(y, pseudo))
            return torch.mean(torch.square(out - target))

        return fn

    def forget_loss_fn(self, kind: str, label_to_forget: int = 0) -> Callable:
        """``adaga``, ``ga``, or anything else: ``rl`` (as the JAX
        workload)."""
        if kind == "adaga":
            return self.adaga_forget_loss_fn()
        if kind == "ga":
            return self.ga_forget_loss_fn()
        return self.rl_forget_loss_fn(label_to_forget)

    # -- sampling ----------------------------------------------------------

    def make_sampler(self, *, respacing: str = "250", cond_scale: float = 4.0,
                     cfg_channels: int | None = 3) -> Callable:
        """``sample(model, labels, generator, x_T=None, step_noise=None)``:
        ancestral CFG sampling over a respaced diffusion, one batched double
        forward a step (cond | null label); guidance on the first
        ``cfg_channels`` only (the DiT/models.py:250-267 quirk), the other
        eps channels conditional."""
        diff = make_diffusion(respacing, 1000, learn_sigma=True,
                              device=self.device)
        C = self.cfg.in_channels

        @torch.inference_mode()
        def sample(model: DiT, labels: torch.Tensor,
                   generator: torch.Generator | None = None,
                   x_T: torch.Tensor | None = None, step_noise=None):
            n = labels.shape[0]
            shape = (n, self.cfg.input_size, self.cfg.input_size, C)
            y2 = torch.cat([labels, labels])
            keep = torch.arange(2 * n, device=labels.device) < n

            def cfg_model(x, t, **kw):
                out = self.forward(model, torch.cat([x, x]),
                                   torch.cat([t, t]), y2, keep)
                cond, uncond = out[:n], out[n:]
                eps_c, rest_c = cond[..., :C], cond[..., C:]
                eps_u = uncond[..., :C]
                if cfg_channels is not None and cfg_channels < C:
                    k = cfg_channels
                    g = eps_u[..., :k] + cond_scale * (eps_c[..., :k]
                                                       - eps_u[..., :k])
                    eps = torch.cat([g, eps_c[..., k:]], dim=-1)
                else:
                    eps = eps_u + cond_scale * (eps_c - eps_u)
                return torch.cat([eps, rest_c], dim=-1)

            return diff.p_sample_loop(cfg_model, shape, generator, x_T=x_T,
                                      step_noise=step_noise)

        return sample
