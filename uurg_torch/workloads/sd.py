"""Stable Diffusion workload: latent diffusion and the concept-erasure
losses.

Port of ``uurg_tpu/workloads/sd.py``: LatentDiffusion's training semantics
(SD/ldm/models/diffusion/ddpm.py: ``get_input`` encodes images with the VAE
and prompts with CLIP, ``q_sample``, ``apply_model``, ``p_losses``) and the
losses of the five train-scripts (nsfw_removal, ESD, random/certain label,
gradient ascent, proximal gradient) and of the Fisher pass. Loss functions
have the engine's signature ``loss_fn(model, batch, generator) -> scalar``
(``model`` the :class:`~uurg_torch.models.sd_unet.SDUNet` being trained).
Their timesteps (uniform over the 1,000 training steps) and noise come from
:meth:`SDWorkload.draw`, one call a loss term, which tests replace to
inject both. ESD's frozen base model is a second SDUNet held with
``requires_grad_(False)``. The VAE and the text encoder are frozen models
the workload holds (``vae``, ``text``), set after :meth:`SDWorkload.build`.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import torch

from uurg_torch.core.device import resolve_device
from uurg_torch.core.rng import randint_rows, randn_rows
from uurg_torch.diffusion import sampling as S
from uurg_torch.diffusion.schedules import DiffusionSchedule, make_schedule
from uurg_torch.models.autoencoder_kl import AutoencoderKL, VAEConfig
from uurg_torch.models.clip_text import (CLIPTextConfig, CLIPTextEncoder,
                                         tokenize)
from uurg_torch.models.sd_unet import SDUNet, SDUNetConfig, init_sd_unet

SAMPLERS = ("ddim", "plms", "lms")


@dataclasses.dataclass
class SDWorkload:
    """LatentDiffusion bundle: the UNet's configuration, the frozen VAE and
    text encoder, the schedule and the device."""

    unet_cfg: SDUNetConfig
    vae_cfg: VAEConfig
    text_cfg: CLIPTextConfig
    schedule: DiffusionSchedule
    device: torch.device
    vae: AutoencoderKL | None = None
    text: CLIPTextEncoder | None = None

    @classmethod
    def build(cls, unet_cfg: SDUNetConfig | None = None,
              vae_cfg: VAEConfig | None = None,
              text_cfg: CLIPTextConfig | None = None,
              device: str | torch.device | None = None) -> "SDWorkload":
        """LDM v1's schedule (``quad`` betas 0.00085 to 0.012, T = 1000).
        ``device`` defaults to CUDA and raises without it."""
        dev = resolve_device(device)
        return cls(unet_cfg=unet_cfg or SDUNetConfig(),
                   vae_cfg=vae_cfg or VAEConfig(),
                   text_cfg=text_cfg or CLIPTextConfig(),
                   schedule=make_schedule("quad", 0.00085, 0.012, 1000,
                                          device=dev),
                   device=dev)

    def init_unet(self, seed: int) -> SDUNet:
        """A seeded fresh UNet on this workload's device."""
        return init_sd_unet(seed, self.unet_cfg, self.device)

    # -- LatentDiffusion semantics ----------------------------------------

    @torch.no_grad()
    def get_learned_conditioning(self, prompts: Sequence[str]) -> torch.Tensor:
        """Prompt strings -> CLIP hidden states (B, max_length, hidden)
        (ddpm.py ``get_learned_conditioning``)."""
        ids = torch.as_tensor(tokenize(prompts, self.text_cfg.max_length),
                              device=self.device)
        return self.text(ids)

    @torch.no_grad()
    def get_input(self, images: torch.Tensor, prompts: Sequence[str],
                  generator: torch.Generator | None = None,
                  noise: torch.Tensor | None = None) -> tuple:
        """(z, context): [-1, 1] NHWC images encoded to scaled latents (a
        posterior draw from ``generator`` or ``noise``, the mean when
        neither is given) and the prompts embedded (ddpm.py:913-974)."""
        z = self.vae.encode(images, generator=generator, noise=noise)
        return z, self.get_learned_conditioning(prompts)

    def apply_model(self, model: SDUNet, z_noisy, t, context) -> torch.Tensor:
        return model(z_noisy, t, context)

    def draw(self, z: torch.Tensor, generator: torch.Generator):
        """(t, noise) of one loss term: t uniform over the training steps,
        noise standard normal of z's shape, both from ``generator``."""
        t = randint_rows(self.schedule.num_timesteps, z.shape[0], generator,
                         z.device)
        noise = randn_rows(z.shape, generator, z.device, z.dtype)
        return t, noise

    def p_losses(self, model: SDUNet, z, context, t, noise) -> torch.Tensor:
        """eps-MSE, mean (ddpm.py:1286-1320, eps parameterization)."""
        z_noisy = self.schedule.q_sample(z, t, noise)
        eps_hat = self.apply_model(model, z_noisy, t, context)
        return torch.mean(torch.square(noise - eps_hat))

    def shared_step_loss(self, model: SDUNet, batch,
                         generator) -> torch.Tensor:
        """``batch = (z, context)``: the eps loss at drawn t and noise."""
        z, context = batch
        return self.p_losses(model, z, context, *self.draw(z, generator))

    # -- method losses (on pre-encoded batches) ----------------------------

    def nsfw_forget_loss_fn(self) -> Callable:
        """``batch = (z, ctx_forget, ctx_pseudo)``: MSE(eps(z_t, forget
        context), eps(z_t, pseudo context) detached)
        (nsfw_removal.py:144-153)."""

        def fn(model, batch, generator):
            z, ctx_forget, ctx_pseudo = batch
            t, noise = self.draw(z, generator)
            z_t = self.schedule.q_sample(z, t, noise)
            out = self.apply_model(model, z_t, t, ctx_forget)
            with torch.no_grad():
                target = self.apply_model(model, z_t, t, ctx_pseudo)
            return torch.mean(torch.square(out - target))

        return fn

    def esd_loss_fn(self, frozen: SDUNet,
                    negative_guidance: float = 1.0) -> Callable:
        """ESD (train-esd.py:291-329): ``batch = (z_t, t, ctx_concept,
        ctx_empty)``, eps of ``model`` at the concept pushed toward
        e_0 - eta (e_p - e_0), both from the frozen base model ``frozen``
        (its own SDUNet, ``requires_grad_(False)``)."""

        def fn(model, batch, generator):
            z_t, t, ctx_c, ctx_0 = batch
            with torch.no_grad():
                e0 = self.apply_model(frozen, z_t, t, ctx_0)
                ep = self.apply_model(frozen, z_t, t, ctx_c)
            target = e0 - negative_guidance * (ep - e0)
            out = self.apply_model(model, z_t, t, ctx_c)
            return torch.mean(torch.square(out - target))

        return fn

    def ga_loss_fn(self, remain_alpha: float = 1.0) -> Callable:
        """``batch = (forget_batch, remain_batch)``: -shared_step(forget) +
        alpha shared_step(remain) (gradient_ascent.py:14-123)."""

        def fn(model, batch, generator):
            fb, rb = batch
            return (-self.shared_step_loss(model, fb, generator)
                    + remain_alpha * self.shared_step_loss(model, rb,
                                                           generator))

        return fn

    def rl_forget_loss_fn(self) -> Callable:
        """certain_label (random_label.py:13-155): the forget prompt's eps
        toward the pseudo prompt's, the nsfw forget loss."""
        return self.nsfw_forget_loss_fn()

    def fisher_loss_fn(self, guidance: float = 3.0) -> Callable:
        """``batch = (z, ctx, ctx_empty)``: -MSE(noise, eps) of the
        CFG-composed eps (1 + g) e_c - g e_0, two forwards, whose squared
        gradient is the Fisher (generate_fisher.py:8-129)."""

        def fn(model, batch, generator):
            z, ctx, ctx0 = batch
            t, noise = self.draw(z, generator)
            z_t = self.schedule.q_sample(z, t, noise)
            e_c = self.apply_model(model, z_t, t, ctx)
            e_0 = self.apply_model(model, z_t, t, ctx0)
            eps = (1 + guidance) * e_c - guidance * e_0
            return -torch.mean(torch.square(noise - eps))

        return fn

    # -- sampling ----------------------------------------------------------

    def _cfg(self, model: SDUNet, context, ctx_uncond, scale: float):
        """eps_0 + scale (eps_c - eps_0) as one batched double forward."""
        n = context.shape[0]
        c2 = torch.cat([context, ctx_uncond])

        def model_fn(x, t):
            out = self.apply_model(model, torch.cat([x, x]),
                                   torch.cat([t, t]), c2)
            cond, uncond = out[:n], out[n:]
            return uncond + scale * (cond - uncond)

        return model_fn

    def make_sampler(self, *, num_steps: int = 50, guidance_scale: float = 7.5,
                     latent_size: int = 64, eta: float = 0.0,
                     method: str = "ddim") -> Callable:
        """``sample(model, context, generator=None, x_T=None,
        step_noise=None)``: text-conditional CFG sampling to latents (decode
        with the VAE). ``ddim`` (SD/ldm/models/diffusion/ddim.py, LDM's +1
        timestep offset), ``plms`` (plms.py; ``eta`` ignored) or ``lms`` (the
        diffusers LMS pipeline of the reference's generation evaluator,
        SD/eval-scripts/generate-images.py:86-91,150-180, on its own float
        timestep grid). x_T is drawn from ``generator`` unless given; the
        empty prompt's context is computed once, here."""
        if method not in SAMPLERS:
            raise ValueError(f"method {method!r} is not one of {SAMPLERS}")
        # offset=1: LDM's make_ddim_timesteps samples at 1, 1 + skip, ...
        seq = S.make_step_sequence(self.schedule.num_timesteps, num_steps,
                                   offset=1)
        uncond_1 = self.get_learned_conditioning([""])

        @torch.inference_mode()
        def sample(model: SDUNet, context: torch.Tensor,
                   generator: torch.Generator | None = None,
                   x_T: torch.Tensor | None = None,
                   step_noise: torch.Tensor | None = None) -> torch.Tensor:
            n = context.shape[0]
            ctx_uncond = uncond_1.expand(context.shape)
            model_fn = self._cfg(model, context, ctx_uncond, guidance_scale)
            if x_T is None:
                x_T = torch.randn((n, latent_size, latent_size,
                                   self.unet_cfg.in_channels),
                                  generator=generator, device=context.device)
            if method == "plms":
                return S.plms_sample(model_fn, self.schedule, x_T, seq)
            if method == "lms":
                return S.lms_sample(model_fn, self.schedule, x_T, num_steps)
            return S.ddim_sample(model_fn, self.schedule, x_T, seq, eta=eta,
                                 generator=generator, noise=step_noise)

        return sample

    def make_quick_sampler(self, *, ddim_steps: int = 50,
                           start_guidance: float = 3.0) -> Callable:
        """``sample(model, ctx, ctx_uncond, x_T, till)``: CFG DDIM partial
        denoise with the current model, stopping at DDIM index ``till``
        (``quick_sample_till_t``, train-esd.py:40-77,240-253); ``ctx`` and
        ``ctx_uncond`` batch-shaped."""
        seq = S.make_step_sequence(self.schedule.num_timesteps, ddim_steps,
                                   offset=1)

        @torch.no_grad()
        def sample(model: SDUNet, ctx, ctx_uncond, x_T, till: int):
            model_fn = self._cfg(model, ctx, ctx_uncond, start_guidance)
            return S.ddim_sample_till(model_fn, self.schedule, x_T, seq, till)

        return sample

    # -- proximal gradient -------------------------------------------------

    def make_prox_operator(self, init: SDUNet, top_ratio: float = 0.01
                           ) -> Callable:
        """``prox(model) -> threshold``: every parameter of ``model`` moved
        to init + shrink(delta) in place, shrink the soft threshold at the
        k-th largest |delta| over all parameters (k = max(1, int(n
        top_ratio)), the value ``sort(|delta|)[-k]`` picks;
        proximal_gradient.py:140-183). ``init``'s parameters are the
        anchor."""
        anchors = [p.detach().clone() for p in init.parameters()]

        @torch.no_grad()
        def prox(model: SDUNet) -> torch.Tensor:
            params = list(model.parameters())
            deltas = [p - a for p, a in zip(params, anchors)]
            flat = torch.cat([d.abs().reshape(-1) for d in deltas])
            k = max(1, int(flat.numel() * top_ratio))
            thresh = torch.kthvalue(flat, flat.numel() - k + 1).values
            del flat
            for p, a, d in zip(params, anchors, deltas):
                p.copy_(a + torch.sign(d) * torch.clamp(d.abs() - thresh,
                                                        min=0.0))
            return thresh

        return prox
