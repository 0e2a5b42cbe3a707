"""DDPM workload: the conditional CIFAR-10 UNet with its schedule.

Port of ``uurg_tpu/workloads/ddpm.py``: config, init, the training,
forgetting, Fisher and Selective Amnesia (SA) losses, and the sampler. Loss
functions have the signature ``loss_fn(model, batch, generator) -> scalar``
with ``batch = (x, c)``: x float32 NHWC in model range, c int64 labels, both
on the workload's device. Every random draw (timesteps, noise, label
dropout, dropout masks) comes from ``generator``, except the per-sample
Fisher integrand's, ``fn(model, example, generator)`` for ONE example ``(x,
c, ts)``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Mapping

import torch

from uurg_torch.core.device import resolve_device
from uurg_torch.core.rng import (antithetic_timesteps, cond_keep_mask,
                                 rand_rows, randn_rows)
from uurg_torch.diffusion import sampling as S
from uurg_torch.diffusion.losses import adaptive_loss, noise_estimation_loss
from uurg_torch.diffusion.schedules import DiffusionSchedule, make_schedule
from uurg_torch.models.unet_cond import CondUNet, UNetConfig, init_unet


@dataclasses.dataclass
class DDPMWorkload:
    """Model config, schedule, loss settings and device for one reference
    config."""

    unet_cfg: UNetConfig
    schedule: DiffusionSchedule
    device: torch.device
    lambd: float = 0.5
    cond_drop_prob: float = 0.1

    @classmethod
    def from_config(cls, cfg, dtype: torch.dtype = torch.bfloat16,
                    device: str | torch.device | None = None) -> "DDPMWorkload":
        """``device`` defaults to CUDA and raises without it."""
        dev = resolve_device(device)
        schedule = make_schedule(
            cfg.diffusion.beta_schedule,
            cfg.diffusion.beta_start,
            cfg.diffusion.beta_end,
            cfg.diffusion.num_diffusion_timesteps,
            var_type=cfg.model.get("var_type", "fixedlarge"),
            device=dev,
        )
        return cls(
            unet_cfg=UNetConfig.from_config(cfg, dtype=dtype),
            schedule=schedule,
            device=dev,
            lambd=cfg.training.get("lambd", 0.5),
            cond_drop_prob=cfg.model.get("cond_drop_prob", 0.1),
        )

    def init_params(self, seed: int) -> CondUNet:
        """A seeded fresh model on this workload's device."""
        return init_unet(seed, self.unet_cfg, self.device)

    # -- loss builders -----------------------------------------------------

    def per_sample_eps_loss(self, model: CondUNet, x: torch.Tensor,
                            c: torch.Tensor, t: torch.Tensor,
                            noise: torch.Tensor, keep: torch.Tensor,
                            generator: torch.Generator | None = None
                            ) -> torch.Tensor:
        """Per-sample conditional eps loss at GIVEN timesteps, noise and
        label-keep mask (DDPM/functions/losses.py:22-38). ``generator``
        feeds dropout when the model is in training mode."""

        def apply_fn(x_t, t_vec):
            return model(x_t, t_vec, c, keep, generator)

        return noise_estimation_loss(apply_fn, self.schedule, x, t, noise,
                                     keepdim=True)

    def _per_sample_eps_loss(self, model, batch, generator, *, train: bool):
        """The same loss with antithetic t, noise and the label-keep mask
        drawn from ``generator`` (DDPM/runners/diffusion.py:1091-1094)."""
        x, c = batch
        n = x.shape[0]
        t = antithetic_timesteps(generator, n, self.schedule.num_timesteps)
        noise = randn_rows(x.shape, generator, x.device)
        keep = cond_keep_mask(generator, n,
                              self.cond_drop_prob if train else 0.0)
        return self.per_sample_eps_loss(model, x, c, t, noise, keep,
                                        generator)

    def train_loss_fn(self) -> Callable:
        """Mean eps-loss: the pretrain/retrain/remain objective."""

        def fn(model, batch, generator):
            return self._per_sample_eps_loss(model, batch, generator,
                                             train=True).mean()

        return fn

    def adaga_forget_loss_fn(self) -> Callable:
        """Negated adaptive gradient-ascent loss (``unlearn_loss=adaga``,
        DDPM/runners/diffusion.py:1115-1119)."""

        def fn(model, batch, generator):
            per = self._per_sample_eps_loss(model, batch, generator,
                                            train=True)
            return -adaptive_loss(per, self.lambd, eps=1e-8)

        return fn

    def ga_forget_loss_fn(self) -> Callable:
        """Plain negated eps-loss (``unlearn_loss=ga``)."""

        def fn(model, batch, generator):
            return -self._per_sample_eps_loss(model, batch, generator,
                                              train=True).mean()

        return fn

    def rl_forget_loss_fn(self, label_to_forget: int,
                          n_classes: int = 10) -> Callable:
        """Random/pseudo-label forgetting (``unlearn_loss=rl``,
        DDPM/runners/diffusion.py:1101-1113): match the forget-class output
        to the detached prediction under a pseudo class. Both forwards see
        the same dropout masks, as the JAX version passes both one key."""
        pseudo_label = (label_to_forget + 1) % n_classes

        def fn(model, batch, generator):
            x, c = batch
            n = x.shape[0]
            t = antithetic_timesteps(generator, n,
                                     self.schedule.num_timesteps)
            noise = randn_rows(x.shape, generator, x.device)
            x_t = self.schedule.q_sample(x, t, noise)
            keep = torch.ones((n,), dtype=torch.bool, device=x.device)
            state = generator.get_state()
            out = model(x_t, t, c, keep, generator)
            generator.set_state(state)
            with torch.no_grad():
                pseudo = model(x_t, t, torch.full_like(c, pseudo_label), keep,
                               generator)
            return torch.mean(torch.square(pseudo - out))

        return fn

    def forget_loss_fn(self, unlearn_loss: str, label_to_forget: int = 0,
                       n_classes: int = 10) -> Callable:
        if unlearn_loss == "adaga":
            return self.adaga_forget_loss_fn()
        if unlearn_loss == "ga":
            return self.ga_forget_loss_fn()
        if unlearn_loss == "rl":
            return self.rl_forget_loss_fn(label_to_forget, n_classes)
        raise NotImplementedError(unlearn_loss)

    # -- SA (Selective Amnesia, EWC) ---------------------------------------

    def sa_loss(self, model: CondUNet, batch, x_forget: torch.Tensor,
                t: torch.Tensor, noise_f: torch.Tensor, noise_r: torch.Tensor,
                fisher: Mapping[str, torch.Tensor],
                params_mle: Mapping[str, torch.Tensor], label_to_forget: int,
                gamma: float, lmbda: float) -> torch.Tensor:
        """The SA forgetting loss at GIVEN draws (DDPM/runners/diffusion.py:
        354-477 sa_forget): the mean eps-loss of ``x_forget`` under the
        forgotten label, plus ``gamma`` times the mean eps-loss of the
        remember batch under its own labels, plus ``lmbda`` times the EWC
        pull ``sum F (p - p_mle)^2`` (:func:`ewc_penalty`). Both forwards
        share ``t`` and keep every label. The model runs as it is set;
        ``sa_forget`` sets it to eval mode, as the JAX loss's
        ``train=False``."""
        x_rem, c_rem = batch
        keep = torch.ones((x_rem.shape[0],), dtype=torch.bool,
                          device=x_rem.device)

        def apply_for(c):
            return lambda x_t, t_vec: model(x_t, t_vec, c, keep)

        c_forget = torch.full_like(c_rem, label_to_forget)
        loss = noise_estimation_loss(apply_for(c_forget), self.schedule,
                                     x_forget, t, noise_f)
        loss = loss + gamma * noise_estimation_loss(
            apply_for(c_rem), self.schedule, x_rem, t, noise_r)
        return loss + lmbda * ewc_penalty(model, fisher, params_mle)

    def sa_loss_fn(self, label_to_forget: int, gamma: float, lmbda: float,
                   fisher: Mapping[str, torch.Tensor],
                   params_mle: Mapping[str, torch.Tensor]) -> Callable:
        """``sa_loss`` with, drawn from the generator in this order,
        uniform-noise forget images in [-1, 1) of the remember batch's
        shape, antithetic t, then the forget and the remember noise."""

        def fn(model, batch, generator):
            x_rem = batch[0]
            x_forget = rand_rows(x_rem.shape, generator,
                                 x_rem.device) * 2.0 - 1.0
            t = antithetic_timesteps(generator, x_rem.shape[0],
                                     self.schedule.num_timesteps)
            noise_f = randn_rows(x_rem.shape, generator, x_rem.device)
            noise_r = randn_rows(x_rem.shape, generator, x_rem.device)
            return self.sa_loss(model, batch, x_forget, t, noise_f, noise_r,
                                fisher, params_mle, label_to_forget, gamma,
                                lmbda)

        return fn

    def elbo_chunk_loss(self, model: CondUNet, x: torch.Tensor, c,
                        ts: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        """Mean eps-loss of ONE example ``x`` (H, W, C) with label ``c`` over
        the timesteps ``ts`` (chunk,), at GIVEN noise (chunk, H, W, C): the
        per-sample full-ELBO Fisher integrand (DDPM/fim.py,
        runners/diffusion.py:262-352 save_fim, chunked over t). Every label
        is kept. The model runs as it is set; the Fisher CLI sets it to
        eval mode."""
        n = ts.shape[0]
        x_b = x.expand(n, *x.shape)
        c_b = torch.as_tensor(c, dtype=torch.long, device=x.device).expand(n)
        keep = torch.ones((n,), dtype=torch.bool, device=x.device)
        return noise_estimation_loss(
            lambda x_t, t_vec: model(x_t, t_vec, c_b, keep), self.schedule,
            x_b, ts, noise)

    def elbo_chunk_loss_fn(self) -> Callable:
        """``elbo_chunk_loss`` with ``noise`` drawn from the generator; the
        example is ``(x, c, ts)``. For
        :func:`uurg_torch.unlearn.fisher.make_per_sample_fisher_step`."""

        def fn(model, example, generator):
            x, c, ts = example
            noise = torch.randn((ts.shape[0],) + tuple(x.shape),
                                generator=generator, device=x.device)
            return self.elbo_chunk_loss(model, x, c, ts, noise)

        return fn

    # -- fisher ------------------------------------------------------------

    def fisher_loss(self, model: CondUNet, x: torch.Tensor, c: torch.Tensor,
                    t: torch.Tensor, noise: torch.Tensor,
                    cond_scale: float = 2.0) -> torch.Tensor:
        """The loss whose squared gradients form the Fisher diagonal, at
        GIVEN timesteps and noise: the CFG double forward at ``cond_scale``
        and a sum-reduced eps-MSE, averaged over the batch
        (DDPM/runners/diffusion.py:1255-1281). The model runs as it is set;
        the Fisher pass sets it to eval mode (no dropout), as the
        reference's test-mode forward."""
        model_fn = S.cfg_model_fn(model, c, cond_scale)
        eps_hat = model_fn(self.schedule.q_sample(x, t, noise), t)
        return torch.sum(torch.square(noise - eps_hat), dim=(1, 2, 3)).mean()

    def fisher_loss_fn(self, cond_scale: float = 2.0) -> Callable:
        """``fisher_loss`` with antithetic t and noise drawn from the
        generator."""

        def fn(model, batch, generator):
            x, c = batch
            t = antithetic_timesteps(generator, x.shape[0],
                                     self.schedule.num_timesteps)
            noise = randn_rows(x.shape, generator, x.device)
            return self.fisher_loss(model, x, c, t, noise, cond_scale)

        return fn

    # -- sampling ----------------------------------------------------------

    def make_sampler(self, *, num_steps: int = 50, cond_scale: float = 2.0,
                     method: str = "ddim", eta: float = 0.0) -> Callable:
        """``sample(model, labels, generator, x_T=None) -> x in [-1, 1]``
        (NHWC float32). ``x_T`` is drawn from ``generator`` unless given.

        Reference: DDPM/runners/diffusion.py:825-872 sample_image (respaced
        DDIM "generalized" or ancestral) with the CFG double-forward.
        """
        if method not in ("ddim", "ddpm"):
            raise NotImplementedError(method)
        seq = S.make_step_sequence(self.schedule.num_timesteps, num_steps)
        res, ch = self.unet_cfg.resolution, self.unet_cfg.in_channels

        @torch.inference_mode()
        def sample(model: CondUNet, labels: torch.Tensor,
                   generator: torch.Generator,
                   x_T: torch.Tensor | None = None) -> torch.Tensor:
            if x_T is None:
                x_T = randn_rows((labels.shape[0], res, res, ch), generator,
                                 self.device)
            model_fn = S.cfg_model_fn(model, labels, cond_scale)
            if method == "ddim":
                return S.ddim_sample(model_fn, self.schedule, x_T, seq,
                                     eta=eta, generator=generator)
            return S.ddpm_sample(model_fn, self.schedule, x_T, seq,
                                 generator=generator)

        return sample


class _EWCPull(torch.autograd.Function):
    """``sum F (p - p_mle)^2`` over every parameter, with its exact gradient
    ``2 F (p - p_mle)``, each a few multi-tensor (``_foreach``) launches for
    all parameters at once. Leaf by leaf with autograd the SA step made
    2,624 more launches (about eight a leaf) and took a third longer on
    the host clock (``scripts/profile_torch_sa.py``, part 3, on an H100)."""

    @staticmethod
    def forward(ctx, fisher, mle, *params):
        ctx.fisher, ctx.mle = fisher, mle
        ctx.save_for_backward(*params)
        diff = torch._foreach_sub(params, mle)
        terms = torch._foreach_mul(diff, diff)
        torch._foreach_mul_(terms, fisher)
        # every term is >= 0 (F is a sum of squares), so the L1 norm of a
        # leaf is its sum
        return torch.stack(torch._foreach_norm(terms, 1)).sum()

    @staticmethod
    def backward(ctx, grad_out):
        grads = torch._foreach_sub(ctx.saved_tensors, ctx.mle)
        torch._foreach_mul_(grads, ctx.fisher)
        torch._foreach_mul_(grads, 2.0 * grad_out)
        return (None, None, *grads)


def ewc_penalty(model: torch.nn.Module, fisher: Mapping[str, torch.Tensor],
                params_mle: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """The EWC pull ``sum F (p - p_mle)^2`` of ``model``'s parameters toward
    ``params_mle``, weighted by the Fisher diagonal ``fisher`` (both keyed
    by parameter name, on the parameters' device, non-negative F),
    differentiable in the parameters."""
    names, params = zip(*model.named_parameters())
    return _EWCPull.apply([fisher[k] for k in names],
                          [params_mle[k] for k in names], *params)
