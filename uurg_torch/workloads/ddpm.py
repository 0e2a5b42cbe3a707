"""DDPM workload: the conditional CIFAR-10 UNet with its schedule.

Port of ``uurg_tpu/workloads/ddpm.py`` (serving part: config, init and the
sampler). The loss functions arrive with the training slice.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from uurg_torch.core.device import resolve_device
from uurg_torch.diffusion import sampling as S
from uurg_torch.diffusion.schedules import DiffusionSchedule, make_schedule
from uurg_torch.models.unet_cond import CondUNet, UNetConfig, init_unet


@dataclasses.dataclass
class DDPMWorkload:
    """Model config, schedule and device for one reference config."""

    unet_cfg: UNetConfig
    schedule: DiffusionSchedule
    device: torch.device

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
        )

    def init_params(self, seed: int) -> CondUNet:
        """A seeded fresh model on this workload's device."""
        return init_unet(seed, self.unet_cfg, self.device)

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
                x_T = torch.randn((labels.shape[0], res, res, ch),
                                  generator=generator, device=self.device)
            model_fn = S.cfg_model_fn(model, labels, cond_scale)
            if method == "ddim":
                return S.ddim_sample(model_fn, self.schedule, x_T, seq,
                                     eta=eta, generator=generator)
            return S.ddpm_sample(model_fn, self.schedule, x_T, seq,
                                 generator=generator)

        return sample
