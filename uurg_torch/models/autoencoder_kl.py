"""AutoencoderKL, the frozen first stage of SD and of DiT (the CompVis
encoder and decoder, ``ldm/modules/diffusionmodules/model.py``, and
``ldm/models/autoencoder.py``; diffusers ``stabilityai/sd-vae-ft-ema`` in
DiT/forget.py:195).

Port of ``uurg_tpu/models/autoencoder_kl.py``, float32 throughout. The
modules carry the CompVis names (``encoder.down.{i}.block.{j}``,
``encoder.mid.attn_1``, ``decoder.up.{i}.upsample.conv``, ``quant_conv``,
...), so a CompVis ``first_stage_model`` state dict loads as it is
(:mod:`uurg_torch.io.vae_interop`). The encoder emits 8-channel moments
(mean, then log-variance) of a diagonal Gaussian; latents are scaled by
0.18215. Images go in and latents come out NHWC, as in the JAX package;
inside, activations are NCHW tensors in channels-last memory, as in the
UNet (:mod:`uurg_torch.models.layers`). Every GroupNorm runs through the
GroupNorm kernel dispatcher and the two mid-block attentions (one head of
width 512 at the full configuration) through the attention dispatcher: on
the card, the float32 forward kernels.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn

from uurg_torch.models.init import init_classifier
from uurg_torch.models.layers import (Conv2d, Downsample, GroupNorm32,
                                      SelfAttention2D, Upsample, swish)


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    latent_channels: int = 4
    base_channels: int = 128
    channel_mult: tuple = (1, 2, 4, 4)
    num_res_blocks: int = 2
    scale_factor: float = 0.18215


class VAEResBlock(nn.Module):
    """swish(norm1) -> conv1 -> swish(norm2) -> conv2, plus the input (through
    a 1x1 ``nin_shortcut`` where the channels change)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.norm1 = GroupNorm32(in_channels)
        self.conv1 = Conv2d(in_channels, out_channels, 3, padding=1)
        self.norm2 = GroupNorm32(out_channels)
        self.conv2 = Conv2d(out_channels, out_channels, 3, padding=1)
        if in_channels != out_channels:
            self.nin_shortcut = Conv2d(in_channels, out_channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(swish(self.norm1(x)))
        h = self.conv2(swish(self.norm2(h)))
        if hasattr(self, "nin_shortcut"):
            x = self.nin_shortcut(x)
        return x + h


class VAEMid(nn.Module):
    """The middle of either side: a block, the one-head attention, a
    block."""

    def __init__(self, channels: int):
        super().__init__()
        self.block_1 = VAEResBlock(channels, channels)
        self.attn_1 = SelfAttention2D(channels)
        self.block_2 = VAEResBlock(channels, channels)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        return self.block_2(self.attn_1(self.block_1(h)))


class Encoder(nn.Module):
    """Images (NCHW) -> 2 * latent_channels moments at 1 / 2^(levels - 1) of
    the resolution. The downsample pads bottom and right only, then a
    stride-2 convolution."""

    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.conv_in = Conv2d(cfg.in_channels, cfg.base_channels, 3,
                              padding=1)
        self.down = nn.ModuleList()
        ch = cfg.base_channels
        last = len(cfg.channel_mult) - 1
        for i, mult in enumerate(cfg.channel_mult):
            level = nn.Module()
            level.block = nn.ModuleList()
            for _ in range(cfg.num_res_blocks):
                level.block.append(VAEResBlock(ch, cfg.base_channels * mult))
                ch = cfg.base_channels * mult
            if i != last:
                level.downsample = Downsample(ch)
            self.down.append(level)
        self.mid = VAEMid(ch)
        self.norm_out = GroupNorm32(ch)
        self.conv_out = Conv2d(ch, 2 * cfg.latent_channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(x)
        for level in self.down:
            for block in level.block:
                h = block(h)
            if hasattr(level, "downsample"):
                h = level.downsample(h)
        h = self.mid(h)
        return self.conv_out(swish(self.norm_out(h)))


class Decoder(nn.Module):
    """Latents (NCHW) -> images: the levels in reverse, num_res_blocks + 1
    blocks each, a nearest-neighbour 2x repeat and a convolution between
    them."""

    def __init__(self, cfg: VAEConfig):
        super().__init__()
        ch = cfg.base_channels * cfg.channel_mult[-1]
        self.conv_in = Conv2d(cfg.latent_channels, ch, 3, padding=1)
        self.mid = VAEMid(ch)
        levels = {}
        for i in reversed(range(len(cfg.channel_mult))):
            level = nn.Module()
            level.block = nn.ModuleList()
            for _ in range(cfg.num_res_blocks + 1):
                out = cfg.base_channels * cfg.channel_mult[i]
                level.block.append(VAEResBlock(ch, out))
                ch = out
            if i != 0:
                level.upsample = Upsample(ch)
            levels[i] = level
        self.up = nn.ModuleList(levels[i] for i in range(len(levels)))
        self.norm_out = GroupNorm32(ch)
        self.conv_out = Conv2d(ch, cfg.in_channels, 3, padding=1)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = self.mid(self.conv_in(z))
        for level in reversed(self.up):
            for block in level.block:
                h = block(h)
            if hasattr(level, "upsample"):
                h = level.upsample(h)
        return self.conv_out(swish(self.norm_out(h)))


def _nchw(x: torch.Tensor) -> torch.Tensor:
    """An NHWC tensor as NCHW in channels-last memory (a view when it is
    contiguous)."""
    return x.float().contiguous().permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).contiguous()


class AutoencoderKL(nn.Module):
    """``encode_moments``, ``encode`` and ``decode`` on NHWC tensors; the
    1x1 ``quant_conv`` and ``post_quant_conv`` sit on either side of the
    latent."""

    def __init__(self, cfg: VAEConfig | None = None):
        super().__init__()
        self.cfg = cfg = cfg or VAEConfig()
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)
        self.quant_conv = Conv2d(2 * cfg.latent_channels,
                                 2 * cfg.latent_channels, 1)
        self.post_quant_conv = Conv2d(cfg.latent_channels,
                                      cfg.latent_channels, 1)

    def encode_moments(self, x: torch.Tensor) -> torch.Tensor:
        """Images (B, H, W, C) in [-1, 1] -> moments (B, H/f, W/f, 2 L):
        the posterior's mean, then its log-variance."""
        return _nhwc(self.quant_conv(self.encoder(_nchw(x))))

    def encode(self, x: torch.Tensor, generator: torch.Generator | None = None,
               noise: torch.Tensor | None = None) -> torch.Tensor:
        """Latents scaled for diffusion: a draw from the posterior
        (``mean + exp(logvar / 2) * noise``, the log-variance clipped to
        [-30, 20]) with ``noise`` given or drawn from ``generator``, or its
        mean when neither is given."""
        mean, logvar = self.encode_moments(x).chunk(2, dim=-1)
        if noise is None and generator is not None:
            noise = torch.randn(mean.shape, generator=generator,
                                device=mean.device, dtype=mean.dtype)
        z = mean
        if noise is not None:
            z = mean + torch.exp(0.5 * torch.clamp(logvar, -30.0, 20.0)) \
                * noise.to(mean)
        return z * self.cfg.scale_factor

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """Scaled latents (B, h, w, L) -> images (B, H, W, C), about [-1, 1]."""
        h = self.post_quant_conv(_nchw(z) / self.cfg.scale_factor)
        return _nhwc(self.decoder(h))

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        return self.decode(self.encode(x, generator))


def init_vae(seed: int, cfg: VAEConfig | None = None,
             device: str | torch.device = "cpu") -> AutoencoderKL:
    """An AutoencoderKL of ``cfg`` on ``device`` in eval mode with flax's
    initial weights in distribution (LeCun-normal kernels, zero biases, unit
    GroupNorm scales), drawn from a generator on that device seeded with
    ``seed``. No checkpoint is in the repository: a seeded init stands in
    for the CompVis weights until one is read with ``--vae_ckpt``."""
    with torch.device(device):
        model = AutoencoderKL(cfg)
    model = model.to(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    return init_classifier(gen, model).eval().requires_grad_(False)
