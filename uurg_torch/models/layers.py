"""Shared building blocks of the DDPM UNet.

Port of ``uurg_tpu/models/layers.py``. Activations are NCHW tensors in
``torch.channels_last`` memory (NHWC bytes), so cuDNN convolutions and the
GroupNorm kernel both see channel-contiguous memory and the NHWC views the
kernels take cost nothing. Parameters are float32; each layer casts them to
the activation dtype at the call, as Flax's ``dtype=`` does. Module and
parameter names follow the reference torch state dict
(DDPM/models/diffusion.py).
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from uurg_torch.ops.flash_attention import attention
from uurg_torch.ops.group_norm import group_norm

_CL = torch.channels_last


def timestep_embedding(t: torch.Tensor, dim: int,
                       max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal timestep embedding, tensor2tensor convention ([sin | cos],
    odd dims zero-padded; the frequency divisor is ``half - 1``)."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period)
        * torch.arange(half, dtype=torch.float32, device=t.device) / (half - 1))
    args = t.float()[:, None] * freqs[None, :]
    emb = torch.cat([torch.sin(args), torch.cos(args)], dim=-1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


def swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


class Linear(nn.Linear):
    """Linear whose float32 parameters are cast to the input dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


class Conv2d(nn.Conv2d):
    """Conv2d whose float32 parameters are cast to the input dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, self.weight.to(x.dtype), self.bias.to(x.dtype),
                        self.stride, self.padding)


class GroupNorm32(nn.Module):
    """GroupNorm(32, eps=1e-6) with fp32 statistics, output in the input
    dtype, through the GroupNorm kernel dispatcher. The group count halves
    until it divides the channels (narrow test configs)."""

    def __init__(self, channels: int, num_groups: int = 32,
                 eps: float = 1e-6):
        super().__init__()
        while channels % num_groups != 0:
            num_groups //= 2
        self.num_groups = num_groups
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        nhwc = x.contiguous(memory_format=_CL).permute(0, 2, 3, 1)
        y = group_norm(nhwc, self.weight, self.bias, groups=self.num_groups,
                       eps=self.eps)
        return y.permute(0, 3, 1, 2)


class SelfAttention2D(nn.Module):
    """Single-head spatial self-attention over H*W positions: 1x1 q/k/v
    projections, 1/sqrt(C) scaling, residual (DDPM/models/diffusion.py)."""

    def __init__(self, channels: int):
        super().__init__()
        self.norm = GroupNorm32(channels)
        self.q = Conv2d(channels, channels, 1)
        self.k = Conv2d(channels, channels, 1)
        self.v = Conv2d(channels, channels, 1)
        self.proj_out = Conv2d(channels, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, H, W = x.shape
        h = self.norm(x)

        def heads(t):   # (B, C, H, W) channels-last -> (B, 1, T, C)
            return t.contiguous(memory_format=_CL).permute(0, 2, 3, 1) \
                .reshape(B, 1, H * W, C)

        out = attention(heads(self.q(h)), heads(self.k(h)), heads(self.v(h)))
        out = out.reshape(B, H, W, C).permute(0, 3, 1, 2)
        return x + self.proj_out(out)


def dropout(x: torch.Tensor, p: float,
            generator: torch.Generator) -> torch.Tensor:
    """Flax ``nn.Dropout``: keep each element with probability 1 - p and
    scale the kept ones by 1 / (1 - p). The keep mask is drawn in fp32 from
    ``generator`` (``F.dropout`` takes none), in x's memory order."""
    if x.is_contiguous(memory_format=_CL):
        u = torch.rand(x.permute(0, 2, 3, 1).shape, generator=generator,
                       device=x.device).permute(0, 3, 1, 2)
    else:
        u = torch.rand(x.shape, generator=generator, device=x.device)
    return x * ((u >= p).to(x.dtype) * (1.0 / (1.0 - p)))


class ResnetBlockDDPM(nn.Module):
    """DDPM residual block conditioned on [time-emb | class-emb] through one
    projection (``temb_cemb_proj``). Dropout sits after swish(norm2(h)) and
    before conv2; it is active only in training mode, where the call must
    pass the generator it draws from."""

    def __init__(self, in_channels: int, out_channels: int, emb_channels: int,
                 dropout: float = 0.0):
        super().__init__()
        self.drop_prob = dropout
        self.norm1 = GroupNorm32(in_channels)
        self.conv1 = Conv2d(in_channels, out_channels, 3, padding=1)
        self.temb_cemb_proj = Linear(emb_channels, out_channels)
        self.norm2 = GroupNorm32(out_channels)
        self.conv2 = Conv2d(out_channels, out_channels, 3, padding=1)
        if in_channels != out_channels:
            self.nin_shortcut = Conv2d(in_channels, out_channels, 1)

    def forward(self, x: torch.Tensor, emb: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        h = self.conv1(swish(self.norm1(x)))
        h = h + self.temb_cemb_proj(swish(emb))[:, :, None, None]
        h = swish(self.norm2(h))
        if self.training and self.drop_prob > 0.0:
            if generator is None:
                raise ValueError("training-mode dropout needs a generator")
            h = dropout(h, self.drop_prob, generator)
        h = self.conv2(h)
        if hasattr(self, "nin_shortcut"):
            x = self.nin_shortcut(x)
        return x + h


class Downsample(nn.Module):
    """Stride-2 3x3 conv after (0, 1) asymmetric padding, or without
    ``with_conv`` a 2x2 average pool (DDPM/models/diffusion.py:65-82)."""

    def __init__(self, channels: int, with_conv: bool = True):
        super().__init__()
        if with_conv:
            self.conv = Conv2d(channels, channels, 3, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if hasattr(self, "conv"):
            return self.conv(F.pad(x, (0, 1, 0, 1)))
        return F.avg_pool2d(x, 2, 2)


class Upsample(nn.Module):
    """Nearest-neighbour 2x upsample, then a 3x3 conv unless ``with_conv``
    is off (DDPM/models/diffusion.py:49-62)."""

    def __init__(self, channels: int, with_conv: bool = True):
        super().__init__()
        if with_conv:
            self.conv = Conv2d(channels, channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.interpolate(x, scale_factor=2, mode="nearest")
        return self.conv(x) if hasattr(self, "conv") else x
