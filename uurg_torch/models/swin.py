"""Swin Transformer classifiers.

Port of ``uurg_tpu/models/swin.py`` (parity target Classification/models/
swin.py:4-19, torchvision's Swin-T/S/B re-headed): a 4x4 patch embedding,
window attention with a relative-position bias, shifted windows by
``torch.roll`` and an additive -100 mask, patch merging between stages, a
final LayerNorm, a spatial mean and a float32 head. Images come in NCHW;
inside, activations are NHWC as in the JAX model.

Window attention is plain matrix products, as the JAX package's einsums are
(no kernel on this path): float32 scores, the bias and the mask added, the
softmax cast to the compute dtype before the product with v. Patch merging
concatenates the 2x2 sub-grid in the JAX reshape order ((0,0), (0,1),
(1,0), (1,1)), not torchvision's; :mod:`uurg_torch.io.tv_vit_swin_interop`
permutes a torchvision checkpoint's merge weights accordingly. LayerNorm
eps is 1e-6 throughout. An image whose patch grid does not divide by the
window fails, as in the JAX package (Swin runs at 224 px, not 32).
Parameter names are the JAX package's (``patch_embed``, ``ln_embed``,
``stage{i}_block{j}.{ln1,attn.{qkv,proj,rel_pos_bias},ln2,fc1,fc2}``,
``merge{i}.{ln,reduction}``, ``ln_final``, ``head``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from uurg_torch.models.dit import Linear
from uurg_torch.models.vit import LayerNorm, wide


def window_partition(x: torch.Tensor, w: int) -> torch.Tensor:
    """(B, H, W, C) -> (B * H/w * W/w, w * w, C)."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // w, w, W // w, w, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, w * w, C)


def window_unpartition(xw: torch.Tensor, w: int, H: int, W: int
                       ) -> torch.Tensor:
    B = xw.shape[0] // (H // w * W // w)
    x = xw.reshape(B, H // w, W // w, w, w, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, H, W, -1)


def relative_position_index(w: int) -> np.ndarray:
    """(w*w, w*w) int32 index into the (2w-1)^2 bias table."""
    coords = np.stack(np.meshgrid(np.arange(w), np.arange(w),
                                  indexing="ij")).reshape(2, -1)
    rel = coords[:, :, None] - coords[:, None, :]
    rel = rel.transpose(1, 2, 0) + (w - 1)
    return (rel[..., 0] * (2 * w - 1) + rel[..., 1]).astype(np.int32)


def shift_attn_mask(H: int, W: int, w: int, shift: int) -> np.ndarray:
    """(windows, w*w, w*w) float32 additive mask: -100 between positions
    that the roll brought together from different regions, else 0."""
    img = np.zeros((1, H, W, 1))
    cnt = 0
    for hs in (slice(0, -w), slice(-w, -shift), slice(-shift, None)):
        for ws in (slice(0, -w), slice(-w, -shift), slice(-shift, None)):
            img[:, hs, ws, :] = cnt
            cnt += 1
    win = img.reshape(1, H // w, w, W // w, w, 1).transpose(0, 1, 3, 2, 4, 5)
    win = win.reshape(-1, w * w)
    mask = win[:, None, :] - win[:, :, None]
    return np.where(mask != 0, -100.0, 0.0).astype(np.float32)


class WindowAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, window: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads, self.window = num_heads, window
        self.compute_dtype = dtype
        self.qkv = Linear(dim, 3 * dim, dtype=dtype)
        self.proj = Linear(dim, dim, dtype=dtype)
        self.rel_pos_bias = nn.Parameter(
            torch.zeros((2 * window - 1) ** 2, num_heads))
        self.register_buffer(
            "rel_index", torch.from_numpy(
                relative_position_index(window).astype(np.int64)),
            persistent=False)

    @torch.no_grad()
    def init_own_(self, generator: torch.Generator) -> None:
        """Flax's N(0, 0.02) for the bias table."""
        self.rel_pos_bias.normal_(0.0, 0.02, generator=generator)

    def forward(self, xw: torch.Tensor, mask: torch.Tensor | None
                ) -> torch.Tensor:
        nW, T, C = xw.shape
        H = self.num_heads
        qkv = self.qkv(xw).reshape(nW, T, 3, H, C // H)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        attn = torch.matmul(wide(q), wide(k).transpose(-1, -2))
        attn = attn * (C // H) ** -0.5
        attn = attn + self.rel_pos_bias[self.rel_index].permute(2, 0, 1)[None]
        if mask is not None:
            nM = mask.shape[0]
            attn = attn.reshape(nW // nM, nM, H, T, T) + mask[None, :, None]
            attn = attn.reshape(nW, H, T, T)
        attn = torch.softmax(attn, dim=-1)
        out = torch.matmul(attn.to(self.compute_dtype), v)
        return self.proj(out.transpose(1, 2).reshape(nW, T, C))


class SwinBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, window: int, shift: int,
                 mlp_ratio: float = 4.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.window, self.shift = window, shift
        self._masks: dict = {}          # (H, W, device) -> the shift mask
        self.ln1 = LayerNorm(dim)
        self.attn = WindowAttention(dim, num_heads, window, dtype)
        self.ln2 = LayerNorm(dim)
        self.fc1 = Linear(dim, int(dim * mlp_ratio), dtype=dtype)
        self.fc2 = Linear(int(dim * mlp_ratio), dim, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, C = x.shape
        w = min(self.window, H)
        shift = self.shift if w < H else 0
        h = self.ln1(x)
        mask = None
        if shift:
            h = torch.roll(h, (-shift, -shift), dims=(1, 2))
            mask = self._masks.get((H, W, x.device))
            if mask is None:
                mask = self._masks[H, W, x.device] = torch.from_numpy(
                    shift_attn_mask(H, W, w, shift)).to(x.device)
        h = window_unpartition(self.attn(window_partition(h, w), mask),
                               w, H, W)
        if shift:
            h = torch.roll(h, (shift, shift), dims=(1, 2))
        x = x + h
        return x + self.fc2(F.gelu(self.fc1(self.ln2(x))))


class PatchMerging(nn.Module):
    def __init__(self, dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.ln = LayerNorm(4 * dim)
        self.reduction = Linear(4 * dim, 2 * dim, bias=False, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, C = x.shape
        x = x.reshape(B, H // 2, 2, W // 2, 2, C).permute(0, 1, 3, 2, 4, 5)
        return self.reduction(self.ln(x.reshape(B, H // 2, W // 2, 4 * C)))


@dataclasses.dataclass(frozen=True)
class SwinConfig:
    patch_size: int = 4
    embed_dim: int = 96
    depths: tuple = (2, 2, 6, 2)
    num_heads: tuple = (3, 6, 12, 24)
    window: int = 7
    num_classes: int = 10
    dtype: torch.dtype = torch.float32


class Swin(nn.Module):
    """NCHW images -> float32 logits."""

    def __init__(self, cfg: SwinConfig):
        super().__init__()
        self.cfg = cfg
        p = cfg.patch_size
        self.patch_embed = nn.Conv2d(3, cfg.embed_dim, p, stride=p)
        self.ln_embed = LayerNorm(cfg.embed_dim)
        dim = cfg.embed_dim
        for i, (depth, heads) in enumerate(zip(cfg.depths, cfg.num_heads)):
            for j in range(depth):
                shift = 0 if j % 2 == 0 else cfg.window // 2
                self.add_module(f"stage{i}_block{j}", SwinBlock(
                    dim, heads, cfg.window, shift, dtype=cfg.dtype))
            if i < len(cfg.depths) - 1:
                self.add_module(f"merge{i}", PatchMerging(dim, cfg.dtype))
                dim *= 2
        self.ln_final = LayerNorm(dim)
        self.head = nn.Linear(dim, cfg.num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        dt = cfg.dtype
        h = F.conv2d(x.to(dt), self.patch_embed.weight.to(dt),
                     self.patch_embed.bias.to(dt), stride=cfg.patch_size)
        h = self.ln_embed(h.permute(0, 2, 3, 1))     # NHWC from here on
        for i, depth in enumerate(cfg.depths):
            for j in range(depth):
                h = getattr(self, f"stage{i}_block{j}")(h)
            if i < len(cfg.depths) - 1:
                h = getattr(self, f"merge{i}")(h)
        h = self.ln_final(h).mean(dim=(1, 2))
        return self.head(wide(h))


def Swin_T(num_classes: int = 10, dtype: torch.dtype = torch.float32) -> Swin:
    return Swin(SwinConfig(num_classes=num_classes, dtype=dtype))


def Swin_S(num_classes: int = 10, dtype: torch.dtype = torch.float32) -> Swin:
    return Swin(SwinConfig(depths=(2, 2, 18, 2), num_classes=num_classes,
                           dtype=dtype))


def Swin_B(num_classes: int = 10, dtype: torch.dtype = torch.float32) -> Swin:
    return Swin(SwinConfig(embed_dim=128, depths=(2, 2, 18, 2),
                           num_heads=(4, 8, 16, 32), num_classes=num_classes,
                           dtype=dtype))
