"""ViT classifiers.

Port of ``uurg_tpu/models/vit.py`` (parity target Classification/models/
vit.py:4-7, torchvision's ViT-B/16 with a re-initialised head): a patchify
convolution, a class token and a learned position embedding, pre-LN
encoder blocks (:class:`uurg_torch.models.dit.MHSA` through the attention
kernels, an exact-erf GELU MLP), a final LayerNorm and a float32 head on
the class token. Images come in NCHW like the port's ResNets.

Three details carried over on purpose: LayerNorm eps is Flax's 1e-6 (torch
defaults to 1e-5) and computes in float32; the GELU is the erf form; the
position embedding holds one token per patch of the resolution the model
is *initialised* at, plus the class token: ``init_classifier(resolution=32)``
gives 5 tokens at patch 16, a 224 px init 197. The constructor builds it for
``image_size`` and :meth:`ViT.resize_tokens` rebuilds it. Parameter names
are the JAX package's (``patch_embed``, ``cls_token``, ``pos_embed``,
``block_{i}.{ln1,attn.qkv,attn.proj,ln2,fc1,fc2}``, ``ln_final``, ``head``);
torchvision checkpoints load through :mod:`uurg_torch.io.tv_vit_swin_interop`.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn
import torch.nn.functional as F

from uurg_torch.models.dit import MHSA, Linear

LN_EPS = 1e-6           # flax nn.LayerNorm


def wide(x: torch.Tensor) -> torch.Tensor:
    """float32, or float64 for a model run in float64 (built with
    ``dtype=torch.float64`` and converted with ``.double()``, for precision
    references)."""
    return x if x.dtype == torch.float64 else x.float()


class LayerNorm(nn.LayerNorm):
    """Flax ``nn.LayerNorm(dtype=float32)``: eps 1e-6, statistics and output
    in float32 whatever the input's dtype."""

    def __init__(self, dim: int):
        super().__init__(dim, eps=LN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(wide(x), self.normalized_shape, self.weight,
                            self.bias, self.eps)


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    hidden_size: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    num_classes: int = 10
    dropout: float = 0.0
    dtype: torch.dtype = torch.float32


class ViTBlock(nn.Module):
    def __init__(self, hidden: int, num_heads: int, mlp_ratio: float,
                 dropout: float, dtype: torch.dtype):
        super().__init__()
        self.dropout = dropout
        self.ln1 = LayerNorm(hidden)
        self.attn = MHSA(hidden, num_heads, dtype)
        self.ln2 = LayerNorm(hidden)
        self.fc1 = Linear(hidden, int(hidden * mlp_ratio), dtype=dtype)
        self.fc2 = Linear(int(hidden * mlp_ratio), hidden, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln1(x))
        h = F.gelu(self.fc1(self.ln2(x)))          # exact erf form
        # torch's own dropout generator: the JAX package draws from its key
        h = F.dropout(h, self.dropout, self.training)
        return x + self.fc2(h)


class ViT(nn.Module):
    """NCHW images -> float32 logits."""

    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.cfg = cfg
        p, d = cfg.patch_size, cfg.hidden_size
        self.patch_embed = nn.Conv2d(3, d, p, stride=p)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d))
        self.pos_embed = nn.Parameter(torch.zeros(1, self.tokens(cfg.image_size), d))
        for i in range(cfg.depth):
            self.add_module(f"block_{i}", ViTBlock(
                d, cfg.num_heads, cfg.mlp_ratio, cfg.dropout, cfg.dtype))
        self.ln_final = LayerNorm(d)
        self.head = nn.Linear(d, cfg.num_classes)

    def tokens(self, resolution: int) -> int:
        """Patches of a ``resolution`` image plus the class token."""
        return (resolution // self.cfg.patch_size) ** 2 + 1

    def resize_tokens(self, resolution: int) -> None:
        """A fresh (zero) position embedding for ``resolution``, as the JAX
        model's shape follows the resolution it is initialised at."""
        n = self.tokens(resolution)
        if self.pos_embed.shape[1] != n:
            self.pos_embed = nn.Parameter(self.pos_embed.new_zeros(
                1, n, self.cfg.hidden_size))

    @torch.no_grad()
    def init_own_(self, generator: torch.Generator) -> None:
        """Flax's initialisers of the two bare parameters: zeros and
        N(0, 0.02)."""
        self.cls_token.zero_()
        self.pos_embed.normal_(0.0, 0.02, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        dt = cfg.dtype
        B = x.shape[0]
        h = F.conv2d(x.to(dt), self.patch_embed.weight.to(dt),
                     self.patch_embed.bias.to(dt), stride=cfg.patch_size)
        h = h.flatten(2).transpose(1, 2)             # (B, T, hidden), row-major
        h = torch.cat([self.cls_token.to(dt).expand(B, -1, -1), h], dim=1)
        h = h + self.pos_embed.to(dt)
        for i in range(cfg.depth):
            h = getattr(self, f"block_{i}")(h)
        h = self.ln_final(h)
        return self.head(wide(h[:, 0]))


def ViT_B(num_classes: int = 10, image_size: int = 224,
          dtype: torch.dtype = torch.float32) -> ViT:
    return ViT(ViTConfig(image_size=image_size, num_classes=num_classes,
                         dtype=dtype))
