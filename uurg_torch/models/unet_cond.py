"""Class-conditional DDPM UNet.

Port of ``uurg_tpu/models/unet_cond.py``. The public ``forward`` takes and
returns NHWC tensors like the JAX model; inside, activations are NCHW in
``torch.channels_last`` memory. Compute runs in ``UNetConfig.dtype``
(bfloat16 by default) with float32 parameters; GroupNorm statistics, the
attention softmax and ``conv_out`` are float32. ``model.train()`` turns on dropout, drawn from
the generator the call passes; gradients reach the float32 parameters
through the casts. Submodule names follow the
reference torch state dict, so a reference ``ckpt.pth`` loads with
``strict=True`` once the ``module.`` prefix is stripped.

``UNetConfig.remat`` (``model.remat`` in the YAML) recomputes each residual
block's forward in the backward instead of keeping its activations, as the
JAX model's ``nn.remat`` of ``ResnetBlockDDPM`` does (the attention blocks
and resamplers keep theirs): ``torch.utils.checkpoint`` without reentry,
with the dropout generator's state replayed for the recompute.
``resamp_with_conv=False`` resamples by a 2x2 average pool and a
nearest-neighbour x2 without convolutions.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from uurg_torch.models.layers import (
    Conv2d,
    Downsample,
    GroupNorm32,
    Linear,
    ResnetBlockDDPM,
    SelfAttention2D,
    Upsample,
    swish,
    timestep_embedding,
)


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 3
    out_channels: int = 3
    ch: int = 128
    ch_mult: tuple = (1, 2, 2, 2)
    num_res_blocks: int = 2
    attn_resolutions: tuple = (16,)
    dropout: float = 0.1
    resamp_with_conv: bool = True
    resolution: int = 32
    n_classes: int = 10
    cond_drop_prob: float = 0.1
    dtype: torch.dtype = torch.bfloat16
    # recompute the res blocks in the backward (activation memory for
    # conv work); forward-only use is unaffected
    remat: bool = False

    @classmethod
    def from_config(cls, cfg, dtype: torch.dtype = torch.bfloat16
                    ) -> "UNetConfig":
        """Build from a reference-schema YAML config (model/data sections);
        ``remat`` is ``model.remat`` (default off)."""
        return cls(
            remat=bool(cfg.model.get("remat", False)),
            in_channels=cfg.model.in_channels,
            out_channels=cfg.model.out_ch,
            ch=cfg.model.ch,
            ch_mult=tuple(cfg.model.ch_mult),
            num_res_blocks=cfg.model.num_res_blocks,
            attn_resolutions=tuple(cfg.model.attn_resolutions),
            dropout=cfg.model.dropout,
            resamp_with_conv=cfg.model.resamp_with_conv,
            resolution=cfg.data.image_size,
            n_classes=cfg.data.n_classes,
            cond_drop_prob=cfg.model.get("cond_drop_prob", 0.1),
            dtype=dtype,
        )


def _container(**modules) -> nn.Module:
    m = nn.Module()
    for name, mod in modules.items():
        setattr(m, name, mod)
    return m


class CondUNet(nn.Module):
    """eps-prediction UNet conditioned on timestep + class label.

    Call: ``model(x, t, c, cond_keep)`` with NHWC ``x``; ``cond_keep`` is a
    per-sample bool mask, False selecting the learned null class embedding
    (classifier-free guidance). In training mode (``model.train()``) the
    call also passes ``generator``, from which dropout draws its masks.
    """

    def __init__(self, cfg: UNetConfig):
        super().__init__()
        self.cfg = cfg
        ch = cfg.ch
        emb_ch = ch * 4
        num_res = len(cfg.ch_mult)

        self.temb = _container(dense=nn.ModuleList(
            [Linear(ch, emb_ch), Linear(emb_ch, emb_ch)]))
        self.classes_emb = nn.Embedding(cfg.n_classes, ch)
        self.null_classes_emb = nn.Parameter(torch.zeros(ch))
        self.cemb = _container(dense=nn.ModuleList(
            [Linear(ch, emb_ch), Linear(emb_ch, emb_ch)]))

        def block(cin, cout):
            return ResnetBlockDDPM(cin, cout, 2 * emb_ch, cfg.dropout)

        self.conv_in = Conv2d(cfg.in_channels, ch, 3, padding=1)
        hs_ch = [ch]
        cur, res = ch, cfg.resolution
        self.down = nn.ModuleList()
        for i_level, mult in enumerate(cfg.ch_mult):
            blocks, attns = nn.ModuleList(), nn.ModuleList()
            for _ in range(cfg.num_res_blocks):
                blocks.append(block(cur, ch * mult))
                cur = ch * mult
                if res in cfg.attn_resolutions:
                    attns.append(SelfAttention2D(cur))
                hs_ch.append(cur)
            level = _container(block=blocks, attn=attns)
            if i_level != num_res - 1:
                level.downsample = Downsample(cur, cfg.resamp_with_conv)
                hs_ch.append(cur)
                res //= 2
            self.down.append(level)

        self.mid = _container(block_1=block(cur, cur),
                              attn_1=SelfAttention2D(cur),
                              block_2=block(cur, cur))

        up = [None] * num_res
        for i_level in reversed(range(num_res)):
            blocks, attns = nn.ModuleList(), nn.ModuleList()
            for _ in range(cfg.num_res_blocks + 1):
                blocks.append(block(cur + hs_ch.pop(), ch * cfg.ch_mult[i_level]))
                cur = ch * cfg.ch_mult[i_level]
                if res in cfg.attn_resolutions:
                    attns.append(SelfAttention2D(cur))
            level = _container(block=blocks, attn=attns)
            if i_level != 0:
                level.upsample = Upsample(cur, cfg.resamp_with_conv)
                res *= 2
            up[i_level] = level
        self.up = nn.ModuleList(up)

        self.norm_out = GroupNorm32(cur)
        self.conv_out = Conv2d(cur, cfg.out_channels, 3, padding=1)
        self.to(memory_format=torch.channels_last)

    def forward(self, x: torch.Tensor, t: torch.Tensor, c: torch.Tensor,
                cond_keep: torch.Tensor | None = None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        cfg = self.cfg
        dtype = cfg.dtype
        x = x.permute(0, 3, 1, 2).to(dtype).contiguous(
            memory_format=torch.channels_last)

        temb = timestep_embedding(t, cfg.ch).to(dtype)
        temb = self.temb.dense[1](swish(self.temb.dense[0](temb)))
        cemb = self.classes_emb(c)
        if cond_keep is not None:
            cemb = torch.where(cond_keep[:, None], cemb,
                               self.null_classes_emb[None, :].to(cemb.dtype))
        cemb = self.cemb.dense[1](swish(self.cemb.dense[0](cemb.to(dtype))))
        emb = torch.cat([temb, cemb], dim=-1)

        run = self._remat if cfg.remat and torch.is_grad_enabled() else (
            lambda blk, *a: blk(*a))
        hs = [self.conv_in(x)]
        for level in self.down:
            for i_block, blk in enumerate(level.block):
                h = run(blk, hs[-1], emb, generator)
                if len(level.attn):
                    h = level.attn[i_block](h)
                hs.append(h)
            if hasattr(level, "downsample"):
                hs.append(level.downsample(hs[-1]))

        h = run(self.mid.block_1, hs[-1], emb, generator)
        h = self.mid.attn_1(h)
        h = run(self.mid.block_2, h, emb, generator)

        for level in reversed(self.up):
            for i_block, blk in enumerate(level.block):
                h = run(blk, torch.cat([h, hs.pop()], dim=1), emb, generator)
                if len(level.attn):
                    h = level.attn[i_block](h)
            if hasattr(level, "upsample"):
                h = level.upsample(h)

        h = swish(self.norm_out(h))
        h = self.conv_out(h.float())
        return h.permute(0, 2, 3, 1)

    @staticmethod
    def _remat(blk: ResnetBlockDDPM, x: torch.Tensor, emb: torch.Tensor,
               generator: torch.Generator | None) -> torch.Tensor:
        """``blk(x, emb, generator)`` whose activations are recomputed in
        the backward. ``preserve_rng_state`` would save only the default
        CPU and CUDA generators, but dropout draws from ``generator``: its
        state before the forward is kept here and set again for the
        recompute (and the state the forward left restored after it), so
        the recompute draws the forward's mask."""
        if generator is None:
            return checkpoint(blk, x, emb, None, use_reentrant=False,
                              preserve_rng_state=False)
        before = generator.get_state()
        ran = []

        def fn(x, emb):
            if not ran:                      # the forward
                ran.append(True)
                return blk(x, emb, generator)
            after = generator.get_state()    # the recompute
            generator.set_state(before)
            try:
                return blk(x, emb, generator)
            finally:
                generator.set_state(after)

        return checkpoint(fn, x, emb, use_reentrant=False,
                          preserve_rng_state=False)


def _lecun_normal_(w: torch.Tensor, generator: torch.Generator) -> None:
    """Flax's ``lecun_normal``: truncated normal at +-2 std, variance 1/fan_in
    after the truncation."""
    fan_in = w[0].numel()
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                          generator=generator)


@torch.no_grad()
def init_weights_(model: CondUNet, generator: torch.Generator) -> CondUNet:
    """Flax's default initialisation, drawn from ``generator``: lecun-normal
    kernels, zero biases, GroupNorm weight 1 and bias 0, class embedding
    N(0, 1/ch) (Flax ``Embed``'s variance scaling), null class N(0, 1)."""
    for m in model.modules():
        if isinstance(m, (Linear, Conv2d)):
            _lecun_normal_(m.weight, generator)
            m.bias.zero_()
        elif isinstance(m, GroupNorm32):
            m.weight.fill_(1.0)
            m.bias.zero_()
    emb = model.classes_emb.weight
    emb.normal_(0.0, emb.shape[1] ** -0.5, generator=generator)
    model.null_classes_emb.normal_(0.0, 1.0, generator=generator)
    return model


def init_unet(seed: int, cfg: UNetConfig,
              device: str | torch.device = "cpu") -> CondUNet:
    """A freshly initialised model: drawn on the CPU from ``seed`` (the same
    weights on every device), then moved to ``device``."""
    model = init_weights_(CondUNet(cfg), torch.Generator().manual_seed(seed))
    return model.to(device).eval()
