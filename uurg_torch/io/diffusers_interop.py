"""Diffusers-format export of the SD UNet.

Port of ``uurg_tpu/io/diffusers_interop.py``. The reference saves every
erasure checkpoint in both the CompVis and the Diffusers layout
(SD/train-scripts/nsfw_removal.py:217-244 through
``convertModels.savemodelDiffusers``); :func:`torch_unet_to_diffusers`
writes the ``UNet2DConditionModel`` state-dict keys, so an erased model
loads into a diffusers pipeline. The port's parameters are already in torch
layouts (OIHW convolutions, (out, in) linear weights), so the export
renames and copies.

Layout (diffusers' sd-v1 UNet):
- ``down_blocks.{i}.resnets.{j}`` / ``.attentions.{j}``,
  ``downsamplers.0.conv``;
- ``mid_block.resnets.{0,1}`` / ``mid_block.attentions.0``;
- ``up_blocks.{k}.resnets.{j}`` / ``.attentions.{j}``,
  ``upsamplers.0.conv``, where ``k`` counts from the deepest level
  (``k = n_levels - 1 - i``);
- ``time_embedding.linear_{1,2}``, ``conv_in``, ``conv_norm_out``,
  ``conv_out``.
"""
from __future__ import annotations

from typing import Iterator, Mapping

import numpy as np
import torch

from uurg_torch.models.sd_unet import SDUNet, SDUNetConfig

_RESNET = (("norm1", "norm1"), ("conv1", "conv1"),
           ("emb_proj", "time_emb_proj"), ("norm2", "norm2"),
           ("conv2", "conv2"), ("skip", "conv_shortcut"))


def _resnet_pairs(ours: str, dest: str) -> Iterator[tuple[str, str]]:
    for mine, theirs in _RESNET:
        for leaf in ("weight", "bias"):
            yield f"{dest}.{theirs}.{leaf}", f"{ours}.{mine}.{leaf}"


def _attn_pairs(ours: str, dest: str) -> Iterator[tuple[str, str]]:
    for n in ("norm", "proj_in", "proj_out"):
        for leaf in ("weight", "bias"):
            yield f"{dest}.{n}.{leaf}", f"{ours}.{n}.{leaf}"
    d, tb = f"{dest}.transformer_blocks.0", f"{ours}.tblock_0"
    for attn in ("attn1", "attn2"):
        for qkv in ("to_q", "to_k", "to_v"):
            yield f"{d}.{attn}.{qkv}.weight", f"{tb}.{attn}.{qkv}.weight"
        for leaf in ("weight", "bias"):
            yield (f"{d}.{attn}.to_out.0.{leaf}",
                   f"{tb}.{attn}.to_out.{leaf}")
    for norm in ("norm1", "norm2", "norm3"):
        for leaf in ("weight", "bias"):
            yield f"{d}.{norm}.{leaf}", f"{tb}.{norm}.{leaf}"
    for theirs, mine in (("ff.net.0.proj", "ff_geglu.proj"),
                         ("ff.net.2", "ff_out")):
        for leaf in ("weight", "bias"):
            yield f"{d}.{theirs}.{leaf}", f"{tb}.{mine}.{leaf}"


def diffusers_key_map(cfg: SDUNetConfig = SDUNetConfig()
                      ) -> Iterator[tuple[str, str]]:
    """(diffusers key, port name) pairs of the whole UNet, the
    ``conv_shortcut`` pairs included whether the block has one or not."""
    for i, n in ((1, 0), (2, 2)):
        for leaf in ("weight", "bias"):
            yield (f"time_embedding.linear_{i}.{leaf}",
                   f"time_embed_{n}.{leaf}")
    for leaf in ("weight", "bias"):
        yield f"conv_in.{leaf}", f"conv_in.{leaf}"
    n = len(cfg.channel_mult)
    ds = 1
    for i in range(n):
        for j in range(cfg.num_res_blocks):
            yield from _resnet_pairs(f"down_{i}_res_{j}",
                                     f"down_blocks.{i}.resnets.{j}")
            if ds in cfg.attention_ds:
                yield from _attn_pairs(f"down_{i}_attn_{j}",
                                       f"down_blocks.{i}.attentions.{j}")
        if i != n - 1:
            for leaf in ("weight", "bias"):
                yield (f"down_blocks.{i}.downsamplers.0.conv.{leaf}",
                       f"down_{i}_downsample.{leaf}")
            ds *= 2
    yield from _resnet_pairs("mid_res_1", "mid_block.resnets.0")
    yield from _attn_pairs("mid_attn", "mid_block.attentions.0")
    yield from _resnet_pairs("mid_res_2", "mid_block.resnets.1")
    for i in reversed(range(n)):
        k = n - 1 - i           # diffusers' up_blocks count from the deepest
        for j in range(cfg.num_res_blocks + 1):
            yield from _resnet_pairs(f"up_{i}_res_{j}",
                                     f"up_blocks.{k}.resnets.{j}")
            if ds in cfg.attention_ds:
                yield from _attn_pairs(f"up_{i}_attn_{j}",
                                       f"up_blocks.{k}.attentions.{j}")
        if i != 0:
            for leaf in ("weight", "bias"):
                yield (f"up_blocks.{k}.upsamplers.0.conv.{leaf}",
                       f"up_{i}_upsample.{leaf}")
            ds //= 2
    for theirs, mine in (("conv_norm_out", "norm_out"),
                         ("conv_out", "conv_out")):
        for leaf in ("weight", "bias"):
            yield f"{theirs}.{leaf}", f"{mine}.{leaf}"


def torch_unet_to_diffusers(params: SDUNet | Mapping[str, torch.Tensor],
                            cfg: SDUNetConfig = SDUNetConfig()
                            ) -> dict[str, np.ndarray]:
    """An SDUNet (or its named parameters) -> diffusers'
    ``UNet2DConditionModel`` state dict as float32 numpy arrays on the
    host."""
    sd = params.state_dict() if isinstance(params, SDUNet) else params
    return {key: sd[ours].detach().to("cpu", torch.float32).numpy()
            for key, ours in diffusers_key_map(cfg) if ours in sd}
