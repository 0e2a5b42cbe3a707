"""CompVis Stable Diffusion UNet checkpoints.

Port of ``uurg_tpu/io/sd_interop.py``: the CompVis/LDM ``UNetModel`` state
dict (the ``model.diffusion_model.*`` subtree of ``sd-v1-*.ckpt``,
SD/ldm/modules/diffusionmodules/openaimodel.py:428-1064) to the port's
:class:`~uurg_torch.models.sd_unet.SDUNet` state dict and back. Both sides
are torch layouts (OIHW convolutions, (out, in) linear weights, the 1x1
``proj_in``/``proj_out`` convolutions of SD v1), so the map renames and
copies: no tensor is transposed.
"""
from __future__ import annotations

import logging
from typing import Iterator, Mapping

import torch

from uurg_torch.models.sd_unet import SDUNet, SDUNetConfig

log = logging.getLogger("uurg.io")

PREFIX = "model.diffusion_model."


def _resblock_pairs(ours: str) -> list[tuple[str, str]]:
    """CompVis ResBlock inner name -> the port's name."""
    return [
        ("in_layers.0.weight", f"{ours}.norm1.weight"),
        ("in_layers.0.bias", f"{ours}.norm1.bias"),
        ("in_layers.2.weight", f"{ours}.conv1.weight"),
        ("in_layers.2.bias", f"{ours}.conv1.bias"),
        ("emb_layers.1.weight", f"{ours}.emb_proj.weight"),
        ("emb_layers.1.bias", f"{ours}.emb_proj.bias"),
        ("out_layers.0.weight", f"{ours}.norm2.weight"),
        ("out_layers.0.bias", f"{ours}.norm2.bias"),
        ("out_layers.3.weight", f"{ours}.conv2.weight"),
        ("out_layers.3.bias", f"{ours}.conv2.bias"),
        ("skip_connection.weight", f"{ours}.skip.weight"),
        ("skip_connection.bias", f"{ours}.skip.bias"),
    ]


def _attn_pairs(ours: str) -> list[tuple[str, str]]:
    out = [(f"{n}.{leaf}", f"{ours}.{n}.{leaf}")
           for n in ("norm", "proj_in", "proj_out")
           for leaf in ("weight", "bias")]
    t, tb = "transformer_blocks.0", f"{ours}.tblock_0"
    for attn in ("attn1", "attn2"):
        for qkv in ("to_q", "to_k", "to_v"):
            out.append((f"{t}.{attn}.{qkv}.weight",
                        f"{tb}.{attn}.{qkv}.weight"))
        for leaf in ("weight", "bias"):
            out.append((f"{t}.{attn}.to_out.0.{leaf}",
                        f"{tb}.{attn}.to_out.{leaf}"))
    for norm in ("norm1", "norm2", "norm3"):
        for leaf in ("weight", "bias"):
            out.append((f"{t}.{norm}.{leaf}", f"{tb}.{norm}.{leaf}"))
    for ck, ours in (("ff.net.0.proj", "ff_geglu.proj"),
                     ("ff.net.2", "ff_out")):
        for leaf in ("weight", "bias"):
            out.append((f"{t}.{ck}.{leaf}", f"{tb}.{ours}.{leaf}"))
    return out


def sd_unet_key_map(cfg: SDUNetConfig = SDUNetConfig()
                    ) -> Iterator[tuple[str, str]]:
    """(CompVis key, port name) pairs of the whole UNet, ``skip`` pairs
    included whether the block has one or not."""
    for i in (0, 2):
        for leaf in ("weight", "bias"):
            yield (f"time_embed.{i}.{leaf}", f"time_embed_{i}.{leaf}")
    for leaf in ("weight", "bias"):
        yield (f"input_blocks.0.0.{leaf}", f"conv_in.{leaf}")

    idx, ds = 1, 1
    n_levels = len(cfg.channel_mult)
    for i in range(n_levels):
        for j in range(cfg.num_res_blocks):
            base = f"input_blocks.{idx}"
            for ck, ours in _resblock_pairs(f"down_{i}_res_{j}"):
                yield (f"{base}.0.{ck}", ours)
            if ds in cfg.attention_ds:
                for ck, ours in _attn_pairs(f"down_{i}_attn_{j}"):
                    yield (f"{base}.1.{ck}", ours)
            idx += 1
        if i != n_levels - 1:
            for leaf in ("weight", "bias"):
                yield (f"input_blocks.{idx}.0.op.{leaf}",
                       f"down_{i}_downsample.{leaf}")
            idx += 1
            ds *= 2

    for ck, ours in _resblock_pairs("mid_res_1"):
        yield (f"middle_block.0.{ck}", ours)
    for ck, ours in _attn_pairs("mid_attn"):
        yield (f"middle_block.1.{ck}", ours)
    for ck, ours in _resblock_pairs("mid_res_2"):
        yield (f"middle_block.2.{ck}", ours)

    idx = 0
    for i in reversed(range(n_levels)):
        for j in range(cfg.num_res_blocks + 1):
            base = f"output_blocks.{idx}"
            for ck, ours in _resblock_pairs(f"up_{i}_res_{j}"):
                yield (f"{base}.0.{ck}", ours)
            sub = 1
            if ds in cfg.attention_ds:
                for ck, ours in _attn_pairs(f"up_{i}_attn_{j}"):
                    yield (f"{base}.{sub}.{ck}", ours)
                sub += 1
            if i != 0 and j == cfg.num_res_blocks:
                for leaf in ("weight", "bias"):
                    yield (f"{base}.{sub}.conv.{leaf}",
                           f"up_{i}_upsample.{leaf}")
            idx += 1
        if i != 0:
            ds //= 2

    for ck, ours in (("out.0", "norm_out"), ("out.2", "conv_out")):
        for leaf in ("weight", "bias"):
            yield (f"{ck}.{leaf}", f"{ours}.{leaf}")


def compvis_unet_to_torch(state_dict: Mapping,
                          cfg: SDUNetConfig = SDUNetConfig(),
                          prefix: str = PREFIX) -> dict[str, torch.Tensor]:
    """A CompVis SD state dict -> the SDUNet state dict of ``cfg``, float32
    on the CPU. Strict over the mapped keys (a missing one raises KeyError,
    but for the ``skip_connection`` a block has only where its channels
    change); unmapped CompVis keys are logged."""
    sd = {k[len(prefix):]: v for k, v in state_dict.items()
          if k.startswith(prefix)}
    out, used = {}, set()
    for ck, ours in sd_unet_key_map(cfg):
        if ck not in sd:
            if ".skip." in ours:
                continue
            raise KeyError(f"missing CompVis key {ck}")
        out[ours] = torch.as_tensor(sd[ck]).detach().to(
            "cpu", torch.float32).contiguous()
        used.add(ck)
    leftover = set(sd) - used
    if leftover:
        log.info("unmapped CompVis keys (ok if aux heads): %s",
                 sorted(leftover)[:8])
    return out


def torch_unet_to_compvis(params: SDUNet | Mapping[str, torch.Tensor],
                          cfg: SDUNetConfig = SDUNetConfig()
                          ) -> dict[str, torch.Tensor]:
    """The inverse: an SDUNet (or its state dict) -> CompVis keys under
    ``model.diffusion_model.``, float32 on the CPU."""
    sd = params.state_dict() if isinstance(params, SDUNet) else params
    return {f"{PREFIX}{ck}": sd[ours].detach().to("cpu", torch.float32)
            for ck, ours in sd_unet_key_map(cfg) if ours in sd}
