"""CLIP text-encoder checkpoints, and a whole CompVis SD checkpoint.

Port of ``uurg_tpu/io/vae_clip_interop.py``. Together with
:mod:`uurg_torch.io.sd_interop` (the UNet) and
:mod:`uurg_torch.io.vae_interop` (the first stage) a CompVis
``sd-v1-*.ckpt`` loads into the port's three models. CLIP's HF
``transformers`` names (``text_model.embeddings.{token,position}_embedding``,
``encoder.layers.N.{self_attn.{q,k,v,out}_proj, layer_norm1/2, mlp.fc1/fc2}``,
``final_layer_norm``; SD/ldm/modules/encoders/modules.py FrozenCLIPEmbedder)
map to the port's Flax names; q, k and v are fused into one ``qkv``.
"""
from __future__ import annotations

from typing import Mapping

import torch

from uurg_torch.io.dit_interop import _load
from uurg_torch.io.sd_interop import compvis_unet_to_torch
from uurg_torch.io.vae_interop import compvis_vae_to_torch
from uurg_torch.models.autoencoder_kl import VAEConfig
from uurg_torch.models.clip_text import CLIPTextConfig
from uurg_torch.models.sd_unet import SDUNetConfig

CLIP_PREFIX = "cond_stage_model.transformer."


def _t(v) -> torch.Tensor:
    return torch.as_tensor(v).detach().to("cpu", torch.float32).contiguous()


def hf_clip_text_to_torch(state_dict: Mapping,
                          cfg: CLIPTextConfig = CLIPTextConfig(),
                          prefix: str = "text_model."
                          ) -> dict[str, torch.Tensor]:
    """An HF CLIP text model's state dict (keys with or without
    ``prefix``) -> a CLIPTextEncoder state dict of ``cfg``, float32 on the
    CPU."""
    sd = {k[len(prefix):] if k.startswith(prefix) else k: v
          for k, v in state_dict.items()}
    out = {"token_embed.weight": _t(sd["embeddings.token_embedding.weight"]),
           "pos_embed": _t(sd["embeddings.position_embedding.weight"])}
    for i in range(cfg.depth):
        b = f"encoder.layers.{i}."
        for leaf in ("weight", "bias"):
            out[f"attn_{i}.qkv.{leaf}"] = torch.cat(
                [_t(sd[f"{b}self_attn.{n}_proj.{leaf}"]) for n in "qkv"])
            out[f"attn_{i}.proj.{leaf}"] = _t(sd[f"{b}self_attn.out_proj."
                                                 f"{leaf}"])
            for src, dst in (("layer_norm1", "ln1"), ("layer_norm2", "ln2"),
                             ("mlp.fc1", "fc1"), ("mlp.fc2", "fc2")):
                out[f"{dst}_{i}.{leaf}"] = _t(sd[f"{b}{src}.{leaf}"])
    for leaf in ("weight", "bias"):
        out[f"ln_final.{leaf}"] = _t(sd[f"final_layer_norm.{leaf}"])
    return out


def load_compvis_sd_checkpoint(path: str,
                               unet_cfg: SDUNetConfig | None = None,
                               vae_cfg: VAEConfig | None = None,
                               text_cfg: CLIPTextConfig | None = None
                               ) -> dict[str, dict[str, torch.Tensor]]:
    """A whole ``sd-v1-*.ckpt`` (its ``state_dict``, or the bare dict) ->
    ``{"unet", "vae", "text"}``: the port's three state dicts."""
    ck = _load(path)
    sd = ck.get("state_dict", ck)
    clip_sd = {k[len(CLIP_PREFIX):]: v for k, v in sd.items()
               if k.startswith(CLIP_PREFIX)}
    return {
        "unet": compvis_unet_to_torch(sd, unet_cfg or SDUNetConfig()),
        "vae": compvis_vae_to_torch(sd, vae_cfg or VAEConfig()),
        "text": hf_clip_text_to_torch(clip_sd, text_cfg or CLIPTextConfig()),
    }
