"""VAE checkpoints: CompVis first-stage files and the port's own.

Port of the VAE half of ``uurg_tpu/io/vae_clip_interop.py``
(``compvis_vae_to_flax``); the CLIP half comes with SD. A CompVis
``first_stage_model`` (SD's ``sd-v1-*.ckpt``, or a standalone VAE
``.ckpt``/``.pth`` such as ``vae-ft-ema-560000-ema-pruned.ckpt``, whose keys
carry no prefix) uses the names the port's
:class:`~uurg_torch.models.autoencoder_kl.AutoencoderKL` has, so the map
strips the prefix, keeps the model's keys (the files also hold the UNet,
the text encoder or the training loss) and turns Linear attention weights
into 1x1 convolutions. The port's own file (:func:`save_vae`) is
``{"vae_config", "state_dict"}``. An Orbax directory of the JAX package
cannot be read without JAX and raises.
"""
from __future__ import annotations

import dataclasses
import os

import torch

from uurg_torch.io.dit_interop import _load
from uurg_torch.models.autoencoder_kl import AutoencoderKL, VAEConfig

_SUFFIXES = (".ckpt", ".pth", ".pt")
_ATTN_WEIGHTS = tuple(f".attn_1.{n}.weight" for n in ("q", "k", "v",
                                                      "proj_out"))


def check_vae_checkpoint(path: str) -> None:
    """Raise ValueError unless ``path`` names a file the port reads."""
    if os.path.isdir(path) or not path.endswith(_SUFFIXES):
        raise ValueError(
            f"--vae_ckpt {path}: the port reads a CompVis first-stage "
            f".ckpt/.pth or its own .pt VAE file; an Orbax directory of the "
            f"JAX package cannot be read without JAX")


def compvis_vae_to_torch(state_dict, cfg: VAEConfig = VAEConfig(),
                         prefix: str = "first_stage_model."
                         ) -> dict[str, torch.Tensor]:
    """A CompVis state dict -> the port's AutoencoderKL state dict of
    ``cfg``, float32 on the CPU. Keys under ``prefix`` are taken when there
    are any (a whole SD checkpoint), else the keys as they are (a VAE
    file); keys the model does not have are left out, a missing one
    raises KeyError."""
    if any(k.startswith(prefix) for k in state_dict):
        state_dict = {k[len(prefix):]: v for k, v in state_dict.items()
                      if k.startswith(prefix)}
    with torch.device("meta"):
        names = AutoencoderKL(cfg).state_dict().keys()
    out = {}
    for name in names:
        if name not in state_dict:
            raise KeyError(f"the CompVis state dict has no {name}")
        v = torch.as_tensor(state_dict[name]).detach().to("cpu",
                                                          torch.float32)
        if name.endswith(_ATTN_WEIGHTS) and v.ndim == 2:
            v = v[:, :, None, None]                 # Linear -> 1x1 conv
        out[name] = v.contiguous()
    return out


def save_vae(path: str, model: AutoencoderKL) -> None:
    """The port's VAE file: its config and its state dict on the CPU."""
    cfg = dataclasses.asdict(model.cfg)
    cfg["channel_mult"] = list(cfg["channel_mult"])
    torch.save({"vae_config": cfg,
                "state_dict": {k: v.detach().cpu()
                               for k, v in model.state_dict().items()}}, path)


def load_vae(path: str, device: str | torch.device = "cpu",
             cfg: VAEConfig | None = None) -> AutoencoderKL:
    """The AutoencoderKL in ``path`` on ``device``, frozen, in eval mode:
    the port's own file (with its config), or a CompVis first stage (of
    ``cfg``, the SD / DiT configuration when None)."""
    check_vae_checkpoint(path)
    ck = _load(path)
    if isinstance(ck, dict) and "vae_config" in ck:
        saved = dict(ck["vae_config"])
        saved["channel_mult"] = tuple(saved["channel_mult"])
        cfg, sd = VAEConfig(**saved), ck["state_dict"]
    else:
        if isinstance(ck, dict) and isinstance(ck.get("state_dict"), dict):
            ck = ck["state_dict"]
        sd = compvis_vae_to_torch(ck, cfg or VAEConfig())
    with torch.device(device):
        model = AutoencoderKL(cfg)
    model.load_state_dict(sd, strict=True)
    return model.to(device).eval().requires_grad_(False)
