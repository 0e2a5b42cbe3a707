"""DiT checkpoints in the reference (facebookresearch DiT) layout.

Port of ``uurg_tpu/io/dit_interop.py``. The reference files
(DiT/download.py ``find_model``, DiT/forget.py:347-356) are a dict
``{"model", "ema", "opt", "args"}`` of state dicts under the reference
names, or a bare (EMA) state dict; the port's DiT has those names, so they
load with ``load_state_dict``. The reference keeps the fixed sin-cos
``pos_embed`` as a frozen parameter; the port recomputes it (a
non-persistent buffer), so the loader checks its shape and drops it and the
writer adds it, so that the reference's own strict ``load_state_dict`` reads
the port's files. JAX parameter trees convert with
:func:`uurg_torch.io.jax_interop.jax_dit_params_to_torch`.
"""
from __future__ import annotations

import logging
import os
import pickle

import torch

from uurg_torch.models.dit import DiT
from uurg_torch.parallel.dist import rank
from uurg_torch.parallel.mesh import full_state_dict

log = logging.getLogger("uurg_torch.dit")


def _reference_state_dict(model: DiT) -> dict[str, torch.Tensor]:
    sd = full_state_dict(model)
    sd["pos_embed"] = model.pos_embed.detach().float().cpu()[None]
    return sd


def save_dit_checkpoint(path: str, model: DiT,
                        ema_model: DiT | None = None) -> None:
    """Write ``{"model": sd, "ema": sd}`` (``ema`` only with an EMA model):
    the parameters on the CPU under the reference names, with the
    reference's ``pos_embed`` of shape (1, T, hidden), beside ``path``
    first and then renamed over it. No ``args``: the file loads with
    ``weights_only=True``. Sharded (FSDP) models are gathered whole, which
    every rank of the group calls; rank 0 alone writes."""
    payload = {"model": _reference_state_dict(model)}
    if ema_model is not None:
        payload["ema"] = _reference_state_dict(ema_model)
    if rank() != 0:
        return
    tmp = f"{path}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def _load(path: str):
    """The port's files load with ``weights_only=True``; the reference's
    hold an argparse ``Namespace`` under ``args``, which only the full
    unpickler reads (a trusted file the caller names)."""
    try:
        return torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError:
        log.info("%s holds objects other than tensors (the reference's "
                 "args); loading it with the full unpickler", path)
        return torch.load(path, map_location="cpu", weights_only=False)


def load_dit_reference_checkpoint(path: str, model: DiT,
                                  prefer_ema: bool = True) -> DiT:
    """Load a DiT checkpoint file into ``model`` (strict): the
    ``{"model", "ema", ...}`` dict (``ema`` when ``prefer_ema`` and present)
    or a bare state dict. ``pos_embed``, when present, must have the
    model's shape and is dropped. Returns ``model``."""
    ck = _load(path)
    if isinstance(ck, dict) and ("ema" in ck or "model" in ck):
        sd = ck["ema" if prefer_ema and "ema" in ck else "model"]
    else:
        sd = ck
    sd = dict(sd)
    pos = sd.pop("pos_embed", None)
    if pos is not None and tuple(pos.shape) != (1, *model.pos_embed.shape):
        raise ValueError(f"{path}: pos_embed {tuple(pos.shape)} does not fit "
                         f"the model's {(1, *model.pos_embed.shape)}")
    model.load_state_dict(sd, strict=True)
    return model
