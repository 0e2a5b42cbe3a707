"""torch classifier checkpoints for the pretraining CLI's ``--torch_init``.

Port of ``uurg_tpu/io/torch_classifier.py``. The reference builds every
classifier from torchvision with ImageNet weights and a re-initialised head
(Classification/models/{resnet,vit,swin}.py). Without a download, the user
drops the ``.pth`` locally: it is read through
:mod:`uurg_torch.io.tv_resnet_interop` (torchvision or reference-CIFAR
layout) and overlaid on a freshly initialised model, keeping the fresh
tensor wherever the shapes disagree, which re-creates the reference's head
re-initialisation without special cases. ViT and Swin arrive with the next
classification slice.
"""
from __future__ import annotations

import logging
from typing import Mapping

import torch

from uurg_torch.io.tv_resnet_interop import load_torch_resnet_checkpoint

log = logging.getLogger(__name__)


def load_torch_classifier(path: str, model_name: str
                          ) -> dict[str, torch.Tensor]:
    """A locally supplied torch classifier checkpoint as a state dict under
    the port's names, by model family (the ``create_model`` spellings)."""
    name = model_name.lower()
    if name.startswith("resnet"):
        return load_torch_resnet_checkpoint(path)
    if name.startswith(("vit", "swin")):
        raise NotImplementedError(
            f"{model_name}: ViT and Swin checkpoints arrive with the next "
            f"classification slice (io/tv_vit_swin_interop.py)")
    raise ValueError(f"no torch converter for model family {model_name!r}")


@torch.no_grad()
def overlay_pretrained(model: torch.nn.Module,
                       loaded: Mapping[str, torch.Tensor]) -> torch.nn.Module:
    """Copy into ``model`` (parameters and buffers) every tensor of
    ``loaded`` whose name and shape match; keep the fresh tensor elsewhere
    and log each kept name, so no mismatch goes unseen. Returns
    ``model``."""
    kept, used = [], 0
    for name, t in model.state_dict().items():
        cand = loaded.get(name)
        if cand is not None and tuple(cand.shape) == tuple(t.shape):
            t.copy_(cand)
            used += 1
        else:
            kept.append(name)
    log.info("torch_init: %d tensors loaded, %d kept fresh%s", used,
             len(kept), f" ({', '.join(kept[:6])})" if kept else "")
    return model
