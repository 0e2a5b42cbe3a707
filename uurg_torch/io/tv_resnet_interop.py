"""torch ResNet checkpoints -> the port's ResNet state dict.

Port of ``uurg_tpu/io/tv_resnet_interop.py``. Two naming schemes load
through one key map:

- **torchvision** ResNets (``conv1/bn1/layer{1-4}.{j}/downsample/fc``): the
  UA classifier probe is a fine-tuned torchvision ResNet-34 at 224 px
  (DDPM/classifier_evaluation.py:16-40); the port's model already has these
  names.
- **reference-CIFAR** classifiers (``conv1/bn1/layer{1-4}.{j}/shortcut/
  linear``, Classification/models/resnet.py, saved by main_pretrain.py):
  ``shortcut`` becomes ``downsample`` and ``linear`` becomes ``fc``.

DataParallel ``module.`` prefixes are stripped. Layouts need no change:
both are torch's.
"""
from __future__ import annotations

import os
import re
from typing import Any, Mapping

import torch

_BN_FIELDS = ("weight", "bias", "running_mean", "running_var",
              "num_batches_tracked")
_KNOWN = re.compile(
    r"(conv1\.weight"
    r"|bn1\.(%s)"
    r"|layer\d+\.\d+\.(conv\d\.weight|bn\d\.(%s))"
    r"|layer\d+\.\d+\.downsample\.(0\.weight|1\.(%s))"
    r"|fc\.(weight|bias))" % (("|".join(_BN_FIELDS),) * 3))


def torch_resnet_state_dict(state_dict: Mapping[str, Any]
                            ) -> dict[str, torch.Tensor]:
    """A torchvision or reference-CIFAR ResNet state dict under the port's
    (torchvision) names. Every key must be recognised, else ValueError."""
    out, unknown = {}, []
    for key, v in state_dict.items():
        k = key.removeprefix("module.")
        k = re.sub(r"^linear\.", "fc.", k)
        k = re.sub(r"^(layer\d+\.\d+\.)shortcut\.", r"\1downsample.", k)
        if _KNOWN.fullmatch(k):
            out[k] = torch.as_tensor(v)
        else:
            unknown.append(key)
    if unknown:
        raise ValueError(f"unrecognized torch keys: {unknown[:8]}"
                         f"{'...' if len(unknown) > 8 else ''}")
    return out


def load_torch_resnet_checkpoint(path: str) -> dict[str, torch.Tensor]:
    """A ``.pth``/``.pt`` ResNet checkpoint -> the port's state dict. Takes a bare state dict or a ``{"state_dict": ...}`` or
    ``{"model": ...}`` wrapper (DDPM/train_classifier.py saves
    ``model.state_dict()`` bare). A directory (an Orbax checkpoint of the
    JAX package) raises: it needs JAX to read."""
    if os.path.isdir(path):
        raise ValueError(
            f"{path} is a directory (an Orbax checkpoint of the JAX "
            f"package); the port reads torch .pth files only")
    obj = torch.load(path, map_location="cpu", weights_only=True)
    for key in ("state_dict", "model"):
        if isinstance(obj, dict) and isinstance(obj.get(key), dict):
            obj = obj[key]
    return torch_resnet_state_dict(obj)
