"""InceptionV3 weights into the port's model (pt_inception / torchvision
names).

``flax_inception_to_torch`` is this package's own inverse of the key map in
``uurg_tpu/io/inception_interop.py`` (``convert_inception_state_dict``): it
reads the JAX package's flat flax-layout npz (``params/Mixed_5b/b1x1/conv/
kernel`` HWIO, ``batch_stats/.../bn/mean``, ``params/fc/kernel`` (in, out))
into the port's state dict. ``pt_inception_state_dict`` readies pytorch-fid's
``pt_inception-2015-12-05.pth``, whose names the port's model already has.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

# flax stem module name -> port (pt_inception) block name
_BLOCK = {
    "Conv2d_1a": "Conv2d_1a_3x3", "Conv2d_2a": "Conv2d_2a_3x3",
    "Conv2d_2b": "Conv2d_2b_3x3", "Conv2d_3b": "Conv2d_3b_1x1",
    "Conv2d_4a": "Conv2d_4a_3x3",
}
# flax branch module name -> port branch name
_BRANCH = {
    "b1x1": "branch1x1",
    "b5x5_1": "branch5x5_1", "b5x5_2": "branch5x5_2",
    "b3x3dbl_1": "branch3x3dbl_1", "b3x3dbl_2": "branch3x3dbl_2",
    "b3x3dbl_3": "branch3x3dbl_3",
    "b3x3dbl_3a": "branch3x3dbl_3a", "b3x3dbl_3b": "branch3x3dbl_3b",
    "bpool": "branch_pool",
    "b3x3": "branch3x3", "b3x3_1": "branch3x3_1", "b3x3_2": "branch3x3_2",
    "b3x3_2a": "branch3x3_2a", "b3x3_2b": "branch3x3_2b",
    **{f"b7x7_{i}": f"branch7x7_{i}" for i in range(1, 4)},
    **{f"b7x7dbl_{i}": f"branch7x7dbl_{i}" for i in range(1, 6)},
    **{f"b7x7x3_{i}": f"branch7x7x3_{i}" for i in range(1, 5)},
}
_BN_LEAF = {("params", "scale"): "weight", ("params", "bias"): "bias",
            ("batch_stats", "mean"): "running_mean",
            ("batch_stats", "var"): "running_var"}


def flax_inception_to_torch(flat: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """Flat ``'root/module/.../leaf' -> array`` (the JAX package's npz
    layout) -> the port's InceptionV3 state dict of float32 tensors. An
    unknown path raises KeyError."""
    out = {}
    for key, v in flat.items():
        v = np.asarray(v, np.float32)
        root, *mods, layer, leaf = key.split("/")
        if mods == [] and layer == "fc":
            out[f"fc.{'weight' if leaf == 'kernel' else 'bias'}"] = \
                torch.tensor(v.T if leaf == "kernel" else v)
            continue
        if len(mods) == 1 and mods[0] in _BLOCK:
            name = _BLOCK[mods[0]]
        elif (len(mods) == 2 and mods[0].startswith("Mixed_")
              and mods[1] in _BRANCH):
            name = f"{mods[0]}.{_BRANCH[mods[1]]}"
        else:
            raise KeyError(f"unmapped flax path {key}")
        if (layer, root, leaf) == ("conv", "params", "kernel"):
            out[f"{name}.conv.weight"] = torch.tensor(v.transpose(3, 2, 0, 1))
        elif layer == "bn" and (root, leaf) in _BN_LEAF:
            out[f"{name}.bn.{_BN_LEAF[root, leaf]}"] = torch.tensor(v)
        else:
            raise KeyError(f"unmapped flax path {key}")
    return out


def pt_inception_state_dict(state_dict: Mapping[str, Any]) -> dict:
    """pytorch-fid's ``pt_inception`` state dict without what the
    evaluator does not use: ``AuxLogits.*`` and the BatchNorm counters
    (``num_batches_tracked``, which ``load_state_dict`` fills in when
    absent). Every other key is kept, so loading it with ``strict=True``
    raises on a key the model lacks."""
    return {k: v for k, v in state_dict.items()
            if not k.startswith("AuxLogits.")
            and not k.endswith(".bn.num_batches_tracked")}
