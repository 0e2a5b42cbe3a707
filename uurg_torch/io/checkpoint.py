"""Files of named tensors: Fisher diagonals, saliency masks and classifier
weights.

The counterpart for such trees of ``uurg_tpu/io/checkpoint.py``, which
writes Orbax directories. The port cannot read Orbax without JAX, so it
writes one ``torch.save`` file a tree: a dict keyed by the reference
parameter names (a Fisher or a mask), or a model's ``state_dict()`` (a
classifier: parameters and BatchNorm buffers, ``num_batches_tracked``
included). The file is read back with ``weights_only=True`` and so
holds tensors and plain containers only: a
:class:`~uurg_torch.core.tree.PackedMask` leaf is stored as ``{"bits":
uint8 tensor, "shape": list}`` and rebuilt on load.
"""
from __future__ import annotations

import os
from typing import Mapping

import torch

from uurg_torch.core.tree import PackedMask


def save_checkpoint(path: str, tree: Mapping) -> None:
    """Write ``tree`` (``dict[str, Tensor | PackedMask]``) to ``path``,
    beside it first and then renamed over it, so a reader never sees half
    of it. The tensors are copied to the CPU."""
    payload = {k: {"bits": v.bits.cpu(), "shape": list(v.shape)}
               if isinstance(v, PackedMask) else v.detach().cpu()
               for k, v in tree.items()}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def restore_checkpoint(path: str, like=None) -> dict:
    """Read what :func:`save_checkpoint` wrote, on the CPU. With ``like``
    (a dict of named tensors, or a model, which stands for its
    ``state_dict()``: parameters and buffers), the keys and shapes must be
    ``like``'s, else ``ValueError``. A tree over the parameters alone (a
    Fisher, a mask) is checked against ``dict(model.named_parameters())``. A directory (an Orbax tree written by
    the JAX package) raises: it cannot be read without JAX."""
    if os.path.isdir(path):
        raise ValueError(
            f"{path} is a directory, an Orbax tree of the JAX package; the "
            f"port reads only the torch.save files it writes itself, and "
            f"Orbax cannot be read without JAX")
    raw = torch.load(path, map_location="cpu", weights_only=True)
    tree = {k: PackedMask(v["bits"], tuple(v["shape"]))
            if isinstance(v, dict) else v for k, v in raw.items()}
    if like is not None:
        ref = like.state_dict() if isinstance(like, torch.nn.Module) \
            else like
        if set(tree) != set(ref):
            missing, extra = set(ref) - set(tree), set(tree) - set(ref)
            raise ValueError(
                f"{path}: keys differ from the model's (missing "
                f"{sorted(missing)[:5]}, unexpected {sorted(extra)[:5]})")
        bad = [k for k in ref if tuple(tree[k].shape) != tuple(ref[k].shape)]
        if bad:
            raise ValueError(
                f"{path}: shapes differ from the model's at {bad[:5]} "
                f"({tuple(tree[bad[0]].shape)} vs {tuple(ref[bad[0]].shape)})")
    return tree
