"""Helpers over named parameter tensors for the unlearning engine.

Port of the parts of ``uurg_tpu/core/tree.py`` that the SFR-on step and
runner use. A "tree" here is a ``dict[str, Tensor]`` keyed by the reference
parameter names (``model.named_parameters()``); gradients are the
parameters' ``.grad`` tensors. Functions whose name ends in ``_`` update
their first argument in place, to keep the step from holding a second copy
of the gradients.

Leaves may be DTensors (FSDP's and tensor parallel's sharded parameters
and gradients) or stage-owned (the pipeline's blocks, empty on the other
stages): the functions work on each rank's part and all-reduce what is
global (the norm), so every rank sees the one-device value.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping

import torch
import torch.distributed as dist

from uurg_torch.parallel.mesh import (is_sharded, local, local_slice,
                                      stage_owned)


@dataclasses.dataclass(frozen=True)
class PackedMask:
    """A boolean mask leaf bit-packed 8x (uint8, 1 bit/element).

    Bit-PLANE layout, as in the JAX package: byte ``i`` carries bit ``b`` of
    flat element ``b*M + i`` (M = ceil(N/8)), so a packed mask is
    byte-identical between the two packages."""

    bits: torch.Tensor                                    # uint8, [M]
    shape: tuple

    def unpack(self, dtype=torch.float32) -> torch.Tensor:
        n = math.prod(self.shape)
        shifts = torch.arange(8, dtype=torch.uint8, device=self.bits.device)
        rows = (self.bits[None, :] >> shifts[:, None]) & 1
        return rows.reshape(-1)[:n].to(dtype).reshape(self.shape)

    def to(self, device) -> "PackedMask":
        return PackedMask(self.bits.to(device), self.shape)


def _pack_leaf(leaf: torch.Tensor) -> PackedMask:
    flat = leaf.reshape(-1) != 0
    m = -(-flat.numel() // 8)                            # bytes per plane
    planes = torch.zeros(8 * m, dtype=torch.uint8, device=leaf.device)
    planes[:flat.numel()] = flat
    planes = planes.reshape(8, m)
    shifts = torch.arange(8, dtype=torch.uint8, device=leaf.device)
    byte = (planes << shifts[:, None]).sum(dim=0, dtype=torch.uint8)
    return PackedMask(byte, tuple(leaf.shape))


def pack_mask(mask: Mapping[str, torch.Tensor]) -> dict[str, PackedMask]:
    """Bit-pack every leaf of a 0/1 (or bool) mask."""
    return {k: _pack_leaf(v) for k, v in mask.items()}


def tree_mul_(a: Mapping[str, torch.Tensor], b: Mapping) -> None:
    """``a *= b`` leaf by leaf (e.g. grads * mask), in place. ``b`` leaves
    may be PackedMask (unpacked at the multiply) or 0/1 / bool tensors. A
    sharded leaf of ``a`` is multiplied shard by shard: by the shard of a
    ``b`` leaf placed like it, else by its slice of the whole ``b`` leaf
    (a packed mask stays whole, 1 bit an element)."""
    for k, x in a.items():
        y = b[k]
        if isinstance(y, PackedMask):
            y = y.unpack(x.dtype)
        y = local(y) if is_sharded(y) else local_slice(y, x)
        local(x).mul_(y.to(x.dtype))


def _shard_groups(t: torch.Tensor) -> tuple:
    """The process groups of more than one rank over which a leaf's parts
    are spread: a DTensor's shards, a stage-owned leaf's stages (none on a
    one-rank mesh or a whole leaf)."""
    owned = stage_owned(t)
    if owned is not None:
        return () if owned.group is None else (owned.group,)
    if not is_sharded(t):
        return ()
    mesh = t.device_mesh
    return tuple(mesh.get_group(i) for i, p in enumerate(t.placements)
                 if p.is_shard() and mesh.size(i) > 1)


def global_norm(tree: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """L2 norm over every leaf in fp32, matching
    torch.nn.utils.clip_grad_norm_. A 0-d tensor; no host sync. A sharded
    leaf's norm is summed over its shards, a stage-owned one's over the
    stages (its own counts once, the others hold nothing), the same on
    every rank; a whole leaf counts once."""
    leaves = list(tree.values())
    norms = torch.stack(torch._foreach_norm([local(t).float()
                                             for t in leaves]))
    by_groups: dict[tuple, list[int]] = {}
    for i, t in enumerate(leaves):
        if _shard_groups(t):
            by_groups.setdefault(_shard_groups(t), []).append(i)
    for groups, idx in by_groups.items():
        idx = torch.tensor(idx, device=norms.device)
        sq = norms.index_select(0, idx).square()
        for g in groups:
            dist.all_reduce(sq, group=g)
        norms = norms.index_copy(0, idx, sq.sqrt())
    return torch.linalg.vector_norm(norms)


def clip_by_global_norm_(tree: Mapping[str, torch.Tensor],
                         max_norm: float) -> torch.Tensor:
    """Scale the whole tree in place by ``min(1, max_norm / (norm + 1e-6))``
    so its global norm is at most ``max_norm``. Returns the norm before
    clipping."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    torch._foreach_mul_([local(t) for t in tree.values()], scale)
    return norm


def tree_size(tree: Mapping) -> int:
    return sum(math.prod(v.shape) if isinstance(v, PackedMask) else v.numel()
               for v in tree.values())


def tree_count_nonzero(tree: Mapping) -> int:
    return sum(int(torch.count_nonzero(
        v.unpack(torch.bool) if isinstance(v, PackedMask) else v))
        for v in tree.values())


def sparsity(tree: Mapping) -> float:
    """Fraction of exactly-zero entries (reference calc_sparsity,
    Classification/unlearn/sfron.py:19-28)."""
    return 1.0 - tree_count_nonzero(tree) / tree_size(tree)
