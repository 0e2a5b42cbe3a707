"""Helpers over named parameter tensors for the unlearning engine.

Port of the parts of ``uurg_tpu/core/tree.py`` that the SFR-on step and
runner use. A "tree" here is a ``dict[str, Tensor]`` keyed by the reference
parameter names (``model.named_parameters()``); gradients are the
parameters' ``.grad`` tensors. Functions whose name ends in ``_`` update
their first argument in place, to keep the step from holding a second copy
of the gradients.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping

import torch


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
    may be PackedMask (unpacked at the multiply) or 0/1 / bool tensors."""
    for k, x in a.items():
        y = b[k]
        x.mul_(y.unpack(x.dtype) if isinstance(y, PackedMask) else y.to(x.dtype))


def global_norm(tree: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """L2 norm over every leaf in fp32, matching
    torch.nn.utils.clip_grad_norm_. A 0-d tensor; no host sync."""
    leaves = [t.float() for t in tree.values()]
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(leaves)))


def clip_by_global_norm_(tree: Mapping[str, torch.Tensor],
                         max_norm: float) -> torch.Tensor:
    """Scale the whole tree in place by ``min(1, max_norm / (norm + 1e-6))``
    so its global norm is at most ``max_norm``. Returns the norm before
    clipping."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    torch._foreach_mul_(list(tree.values()), scale)
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
