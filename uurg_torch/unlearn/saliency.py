"""Weight-saliency masks: Fisher-ratio (SFR-on) and global top-k (SalUn).

Port of ``uurg_tpu/unlearn/saliency.py``. Masks and their inputs are
``dict[str, Tensor]`` keyed by the reference parameter names
(``model.named_parameters()``), as in :mod:`uurg_torch.core.tree`.

- ratio mask: ``(F_forget + eps) / (F_remain + eps) >= threshold``,
  elementwise in fp32.
- top-k mask: one global threshold over ``|g|`` of every leaf, the value at
  ascending index ``total - k`` (``k = int(total * ratio)``), taken with one
  ``torch.kthvalue`` instead of a sort; ``|g| >= threshold`` keeps the ties.

Masks are bool (1 byte an element); ``dtype=`` gives a float mask where a
caller needs arithmetic on it. For 1-bit storage the port has the bit-plane
:class:`~uurg_torch.core.tree.PackedMask` (``core.tree.pack_mask``), which
:mod:`uurg_torch.io.checkpoint` writes and reads.
"""
from __future__ import annotations

import math
from typing import Mapping

import torch

from uurg_torch.core import tree as tr


def fisher_ratio_mask(forget_fisher: Mapping[str, torch.Tensor],
                      remain_fisher: Mapping[str, torch.Tensor],
                      threshold: float, eps: float = 1e-15,
                      dtype: torch.dtype = torch.bool
                      ) -> dict[str, torch.Tensor]:
    """1 where ``(F_f + eps) / (F_r + eps) >= threshold``."""
    return {k: ((f.float() + eps) / (remain_fisher[k].float() + eps)
                >= threshold).to(dtype)
            for k, f in forget_fisher.items()}


def topk_saliency_mask(grads: Mapping[str, torch.Tensor], ratio: float,
                       dtype: torch.dtype = torch.bool
                       ) -> dict[str, torch.Tensor]:
    """1 where ``|g|`` is in the global top ``ratio`` fraction, ties at the
    threshold included (the reference's argsort-of-argsort ranking up to
    ties)."""
    flat = torch.cat([g.detach().float().abs().reshape(-1)
                      for g in grads.values()])
    total = flat.numel()
    k = int(total * ratio)
    if k <= 0:
        thresh = math.inf
    elif k >= total:
        thresh = -math.inf
    else:
        # ascending index total - k is the (total - k + 1)-th smallest
        thresh = torch.kthvalue(flat, total - k + 1).values
    del flat
    return {n: (g.detach().float().abs() >= thresh).to(dtype)
            for n, g in grads.items()}


def mask_sparsity(mask: Mapping) -> float:
    """Fraction of zeroed (non-salient) weights, the reference's logged
    invariant (Classification/unlearn/sfron.py:335)."""
    return float(tr.sparsity(mask))
