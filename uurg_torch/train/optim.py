"""Optimizer factories for the reference's torch optimizers.

Port of ``uurg_tpu/train/optim.py``. The JAX package rebuilds torch.optim
semantics in optax; here they are torch.optim's own:
- Adam with ``weight_decay`` is L2 on the gradient (coupled: the decay is
  added before the moment update), with eps outside the square root.
- AdamW is decoupled decay.
- SGD(momentum, weight_decay) is grad += wd * p; buf = m * buf + grad.

The learning rate is settable per step with :func:`set_lr` (the JAX package
injects it as a hyperparameter): the SFR-on step applies the optimizer twice
per iteration while the reference's scheduler ticks once per iteration.
"""
from __future__ import annotations

import math
from typing import Iterable

import torch


def cosine_annealing(base_lr: float, total_steps: int):
    """torch CosineAnnealingLR / reference cosine_lr_scheduler:
    lr(t) = base * (1 + cos(pi * t / T)) / 2."""

    def sched(step):
        return base_lr * (1.0 + math.cos(math.pi * step / total_steps)) / 2.0

    return sched


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr


def make_optimizer(
    name: str,
    params: Iterable[torch.nn.Parameter],
    lr: float,
    *,
    momentum: float = 0.9,
    weight_decay: float = 0.0,
    beta1: float = 0.9,
    beta2: float = 0.999,
    eps: float = 1e-8,
    amsgrad: bool = False,
    mu_dtype=None,
    nu_dtype=None,
) -> torch.optim.Optimizer:
    """``mu_dtype``/``nu_dtype`` (the JAX package's moment-memory knobs for
    DiT-XL) are not ported yet and raise. So does ``amsgrad``: optax's
    version keeps the maximum of the bias-corrected second moment, torch's
    of the raw one, so the two would not agree."""
    if mu_dtype is not None or nu_dtype is not None:
        raise NotImplementedError(
            "mu_dtype/nu_dtype (reduced-precision Adam moments) arrive with "
            "the DiT slice")
    name = name.lower()
    params = list(params)
    if name == "sgd":
        return torch.optim.SGD(params, lr=lr, momentum=momentum,
                               weight_decay=weight_decay)
    if amsgrad:
        raise NotImplementedError(
            "amsgrad is not ported: optax's and torch's variants differ")
    if name == "adam":
        return torch.optim.Adam(params, lr=lr, betas=(beta1, beta2), eps=eps,
                                weight_decay=weight_decay)
    if name == "adamw":
        return torch.optim.AdamW(params, lr=lr, betas=(beta1, beta2), eps=eps,
                                 weight_decay=weight_decay)
    raise NotImplementedError(f"Optimizer {name!r}")


def build_reference_optimizer(cfg, params: Iterable[torch.nn.Parameter],
                              mu_dtype=None,
                              nu_dtype=None) -> torch.optim.Optimizer:
    """From a reference-schema ``optim`` config section
    (DDPM/functions/__init__.py get_optimizer parity)."""
    o = cfg.optim
    return make_optimizer(
        o.optimizer,
        params,
        o.lr,
        weight_decay=o.get("weight_decay", 0.0),
        beta1=o.get("beta1", 0.9),
        eps=o.get("eps", 1e-8),
        amsgrad=o.get("amsgrad", False),
        mu_dtype=mu_dtype,
        nu_dtype=nu_dtype,
    )
