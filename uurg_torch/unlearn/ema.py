"""EMA / fast-slow weight mixing.

Port of ``uurg_tpu/unlearn/ema.py``. Both functions take lists of tensors
(``model.parameters()`` of the shadow and the live model) and update their
first argument IN PLACE; the JAX versions return new pytrees. Sharded
(FSDP) leaves are updated shard by shard: the shadow is placed as the
parameters are.

- DDPM EMAHelper (DDPM/models/ema.py:22-27):
    shadow = (1 - mu) * param + mu * shadow
- Classification fast-slow (Classification/unlearn/sfron.py:30-37):
    param = (1 - beta) * param_prev + beta * param_new
"""
from __future__ import annotations

from typing import Iterable

import torch

from uurg_torch.parallel.mesh import local


@torch.no_grad()
def ema_update(shadow: Iterable[torch.Tensor], params: Iterable[torch.Tensor],
               mu: float) -> None:
    """shadow <- (1 - mu) * params + mu * shadow, in place (mu = 1e-4 during
    SFR-on per DDPM/configs/cifar10_sfron.yml:24). Computed in the params
    dtype and stored in the shadow's dtype."""
    shadow = [local(s) for s in shadow]
    params = [local(p) for p in params]
    mixed = torch._foreach_add(
        torch._foreach_mul(params, 1.0 - mu),
        torch._foreach_mul([s.to(p.dtype) for s, p in zip(shadow, params)], mu))
    for s, m in zip(shadow, mixed):
        s.copy_(m)


@torch.no_grad()
def fast_slow_mix(params_new: Iterable[torch.Tensor],
                  params_prev: Iterable[torch.Tensor], beta: float) -> None:
    """params_new <- beta * params_new + (1 - beta) * params_prev, in place
    (Classification SFRon ema_beta; beta = 1.0 disables mixing)."""
    new = [local(p) for p in params_new]
    prev = [local(p) for p in params_prev]
    mixed = torch._foreach_add(torch._foreach_mul(new, beta),
                               torch._foreach_mul(prev, 1.0 - beta))
    for n, m in zip(new, mixed):
        n.copy_(m)
