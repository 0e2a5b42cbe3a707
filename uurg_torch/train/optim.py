"""Optimizer factories for the reference's torch optimizers.

Port of ``uurg_tpu/train/optim.py``. The JAX package rebuilds torch.optim
semantics in optax; here they are torch.optim's own:
- Adam with ``weight_decay`` is L2 on the gradient (coupled: the decay is
  added before the moment update), with eps outside the square root.
- AdamW is decoupled decay.
- SGD(momentum, weight_decay) is grad += wd * p; buf = m * buf + grad.

The JAX package's memory knobs (``mu_dtype``, ``nu_dtype``: moments stored
in bfloat16) and ``amsgrad`` follow optax's own rules, which torch.optim
cannot express (its Adam keeps moments in the parameter's dtype and its
AMSGrad takes the maximum of the raw second moment); with any of them set,
Adam and AdamW are :class:`OptaxAdam`.

The learning rate is settable per step with :func:`set_lr` (the JAX package
injects it as a hyperparameter): the SFR-on step applies the optimizer twice
per iteration while the reference's scheduler ticks once per iteration.
"""
from __future__ import annotations

import math
from typing import Iterable

import numpy as np
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


def _bias_corrections(b1: float, b2: float, count: int):
    """optax's ``1 - b ** count`` in float32."""
    c = np.float32(count)
    return (np.float32(1) - np.float32(b1) ** c,
            np.float32(1) - np.float32(b2) ** c)


class OptaxAdam(torch.optim.Optimizer):
    """Adam as the JAX package builds it from optax, for float32 parameters,
    one of three rules:

    - ``nu_dtype`` unset (``optax.scale_by_adam(mu_dtype=...)``): the
      moments are updated in float32 from the stored ones (``b1 * mu`` is
      taken in mu's dtype with b1 rounded to it, as JAX's weak typing
      does), this step's update is computed from the float32 moments, and
      only then is mu stored in ``mu_dtype``.
    - ``nu_dtype`` set (``scale_by_adam_dtypes``): the moment math runs in
      float32, both moments are stored downcast, and the update is computed
      from the *rounded* stored moments.
    - ``amsgrad`` (``optax.scale_by_amsgrad``): both moments are
      bias-corrected, ``nu_max = max(nu_max, nu_hat)`` and the update is
      ``mu_hat / (sqrt(nu_max) + eps)``, mu stored in ``mu_dtype`` after.
      Raises with ``nu_dtype`` (optax keeps nu and nu_max in float32).

    ``decoupled`` adds ``weight_decay * p`` to the update (AdamW, optax's
    ``add_decayed_weights`` after the scaling); otherwise the decay is added
    to the gradient first (torch Adam's L2). The parameter then moves by
    ``-lr * update``. State per parameter: ``step``, ``mu``, ``nu`` and,
    with ``amsgrad``, ``nu_max``."""

    def __init__(self, params, lr: float, betas=(0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 0.0, *,
                 decoupled: bool = False, amsgrad: bool = False,
                 mu_dtype: torch.dtype | None = None,
                 nu_dtype: torch.dtype | None = None):
        if amsgrad and nu_dtype is not None:
            raise NotImplementedError(
                "nu_dtype is not supported with amsgrad (optax's "
                "scale_by_amsgrad keeps nu/nu_max in f32)")
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps,
                                      weight_decay=weight_decay))
        self.decoupled, self.amsgrad = decoupled, amsgrad
        self.mu_dtype, self.nu_dtype = mu_dtype, nu_dtype

    def load_state_dict(self, state_dict) -> None:
        """torch.optim casts floating state to the parameter's dtype on
        load; the moments go back to their own (exactly: bf16 -> fp32 ->
        bf16)."""
        super().load_state_dict(state_dict)
        for st in self.state.values():
            for key, dtype in (("mu", self.mu_dtype), ("nu", self.nu_dtype)):
                if dtype is not None and key in st:
                    st[key] = st[key].to(dtype)

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            b1, b2 = group["betas"]
            eps, wd = group["eps"], group["weight_decay"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad.float()
                st = self.state[p]
                if not st:
                    st["step"] = 0
                    st["mu"] = torch.zeros_like(p, dtype=self.mu_dtype
                                                or p.dtype)
                    st["nu"] = torch.zeros_like(p, dtype=self.nu_dtype
                                                or p.dtype)
                    if self.amsgrad:
                        st["nu_max"] = torch.zeros_like(p)
                if wd and not self.decoupled:
                    g = g + wd * p
                st["step"] += 1
                bc1, bc2 = _bias_corrections(b1, b2, st["step"])
                mu, nu = st["mu"], st["nu"]
                if self.nu_dtype is not None:
                    mu_new = (b1 * mu.float() + (1 - b1) * g).to(mu.dtype)
                    nu_new = (b2 * nu.float() + (1 - b2) * g * g).to(nu.dtype)
                    upd = (mu_new.float() / float(bc1)) / (
                        torch.sqrt(nu_new.float() / float(bc2)) + eps)
                else:
                    # JAX's weak typing rounds b1 to mu's dtype and takes
                    # b1 * mu in it; b1 * mu's exact product rounded to
                    # mu's dtype is the same number
                    b1_mu = float(torch.tensor(b1, dtype=mu.dtype))
                    mu_new = (1 - b1) * g + b1_mu * mu
                    nu_new = (1 - b2) * (g * g) + b2 * nu
                    den = nu_new / float(bc2)
                    if self.amsgrad:
                        den = torch.maximum(st["nu_max"], den)
                        st["nu_max"].copy_(den)
                    upd = (mu_new / float(bc1)) / (torch.sqrt(den) + eps)
                mu.copy_(mu_new)
                nu.copy_(nu_new)
                if wd and self.decoupled:
                    upd = upd + wd * p
                p.add_(upd.to(p.dtype), alpha=-group["lr"])
        return loss


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
    """``mu_dtype``/``nu_dtype`` (torch dtypes: the JAX package's
    moment-memory knobs) and ``amsgrad`` make Adam an :class:`OptaxAdam`,
    as do ``mu_dtype``/``nu_dtype`` for AdamW. Only ``"adam"`` reads
    ``amsgrad``: the JAX package's AdamW ignores it, and so does this one;
    SGD ignores the moment dtypes. ``amsgrad`` with ``nu_dtype`` raises."""
    name = name.lower()
    params = list(params)
    if name == "sgd":
        return torch.optim.SGD(params, lr=lr, momentum=momentum,
                               weight_decay=weight_decay)
    if name not in ("adam", "adamw"):
        raise NotImplementedError(f"Optimizer {name!r}")
    decoupled = name == "adamw"
    amsgrad = amsgrad and not decoupled
    if amsgrad or mu_dtype is not None or nu_dtype is not None:
        return OptaxAdam(params, lr, (beta1, beta2), eps, weight_decay,
                         decoupled=decoupled, amsgrad=amsgrad,
                         mu_dtype=mu_dtype, nu_dtype=nu_dtype)
    opt = torch.optim.AdamW if decoupled else torch.optim.Adam
    return opt(params, lr=lr, betas=(beta1, beta2), eps=eps,
               weight_decay=weight_decay)


def build_reference_optimizer(cfg, params: Iterable[torch.nn.Parameter],
                              mu_dtype=None,
                              nu_dtype=None) -> torch.optim.Optimizer:
    """From a reference-schema ``optim`` config section
    (DDPM/functions/__init__.py get_optimizer parity). ``mu_dtype`` /
    ``nu_dtype`` are the memory-policy knobs (halve the Adam moments;
    amsgrad with ``nu_dtype`` raises, see :class:`OptaxAdam`)."""
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
