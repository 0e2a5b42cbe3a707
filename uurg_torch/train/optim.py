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

``make_optimizer(..., capturable=True)`` gives the capture-safe forms that
a CUDA graph of SFR-on steps replays (:func:`uurg_torch.unlearn.sfron.
make_sfron_scan`): :class:`CapturableSGD` and :class:`CapturableAdam`.
Their learning rate is a 0-d float32 tensor on the parameters' device that
:func:`set_lr` writes in place, their step counts live on the device, and
a step reads nothing back to the host. Their arithmetic is torch.optim's
``foreach`` one but for the rounding of ``lr * update`` (two roundings
where SGD's ``add_(alpha=-lr)`` takes one; Adam's is torch's own
``capturable`` form, which torch runs on CUDA only). :class:`OptaxAdam`
keeps its count on the host and has no such form.
"""
from __future__ import annotations

import math
from typing import Iterable

import numpy as np
import torch

from uurg_torch.parallel.mesh import is_sharded, local


def cosine_annealing(base_lr: float, total_steps: int):
    """torch CosineAnnealingLR / reference cosine_lr_scheduler:
    lr(t) = base * (1 + cos(pi * t / T)) / 2."""

    def sched(step):
        return base_lr * (1.0 + math.cos(math.pi * step / total_steps)) / 2.0

    return sched


def set_lr(optimizer: torch.optim.Optimizer, lr) -> None:
    """Every group's learning rate to ``lr`` (a float, or a 0-d tensor for
    a capture-safe optimizer, whose device tensor is written in place)."""
    for group in optimizer.param_groups:
        if torch.is_tensor(group["lr"]):
            if torch.is_tensor(lr):
                group["lr"].copy_(lr)
            else:
                group["lr"].fill_(lr)
        else:
            group["lr"] = lr


def _lr_tensors(optimizer: torch.optim.Optimizer) -> None:
    """Each group's learning rate as its own 0-d float32 tensor on the
    device of the group's parameters."""
    for group in optimizer.param_groups:
        group["lr"] = torch.tensor(float(group["lr"]), dtype=torch.float32,
                                   device=group["params"][0].device)


class CapturableSGD(torch.optim.Optimizer):
    """torch's SGD (momentum, coupled weight decay ``grad += wd * p``,
    no dampening) as multi-tensor ops whose learning rate is a device
    tensor: ``p -= lr * buf``. The first step of a parameter sets its
    buffer to the gradient, as torch's does."""

    def __init__(self, params, lr: float, momentum: float = 0.0,
                 weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, momentum=momentum,
                                      weight_decay=weight_decay))
        _lr_tensors(self)

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            grads = [p.grad for p in params]
            if group["weight_decay"]:
                grads = torch._foreach_add(grads, params,
                                           alpha=group["weight_decay"])
            if group["momentum"]:
                states = [self.state[p] for p in params]
                if all("momentum_buffer" in st for st in states):
                    bufs = [st["momentum_buffer"] for st in states]
                    torch._foreach_mul_(bufs, group["momentum"])
                    torch._foreach_add_(bufs, grads)
                else:
                    bufs = []
                    for st, g in zip(states, grads):
                        if "momentum_buffer" in st:
                            st["momentum_buffer"].mul_(
                                group["momentum"]).add_(g)
                        else:
                            st["momentum_buffer"] = g.detach().clone()
                        bufs.append(st["momentum_buffer"])
                grads = bufs
            torch._foreach_sub_(params, torch._foreach_mul(grads,
                                                           group["lr"]))
        return loss


class CapturableAdam(torch.optim.Optimizer):
    """torch's Adam (``decoupled``: AdamW) in torch's own ``capturable``
    multi-tensor form, which torch.optim runs only on CUDA: a float32 step
    count a parameter on its device, the bias corrections and the step
    size ``lr / (1 - b1 ** t)`` computed there."""

    def __init__(self, params, lr: float, betas=(0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 0.0, *,
                 decoupled: bool = False):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps,
                                      weight_decay=weight_decay))
        self.decoupled = decoupled
        _lr_tensors(self)

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            b1, b2 = group["betas"]
            lr, wd = group["lr"], group["weight_decay"]
            grads = [p.grad for p in params]
            for p in params:
                st = self.state[p]
                if not st:
                    st["step"] = torch.zeros((), dtype=torch.float32,
                                             device=p.device)
                    st["exp_avg"] = torch.zeros_like(
                        p, memory_format=torch.preserve_format)
                    st["exp_avg_sq"] = torch.zeros_like(
                        p, memory_format=torch.preserve_format)
            states = [self.state[p] for p in params]
            steps = [st["step"] for st in states]
            mus = [st["exp_avg"] for st in states]
            nus = [st["exp_avg_sq"] for st in states]
            torch._foreach_add_(steps, 1)
            if wd and self.decoupled:
                torch._foreach_mul_(params, 1 - lr * wd)
            elif wd:
                grads = torch._foreach_add(grads, params, alpha=wd)
            torch._foreach_lerp_(mus, grads, 1 - b1)
            torch._foreach_mul_(nus, b2)
            torch._foreach_addcmul_(nus, grads, grads, 1 - b2)
            # step_size = -lr / (1 - b1 ** t), bc2 = sqrt(1 - b2 ** t)
            step_size = torch._foreach_pow(b1, steps)
            bc2 = torch._foreach_pow(b2, steps)
            torch._foreach_sub_(step_size, 1)
            torch._foreach_sub_(bc2, 1)
            torch._foreach_neg_(bc2)
            torch._foreach_div_(step_size, lr)
            torch._foreach_reciprocal_(step_size)
            torch._foreach_sqrt_(bc2)
            den = torch._foreach_sqrt(nus)
            torch._foreach_div_(den, bc2)
            torch._foreach_add_(den, group["eps"])
            torch._foreach_div_(den, step_size)
            torch._foreach_addcdiv_(params, mus, den)
        return loss


def is_capturable(optimizer: torch.optim.Optimizer) -> bool:
    """Whether a CUDA graph can replay ``optimizer.step()``."""
    return isinstance(optimizer, (CapturableSGD, CapturableAdam))


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
    with ``amsgrad``, ``nu_max``, placed as the parameter is (an FSDP
    parameter's moments are sharded like it and updated shard by
    shard)."""

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
            for param in group["params"]:
                if param.grad is None:
                    continue
                p, g = local(param), local(param.grad).float()
                st = self.state[param]
                if not st:
                    st["step"] = 0
                    st["mu"] = torch.zeros_like(param, dtype=self.mu_dtype
                                                or p.dtype)
                    st["nu"] = torch.zeros_like(param, dtype=self.nu_dtype
                                                or p.dtype)
                    if self.amsgrad:
                        st["nu_max"] = torch.zeros_like(param)
                if wd and not self.decoupled:
                    g = g + wd * p
                st["step"] += 1
                bc1, bc2 = _bias_corrections(b1, b2, st["step"])
                mu, nu = local(st["mu"]), local(st["nu"])
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
                        den = torch.maximum(local(st["nu_max"]), den)
                        local(st["nu_max"]).copy_(den)
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
    capturable: bool = False,
) -> torch.optim.Optimizer:
    """``mu_dtype``/``nu_dtype`` (torch dtypes: the JAX package's
    moment-memory knobs) and ``amsgrad`` make Adam an :class:`OptaxAdam`,
    as do ``mu_dtype``/``nu_dtype`` for AdamW. Only ``"adam"`` reads
    ``amsgrad``: the JAX package's AdamW ignores it, and so does this one;
    SGD ignores the moment dtypes. ``amsgrad`` with ``nu_dtype`` raises.
    ``capturable`` gives :class:`CapturableSGD` or :class:`CapturableAdam`
    over whole parameters; an optimizer that would be an
    :class:`OptaxAdam` raises ValueError."""
    name = name.lower()
    params = list(params)
    if name not in ("sgd", "adam", "adamw"):
        raise NotImplementedError(f"Optimizer {name!r}")
    decoupled = name == "adamw"
    amsgrad = amsgrad and not decoupled
    optax_rule = name != "sgd" and (amsgrad or mu_dtype is not None
                                    or nu_dtype is not None)
    if capturable:
        if optax_rule:
            raise ValueError(
                "OptaxAdam (mu_dtype, nu_dtype, amsgrad) keeps its step "
                "count on the host and has no capture-safe form")
        if any(is_sharded(p) for p in params):
            raise ValueError("the capture-safe optimizers take whole "
                             "parameters on one device")
        if name == "sgd":
            return CapturableSGD(params, lr, momentum, weight_decay)
        return CapturableAdam(params, lr, (beta1, beta2), eps, weight_decay,
                              decoupled=decoupled)
    if name == "sgd":
        return _torch_optimizer(torch.optim.SGD, params, lr=lr,
                                momentum=momentum, weight_decay=weight_decay)
    if optax_rule:
        return OptaxAdam(params, lr, (beta1, beta2), eps, weight_decay,
                         decoupled=decoupled, amsgrad=amsgrad,
                         mu_dtype=mu_dtype, nu_dtype=nu_dtype)
    opt = torch.optim.AdamW if decoupled else torch.optim.Adam
    return _torch_optimizer(opt, params, lr=lr, betas=(beta1, beta2),
                            eps=eps, weight_decay=weight_decay)


def _mesh_of(p) -> object:
    """A parameter's device mesh when it is sharded (FSDP's, tensor
    parallel's), else None."""
    return p.device_mesh if is_sharded(p) else None


def _torch_optimizer(cls, params: list, **kw) -> torch.optim.Optimizer:
    """``cls(params, **kw)``; over a mix of whole parameters and DTensors
    (FSDP's, tensor parallel's, on their meshes), one whose step runs its
    multi-tensor kernels on each kind apart (a ``_foreach`` op takes no
    list that mixes them; on the card torch.optim steps with them)."""
    kinds = list(dict.fromkeys(_mesh_of(p) for p in params))
    if len(kinds) < 2:
        return cls(params, **kw)

    class ByPlacement(cls):
        def step(self, closure=None):
            groups = self.param_groups
            self.param_groups = [
                dict(g, params=[p for p in g["params"]
                                if _mesh_of(p) == kind])
                for g in groups for kind in kinds]
            try:
                return super().step(closure)
            finally:
                self.param_groups = groups

    ByPlacement.__name__ = ByPlacement.__qualname__ = cls.__name__
    return ByPlacement(params, **kw)


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
