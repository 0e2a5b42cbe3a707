"""SFR-on: the fast-slow two-phase unlearning step.

Port of ``uurg_tpu/unlearn/sfron.py``. Per iteration:

  [every forget_freq steps]  FORGET: grads of alpha(step) * forget_loss,
                             multiplied by the saliency mask, clipped,
                             applied through the shared optimizer
  [every step]               REMAIN: grads of remain_alpha * remain_loss,
                             optionally clipped, applied
  [every step]               EMA shadow update and/or fast-slow mixing

``method="joint"`` (the paper's ablation) combines both losses into one
masked update per step, masking the combined gradient as the JAX package
does.

Where the JAX step is one jitted pure function of a state pytree, this one
runs eagerly and updates the state's model, optimizer and EMA model in
place. Gradients are the parameters' ``.grad`` tensors: every parameter
holds one from :func:`init_state` on, zeroed before each phase, so that
``torch.optim`` (which skips a parameter whose ``.grad`` is None, where
optax updates every leaf) ticks every Adam moment on every phase, for
example ``null_classes_emb`` when a batch keeps every label. One optimizer
serves both phases, so Adam's step count rises twice per iteration. The
weighted gradient of a phase is taken as the gradient of the loss times its
weight (alpha, remain_alpha, 1/grad_accum), which equals the JAX package's
scaled gradient in exact arithmetic.

Mutable model state (BatchNorm running statistics, the JAX
``has_model_state``) lives in the model's buffers: a loss function that
runs the model in train mode moves them in place, so the forget phase moves
them only on the steps where it runs and the remain phase then moves them
again, as the JAX step threads them through its ``lax.cond``. The fast-slow
mix touches parameters only.

Under data parallel every rank runs the step on its rows of the global
batch and, after each phase's backward and before the mask, the gradients
are averaged over the state's ``group`` in one flat all-reduce (the twin of
the loss-mean psum that pjit inserts), the phase's loss with them. Under
FSDP the sharded parameters' gradients come reduced from FSDP2's reduce-
scatter and only the whole ones are averaged here; under tensor parallel
every rank of the ``model`` axis holds the gradient of its shards (and the
same whole gradients), which are averaged over the ``data`` group alone
(the state's ``group``); the mask, the clip and the EMA then run shard by
shard, the clip's norm summing each shard once. ``make_sfron_scan`` (many
steps per device dispatch, for a slow host link) is not ported: the
classification method loops over this step with batches drawn on the
device
(:func:`uurg_torch.unlearn.methods.classification.device_batcher`).
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Any, Callable, Iterable, Optional

import torch

from uurg_torch.core import tree as tr
from uurg_torch.diffusion.losses import cosine_alpha_decay, linear_alpha_decay
from uurg_torch.parallel.mesh import (all_reduce_mean_, is_sharded, is_tp,
                                      local, zeros_like)
from uurg_torch.train.optim import set_lr
from uurg_torch.unlearn.ema import ema_update, fast_slow_mix

# loss_fn(model, batch, generator) -> scalar loss to MINIMIZE. Gradient-
# ascent methods pass a loss that is already negated.
LossFn = Callable[[torch.nn.Module, tuple, torch.Generator], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class SFRonConfig:
    n_iters: int
    forget_alpha: float
    remain_alpha: float = 1.0
    alpha_sched: str = "cosine"        # cosine | linear | expdecay | const
    forget_freq: int = 1               # forget step every N iters (cls: 5)
    forget_clip: Optional[float] = 1.0
    remain_clip: Optional[float] = 1.0  # None = no clip (classification)
    method: str = "ron"                # ron | joint
    ema_mu: Optional[float] = None     # DDPM/DiT shadow-EMA rate
    fast_slow_beta: Optional[float] = None  # classification mixing beta
    grad_accum: int = 1                # microbatches accumulated per update


@dataclasses.dataclass
class SFRonState:
    """The model being unlearned, its optimizer, the EMA shadow model (or
    None), the step count and the saliency mask (``dict[str, Tensor]`` of
    0/1 or bool tensors or :class:`~uurg_torch.core.tree.PackedMask`, keyed
    by parameter name, or None) and the process group over which the
    gradients and losses are averaged (None on one device)."""

    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    ema_model: Optional[torch.nn.Module] = None
    step: int = 0
    mask: Optional[dict] = None
    group: Any = None


def init_state(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
               ema: bool = False, mask: Optional[dict] = None,
               ema_model: Optional[torch.nn.Module] = None,
               group: Any = None) -> SFRonState:
    """Give every parameter a zero ``.grad`` and, with ``ema``, copy the
    model into a frozen shadow in eval mode (it is sampled, never
    trained). A sharded model's shadow is made before sharding and passed
    as ``ema_model``, sharded as the model is."""
    names = [n for n, _ in model.named_parameters()]
    if mask is not None and set(mask) != set(names):
        raise ValueError("the mask's keys must be the model's parameter "
                         "names")
    if ema and ema_model is None:
        ema_model = make_shadow(model)
    for p in model.parameters():
        p.grad = zeros_like(p)
    return SFRonState(model=model, optimizer=optimizer, ema_model=ema_model,
                      mask=mask, group=group)


def make_shadow(model: torch.nn.Module) -> torch.nn.Module:
    """A frozen copy of ``model`` in eval mode, without gradients: the EMA
    shadow."""
    shadow = copy.deepcopy(model).requires_grad_(False).eval()
    for p in shadow.parameters():
        p.grad = None
    return shadow


def _alpha_at(cfg: SFRonConfig, step: int) -> float:
    if cfg.alpha_sched == "cosine":
        return cosine_alpha_decay(cfg.forget_alpha, step, cfg.n_iters)
    if cfg.alpha_sched == "linear":
        return linear_alpha_decay(cfg.forget_alpha, step, cfg.n_iters, 1.0)
    if cfg.alpha_sched == "expdecay":
        return linear_alpha_decay(cfg.forget_alpha, step, cfg.n_iters, 2.0)
    if cfg.alpha_sched == "const":
        return float(cfg.forget_alpha)
    raise NotImplementedError(cfg.alpha_sched)


def make_sfron_step(cfg: SFRonConfig, forget_loss_fn: Optional[LossFn],
                    remain_loss_fn: LossFn,
                    lr_schedule: Callable | None = None):
    """Build ``step_fn(state, forget_batch, remain_batch, generator) ->
    metrics``, which advances ``state`` in place. Batches are tuples of
    tensors; with ``grad_accum > 1`` each leaf carries a leading
    [grad_accum] axis (see :func:`stack_microbatches`). ``lr_schedule``
    (step -> lr) sets the learning rate before each step. ``forget_loss_fn``
    may be None when forgetting is statically off (``alpha_sched="const"``,
    ``forget_alpha=0``, ``method="ron"``)."""
    if cfg.method not in ("ron", "joint"):
        raise NotImplementedError(cfg.method)
    # Statically disabled forgetting (pretrain/retrain reuse this engine):
    # the phase is skipped, not fed zero gradients, which would still tick
    # Adam's count and decay its moments (a phantom update per step against
    # the reference's single optimizer.step(), DDPM/runners/diffusion.py
    # :138-158)
    forget_off = (cfg.method == "ron" and cfg.alpha_sched == "const"
                  and cfg.forget_alpha == 0.0)
    if forget_loss_fn is None and not forget_off:
        raise ValueError("forget_loss_fn is needed unless forgetting is off")
    n_accum = max(int(cfg.grad_accum), 1)

    def step_fn(state: SFRonState, forget_batch, remain_batch,
                generator: torch.Generator) -> dict:
        model, opt = state.model, state.optimizer
        params = dict(model.named_parameters())
        grads = {k: p.grad for k, p in params.items()}
        if any(g is None for g in grads.values()):
            raise ValueError("every parameter needs a .grad tensor: build the "
                             "state with init_state")
        cur_alpha = _alpha_at(cfg, state.step)
        if lr_schedule is not None:
            set_lr(opt, lr_schedule(state.step))
        prev = None
        if cfg.fast_slow_beta is not None and cfg.fast_slow_beta != 1.0:
            prev = [p.detach().clone() for p in params.values()]

        def accumulate(loss_fn, batch, weight: float) -> torch.Tensor:
            """Add weight * (the microbatch mean of d loss / d params) into
            .grad; return the mean loss."""
            mbs = [batch] if n_accum == 1 else [
                tuple(leaf[i] for leaf in batch) for i in range(n_accum)]
            total = 0.0
            for mb in mbs:
                loss = loss_fn(model, mb, generator)
                (loss * (weight / n_accum)).backward()
                total = total + loss.detach().float()
            return total / n_accum

        def zero_grads():
            torch._foreach_zero_([local(g) for g in grads.values()])

        whole = [local(grads[k]) for k, p in params.items()
                 if not is_sharded(p) or is_tp(p)]

        def reduce(*losses: torch.Tensor) -> list[torch.Tensor]:
            """Average the gradients FSDP does not reduce (the whole and
            the tensor-parallel ones) and the losses over the group, in
            one flat all-reduce."""
            if state.group is None:
                return list(losses)
            flat = torch.stack(losses).float()
            all_reduce_mean_(whole + [flat], state.group)
            return list(flat.unbind())

        def apply(clip) -> torch.Tensor:
            if clip is not None:
                norm = tr.clip_by_global_norm_(grads, clip)
            else:
                norm = tr.global_norm(grads)
            opt.step()
            return norm

        dev = next(iter(params.values())).device
        forget_loss = torch.zeros((), device=dev)
        if cfg.method == "ron":
            if not forget_off and state.step % cfg.forget_freq == 0:
                zero_grads()
                forget_loss, = reduce(accumulate(forget_loss_fn,
                                                 forget_batch, cur_alpha))
                if state.mask is not None:
                    tr.tree_mul_(grads, state.mask)
                apply(cfg.forget_clip)
            zero_grads()
            remain_loss, = reduce(accumulate(remain_loss_fn, remain_batch,
                                             cfg.remain_alpha))
            rnorm = apply(cfg.remain_clip)
        else:
            # joint: one update from the combined gradient at the same
            # params, masked as a whole
            zero_grads()
            forget_loss = accumulate(forget_loss_fn, forget_batch, cur_alpha)
            remain_loss = accumulate(remain_loss_fn, remain_batch,
                                     cfg.remain_alpha)
            forget_loss, remain_loss = reduce(forget_loss, remain_loss)
            if state.mask is not None:
                tr.tree_mul_(grads, state.mask)
            rnorm = apply(cfg.remain_clip)

        if prev is not None:
            fast_slow_mix(params.values(), prev, cfg.fast_slow_beta)
        if state.ema_model is not None:
            ema_update(state.ema_model.parameters(), params.values(),
                       cfg.ema_mu)
        state.step += 1
        return {"forget_loss": forget_loss, "remain_loss": remain_loss,
                "forget_alpha": cur_alpha, "remain_grad_norm": rnorm}

    return step_fn


def stack_microbatches(batches: Iterable, n: int):
    """Wrap a batch iterator for ``SFRonConfig.grad_accum=n``: each yield
    stacks ``n`` consecutive batches (tuples of tensors) along a new leading
    axis. A finite iterator's ragged tail is dropped."""
    batches = iter(batches)
    if n <= 1:
        yield from batches
        return
    while True:
        group = []
        for _ in range(n):
            try:
                group.append(next(batches))
            except StopIteration:
                return
        yield tuple(torch.stack(leaves) for leaves in zip(*group))
