"""Host-side SD runners (the reference's SD/train-scripts).

Port of ``uurg_tpu/workloads/sd_runner.py``: ``nsfw_removal`` runs the
shared SFR-on engine (the two-phase masked update); ``train_esd``,
``certain_label``, ``gradient_ascent`` and ``proximal_gradient`` are
single-loss loops with their own batches.
``encode_image_folder`` pre-encodes the data: the SD losses take latents
and contexts from the frozen VAE and text encoder.

Every runner trains the :class:`~uurg_torch.models.sd_unet.SDUNet` it is
given in place and draws from a generator on the workload's device seeded
from ``(seed, step)`` (:func:`~uurg_torch.core.rng.step_seed`). The
``train_method`` subset (``train_method_leaf_mask``) is the only part the
optimizer holds: frozen parameters get no update and no Adam state, as
``optax.set_to_zero`` gives in JAX. ``nsfw_removal`` runs data parallel,
FSDP, tensor parallel and ring attention on a ``DeviceMesh``
(:mod:`uurg_torch.parallel`).
"""
from __future__ import annotations

import contextlib
import copy
import logging
from typing import Callable, Iterator, Sequence

import numpy as np
import torch

from uurg_torch.core import tree as tr
from uurg_torch.core.device import refuse_multi_device
from uurg_torch.core.rng import step_seed
from uurg_torch.models.sd_unet import SDUNet, train_method_leaf_mask
from uurg_torch.parallel.mesh import (SD_TP_RULES, data_group, place_like,
                                      place_model, require_axis, shard_batch,
                                      split_batches)
from uurg_torch.parallel.sequence import sequence_parallel
from uurg_torch.train.optim import make_optimizer
from uurg_torch.unlearn.sfron import (SFRonConfig, SFRonState, init_state,
                                      make_sfron_step, stack_microbatches)
from uurg_torch.workloads import ddpm_runner
from uurg_torch.workloads.sd import SDWorkload

log = logging.getLogger("uurg_torch.sd")


def _method_optimizer(model: SDUNet, train_method: str, lr: float,
                      nu_dtype: torch.dtype | None = None
                      ) -> torch.optim.Optimizer:
    """Adam (first moment in bf16, second in ``nu_dtype``) over the
    ``train_method`` subset only (SD/train-scripts/nsfw_removal.py:67-81);
    ``"full"`` is Adam over every parameter."""
    trained = train_method_leaf_mask(model, train_method)
    return make_optimizer(
        "adam", [p for n, p in model.named_parameters() if trained[n]], lr,
        mu_dtype=torch.bfloat16, nu_dtype=nu_dtype)


@contextlib.contextmanager
def _frozen_outside(model: SDUNet, train_method: str):
    """``requires_grad_(False)`` on the parameters ``train_method`` does
    not train, so that their gradients are never computed; restored on
    exit."""
    trained = train_method_leaf_mask(model, train_method)
    params = dict(model.named_parameters())
    before = {n: p.requires_grad for n, p in params.items()}
    for n, p in params.items():
        p.requires_grad_(trained[n])
    try:
        yield
    finally:
        for n, p in params.items():
            p.requires_grad_(before[n])


def _place(batch, device: torch.device):
    """A batch (nested tuples of arrays or tensors) on ``device``."""
    if isinstance(batch, (tuple, list)):
        return tuple(_place(b, device) for b in batch)
    return torch.as_tensor(batch, device=device)


def encode_image_folder(wl: SDWorkload, images: np.ndarray,
                        prompts: Sequence[str], generator: torch.Generator,
                        batch_size: int = 8
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """(z, context) on the workload's device: [-1, 1] NHWC images encoded
    ``batch_size`` at a time (a posterior draw from ``generator``) and the
    prompts embedded, both under ``torch.inference_mode`` and returned as
    ordinary tensors, which autograd may save."""
    zs = []
    with torch.inference_mode():
        for i in range(0, len(images), batch_size):
            x = torch.from_numpy(np.ascontiguousarray(
                images[i:i + batch_size], np.float32)).to(wl.device)
            zs.append(wl.vae.encode(x, generator=generator))
        z = torch.cat(zs)
        ctx = wl.get_learned_conditioning(prompts)
    return z.clone(), ctx.clone()


def nsfw_removal(
    wl: SDWorkload,
    model: SDUNet,
    forget_batches: Iterator,   # yields (z_nude, ctx_nude, ctx_clothed)
    remain_batches: Iterator,   # yields (z_clothed, ctx_clothed)
    *,
    n_iters: int = 1000,
    lr: float = 1e-5,
    train_method: str = "full",
    saliency_mask: dict | None = None,
    forget_alpha: float = 1.0,
    remain_alpha: float = 1.0,
    seed: int = 0,
    snapshot_hook: Callable | None = None,
    snapshot_freq: int = 200,
    mesh=None,
    parallelism: str = "dp",
    grad_accum: int = 1,
    nu_dtype: torch.dtype | None = None,
    pack_mask: bool = False,
) -> SFRonState:
    """SFR-on concept erasure (SD/train-scripts/nsfw_removal.py:38-214):
    the masked forget step on the nsfw forget loss, then the remain step,
    each through one Adam over the ``train_method`` subset, at constant
    alphas and without clipping. ``saliency_mask`` (0/1, bool or
    :class:`PackedMask` leaves keyed by parameter name) multiplies the
    forget gradients, bit-packed on the device with ``pack_mask``.
    ``snapshot_hook(model, i)`` fires every ``snapshot_freq`` steps.

    Every parameter keeps its gradient, the frozen ones too, so the
    reported ``remain_grad_norm`` is over the gradients JAX's is over; the
    optimizer holds the trained ones only. Returns the engine's state (the
    model, updated in place, and its optimizer).

    With a ``mesh`` (every rank of the group calls with the same global
    batches) each rank takes its rows over the ``data`` axis and draws the
    global batch's randomness; ``parallelism="fsdp"`` shards the UNet, the
    Adam moments and a dense mask alike (a packed mask stays whole), and
    ``"tp"`` places them alike by :data:`SD_TP_RULES` over the ``model``
    axis, FSDP over the same axis taking the convolutions, norms and
    embeddings as JAX's ``fallback="fsdp"`` does; ``"sp"`` runs every
    self-attention that reaches the dispatcher (T % 128 == 0) as ring
    attention over the ``seq`` axis, the cross-attention over the text's 77
    tokens staying local. Under a mesh, ``sp`` without a ``seq`` axis
    raises JAX's ``ValueError``, and ``pp`` its "unknown parallelism" (the
    JAX runner has no pipeline for the UNet); without a mesh every mode
    runs as one device.
    ``snapshot_hook`` runs on every rank."""
    refuse_multi_device(parallelism)
    if mesh is not None:
        if parallelism == "pp":
            raise ValueError(f"unknown parallelism {parallelism!r}")
        require_axis(mesh, parallelism)
    dev = wl.device
    place_model(model, mesh, parallelism, SD_TP_RULES, tp_fallback="fsdp")
    opt = _method_optimizer(model, train_method, lr, nu_dtype=nu_dtype)
    mask = None
    if saliency_mask is not None:
        mask = place_like(ddpm_runner._device_mask(saliency_mask, dev,
                                                   pack_mask), model)
    cfg = SFRonConfig(n_iters=n_iters, forget_alpha=forget_alpha,
                      remain_alpha=remain_alpha, alpha_sched="const",
                      forget_clip=None, remain_clip=None,
                      grad_accum=grad_accum)
    step = make_sfron_step(cfg, wl.nsfw_forget_loss_fn(),
                           wl.shared_step_loss)
    forget_batches = (_place(b, dev) for b in forget_batches)
    remain_batches = (_place(b, dev) for b in remain_batches)
    if grad_accum > 1:  # effective batch = grad_accum x batch size
        forget_batches = stack_microbatches(forget_batches, grad_accum)
        remain_batches = stack_microbatches(remain_batches, grad_accum)
    state = init_state(model, opt, mask=mask, group=data_group(mesh))
    batch_dim = 1 if grad_accum > 1 else 0
    gen = torch.Generator(device=dev)
    sp = (sequence_parallel(mesh) if mesh is not None and parallelism == "sp"
          else contextlib.nullcontext())
    with split_batches(mesh), sp:
        for i in range(n_iters):
            fb = shard_batch(next(forget_batches), mesh, batch_dim=batch_dim)
            rb = shard_batch(next(remain_batches), mesh, batch_dim=batch_dim)
            gen.manual_seed(step_seed(seed, i))
            metrics = step(state, fb, rb, gen)
            if (i + 1) % snapshot_freq == 0:
                log.info("step %d forget %.4f remain %.4f", i,
                         float(metrics["forget_loss"]),
                         float(metrics["remain_loss"]))
                if snapshot_hook is not None:
                    snapshot_hook(model, i)
    return state


def _single_loss_loop(wl: SDWorkload, model: SDUNet, loss_fn: Callable,
                      batches, *, n_iters: int, lr: float,
                      train_method: str = "full", seed: int = 0,
                      prox: Callable | None = None,
                      saliency_mask: dict | None = None,
                      loss_sink: Callable | None = None) -> SDUNet:
    """One loss a step through Adam over the ``train_method`` subset (the
    rest frozen with ``requires_grad_(False)`` while the loop runs).
    ``batches`` is an iterator of ready batches or a callable ``(model,
    generator) -> batch`` for methods whose data depends on the current
    model (ESD's partial denoise); the step's loss then draws from the same
    generator. ``saliency_mask`` multiplies the gradients before the
    update (train-esd.py:319-324), ``prox(model)`` runs after it and
    ``loss_sink(step, loss)`` gets each loss."""
    dev = wl.device
    mask = None
    if saliency_mask is not None:
        mask = ddpm_runner._device_mask(saliency_mask, dev)
    opt = _method_optimizer(model, train_method, lr)
    gen = torch.Generator(device=dev)
    with _frozen_outside(model, train_method):
        trained = [(n, p) for n, p in model.named_parameters()
                   if p.requires_grad]
        for i in range(n_iters):
            gen.manual_seed(step_seed(seed, i))
            batch = (batches(model, gen) if callable(batches)
                     else next(batches))
            opt.zero_grad(set_to_none=False)
            loss = loss_fn(model, _place(batch, dev), gen)
            loss.backward()
            if mask is not None:
                tr.tree_mul_({n: p.grad for n, p in trained}, mask)
            opt.step()
            if prox is not None:
                prox(model)
            if loss_sink is not None:
                loss_sink(i, loss.detach())
    return model


class ESDBatchBuilder:
    """ESD's training batches (train-esd.py:266-301): a call ``(model,
    generator) -> (z_t, t_ddpm, ctx_concept, ctx_empty)`` draws a DDIM
    index ``t_enc`` in [0, ddim_steps), a DDPM timestep uniform in t_enc's
    bucket ``[t_enc T / S, (t_enc + 1) T / S)`` and a start code x_T, all
    in :meth:`draw` (which tests replace), and partially denoises x_T with
    the *current* model through the workload's quick sampler at
    ``start_guidance``, under ``no_grad`` (the host runs the denoise's
    ``t_enc``-dependent length as a loop)."""

    def __init__(self, wl: SDWorkload, ctx_concept: torch.Tensor,
                 ctx_empty: torch.Tensor, *, ddim_steps: int = 50,
                 start_guidance: float = 3.0, latent_size: int = 64,
                 batch_size: int = 1):
        self.wl, self.ddim_steps = wl, ddim_steps
        self.latent_size, self.batch_size = latent_size, batch_size
        self.quick = wl.make_quick_sampler(ddim_steps=ddim_steps,
                                           start_guidance=start_guidance)
        shape = (batch_size,) + tuple(ctx_concept.shape[-2:])
        self.ctx_c = torch.as_tensor(ctx_concept, device=wl.device) \
            .expand(shape)
        self.ctx_0 = torch.as_tensor(ctx_empty, device=wl.device) \
            .expand((batch_size,) + tuple(ctx_empty.shape[-2:]))

    def draw(self, generator: torch.Generator
             ) -> tuple[int, torch.Tensor, torch.Tensor]:
        """(t_enc as a host int, t_ddpm (batch,), x_T NHWC)."""
        dev, T = self.wl.device, self.wl.schedule.num_timesteps
        t_enc = int(torch.randint(0, self.ddim_steps, (), generator=generator,
                                  device=dev))
        lo = t_enc * T // self.ddim_steps
        hi = (t_enc + 1) * T // self.ddim_steps
        t_ddpm = torch.randint(lo, hi, (self.batch_size,),
                               generator=generator, device=dev)
        x_T = torch.randn((self.batch_size, self.latent_size,
                           self.latent_size, 4), generator=generator,
                          device=dev)
        return t_enc, t_ddpm, x_T

    def __call__(self, model: SDUNet, generator: torch.Generator) -> tuple:
        t_enc, t_ddpm, x_T = self.draw(generator)
        z = self.quick(model, self.ctx_c, self.ctx_0, x_T, t_enc)
        return z, t_ddpm, self.ctx_c, self.ctx_0


def esd_batch_builder(wl: SDWorkload, ctx_concept, ctx_empty, *,
                      ddim_steps: int = 50, start_guidance: float = 3.0,
                      latent_size: int = 64,
                      batch_size: int = 1) -> ESDBatchBuilder:
    """The :class:`ESDBatchBuilder` of these settings."""
    return ESDBatchBuilder(wl, ctx_concept, ctx_empty, ddim_steps=ddim_steps,
                           start_guidance=start_guidance,
                           latent_size=latent_size, batch_size=batch_size)


def train_esd(wl: SDWorkload, model: SDUNet, batches, *,
              n_iters: int = 1000, lr: float = 1e-5,
              train_method: str = "xattn", negative_guidance: float = 1.0,
              seed: int = 0, saliency_mask: dict | None = None) -> SDUNet:
    """ESD erasure (SD/train-scripts/train-esd.py:129-340). ``batches``
    yields (z_t, t, ctx_concept, ctx_empty); pass an
    :class:`ESDBatchBuilder` (it sees the current model) for the
    reference's partial-denoise training distribution. The frozen base
    model is a copy of ``model`` on the same device."""
    frozen = copy.deepcopy(model).requires_grad_(False)
    return _single_loss_loop(
        wl, model, wl.esd_loss_fn(frozen, negative_guidance), batches,
        n_iters=n_iters, lr=lr, train_method=train_method, seed=seed,
        saliency_mask=saliency_mask)


def certain_label(wl: SDWorkload, model: SDUNet, forget_batches,
                  remain_batches, *, n_iters: int = 1000, lr: float = 1e-5,
                  seed: int = 0, remain_alpha: float = 1.0,
                  train_method: str = "full") -> SDUNet:
    """Random/certain-label erasure (SD/train-scripts/random_label.py:
    13-155): the forget prompt's eps toward the pseudo prompt's plus
    ``remain_alpha`` times the remain loss, one update a step; the forget
    term draws first, the remain term second, from one generator."""
    rl = wl.rl_forget_loss_fn()

    def combined(m, batch, generator):
        fb, rb = batch
        return rl(m, fb, generator) + remain_alpha * wl.shared_step_loss(
            m, rb, generator)

    return _single_loss_loop(wl, model, combined,
                             zip(forget_batches, remain_batches),
                             n_iters=n_iters, lr=lr,
                             train_method=train_method, seed=seed)


def gradient_ascent(wl: SDWorkload, model: SDUNet, forget_batches,
                    remain_batches, *, n_iters: int = 1000, lr: float = 1e-5,
                    remain_alpha: float = 1.0, seed: int = 0,
                    train_method: str = "full") -> SDUNet:
    """-shared_step(forget) + alpha shared_step(remain)
    (SD/train-scripts/gradient_ascent.py:14-123)."""
    return _single_loss_loop(wl, model, wl.ga_loss_fn(remain_alpha),
                             zip(forget_batches, remain_batches),
                             n_iters=n_iters, lr=lr,
                             train_method=train_method, seed=seed)


def proximal_gradient(wl: SDWorkload, model: SDUNet, forget_batches,
                      remain_batches, *, n_iters: int = 1000,
                      lr: float = 1e-5, remain_alpha: float = 1.0,
                      top_ratio: float = 0.01, seed: int = 0) -> SDUNet:
    """The gradient-ascent loss over every parameter, then each step the
    L1 prox that shrinks the move from the starting weights
    (SD/train-scripts/proximal_gradient.py:18-197)."""
    prox = wl.make_prox_operator(model, top_ratio)
    return _single_loss_loop(wl, model, wl.ga_loss_fn(remain_alpha),
                             zip(forget_batches, remain_batches),
                             n_iters=n_iters, lr=lr, seed=seed, prox=prox)
