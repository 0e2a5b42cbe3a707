"""Host-side DiT runners: class forgetting, Fisher, masks and the sample
grid.

Port of ``uurg_tpu/workloads/dit_runner.py``: ``dit_forget``
(DiT/forget.py:151-361, SFR-on with the EMA shadow), ``dit_generate_fisher``
(DiT/generate_fisher.py:131-317), ``dit_generate_mask``
(DiT/generate_mask.py:16-57), ``dit_sample_grid`` (the snapshot sample
sheets of DiT/forget.py:344-345) and ``dit_sample_fid`` (DiT/sample.py and
DiT/sample_ddp.py: class-conditional samples, decoded by the VAE).
``dit_forget`` runs data parallel, FSDP, tensor parallel, the pipeline and
ring attention on a ``DeviceMesh`` (:mod:`uurg_torch.parallel`).

Checkpoints are ``torch.save`` files in the reference DiT layout
(:mod:`uurg_torch.io.dit_interop`): ``<ckpt_dir>/ckpt_{i:07d}.pt`` and
``final.pt`` as ``{"model": sd, "ema": sd}``, which the port's and the JAX
package's ``load_dit_reference_checkpoint`` both read, and
``train_state.pt`` (step, model, optimizer, EMA), from which a run resumes.
Fishers and masks are the port's files of named tensors
(:mod:`uurg_torch.io.checkpoint`) keyed by the reference parameter names.
"""
from __future__ import annotations

import contextlib
import logging
import os
import time
from typing import Callable, Iterable, Iterator

import numpy as np
import torch

from uurg_torch.core.device import refuse_multi_device
from uurg_torch.core.rng import step_seed
from uurg_torch.io.checkpoint import save_checkpoint
from uurg_torch.io.dit_interop import save_dit_checkpoint
from uurg_torch.models.dit import DiT
from uurg_torch.parallel.dist import rank, sync_global_devices, world_size
from uurg_torch.parallel.mesh import (DIT_TP_RULES, STAGE, data_group,
                                      full_optimizer_state, full_state_dict,
                                      mesh_shape, place_like, place_model,
                                      require_axis, shard_batch,
                                      shard_optimizer_state, split_batches)
from uurg_torch.parallel.pipeline import dit_apply_pipelined
from uurg_torch.parallel.sequence import sequence_parallel
from uurg_torch.train.optim import make_optimizer
from uurg_torch.unlearn.fisher import accumulate_fisher
from uurg_torch.unlearn.sfron import (SFRonConfig, SFRonState, init_state,
                                      make_shadow, make_sfron_step,
                                      stack_microbatches)
from uurg_torch.workloads import ddpm_runner
from uurg_torch.workloads.dit import DiTWorkload

log = logging.getLogger("uurg_torch.dit")


def device_batch(batch, device: torch.device):
    """(latents, labels) from the host or the device -> float32 latents and
    int64 labels on ``device``."""
    x, y = batch
    return (torch.as_tensor(x).to(device=device, dtype=torch.float32),
            torch.as_tensor(y).to(device=device, dtype=torch.int64))


def _save_train_state(path: str, state: SFRonState) -> None:
    """Step, model, optimizer and EMA as whole tensors in the one-device
    layout (gathered under FSDP and tensor parallel, which every rank
    calls), written by rank 0."""
    payload = {"step": int(state.step),
               "model": full_state_dict(state.model),
               "optimizer": full_optimizer_state(state.optimizer),
               "ema": full_state_dict(state.ema_model)}
    if rank() != 0:
        return
    tmp = f"{path}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def _load_train_state(path: str, model: DiT, ema_model: DiT) -> dict:
    """Model and EMA from a whole train state, before any sharding; the
    checkpoint (its ``optimizer`` and ``step``) is returned for the
    optimizer built after."""
    ck = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(ck["model"], strict=True)
    ema_model.load_state_dict(ck["ema"], strict=True)
    return ck


def dit_forget(
    wl: DiTWorkload,
    model: DiT,
    forget_batches: Iterator,   # yields (latents, labels), pre-encoded
    remain_batches: Iterator,
    *,
    n_iters: int = 600,
    lr: float = 1e-4,
    forget_alpha: float = 1e-3,
    remain_alpha: float = 1.0,
    unlearn_loss: str = "ga",
    method: str = "ron",
    label_to_forget: int = 0,
    mask: dict | None = None,
    ema_decay: float = 0.9999,
    decay_forget_alpha: bool = False,
    grad_clip: float | None = 1.0,
    seed: int = 0,
    log_freq: int = 100,
    ckpt_dir: str | None = None,
    ckpt_freq: int = 10000,
    sample_hook: Callable | None = None,
    snapshot_freq: int = 500,
    mesh=None,
    parallelism: str = "dp",
    pp_microbatches: int | None = None,
    grad_accum: int = 1,
    mu_dtype: torch.dtype | None = None,
    nu_dtype: torch.dtype | None = None,
    pack_mask: bool = False,
) -> SFRonState:
    """SFR-on for DiT (DiT/forget.py:256-345): masked ascent on the forget
    batch (gradients clipped at ``grad_clip``), remain descent (unclipped),
    both through one AdamW (weight decay 0, moments in ``mu_dtype`` /
    ``nu_dtype``), then the EMA shadow ``ema = decay * ema + (1 - decay) *
    params``, every step. ``forget_alpha`` cosine-decays only with
    ``decay_forget_alpha``. ``mask`` is the saliency mask keyed by
    parameter name (0/1, bool or :class:`PackedMask` leaves), bit-packed
    on the device with ``pack_mask``. ``sample_hook(state, step)`` fires
    every ``snapshot_freq`` steps. ``model`` is updated in place; the
    returned state holds it, the optimizer and the EMA model. With
    ``ckpt_dir`` the run resumes from its ``train_state.pt`` when one is
    there. Batches are placed on the workload's device; the generator of
    step i is seeded from ``(seed, i)``.

    With a ``mesh`` (every rank of the group calls with the same global
    batches) each rank takes its rows over the ``data`` axis (dimension 1
    of ``grad_accum`` stacks) and draws the global batch's randomness;
    ``parallelism="fsdp"`` shards the parameters, the EMA, the Adam
    moments and a dense mask alike (a packed mask stays whole), and
    ``"tp"`` places them alike by :data:`DIT_TP_RULES` over the ``model``
    axis (the rest whole), ``"pp"`` keeps each stage's blocks, their EMA,
    moments and dense mask on that stage of the ``stage`` axis and runs
    every forward (the losses' and ``sample_hook``'s) through the
    pipeline in ``pp_microbatches`` (default: the stage count), and
    ``"sp"`` runs every attention as ring attention over the ``seq`` axis
    (the model whole). A mesh without the mode's axis raises JAX's
    ``ValueError``; without a mesh every mode runs as one device. The
    train state is read whole before sharding and written whole by rank
    0, as are the checkpoints."""
    refuse_multi_device(parallelism)
    if mesh is not None:
        require_axis(mesh, parallelism)
    dev = wl.device
    ema_model = make_shadow(model)
    ck, resume = None, None
    if ckpt_dir:
        os.makedirs(ckpt_dir, exist_ok=True)
        resume = os.path.join(ckpt_dir, "train_state.pt")
        if os.path.exists(resume):
            ck = _load_train_state(resume, model, ema_model)
    for m in (model, ema_model):
        place_model(m, mesh, parallelism, DIT_TP_RULES)
    opt = make_optimizer("adamw", model.parameters(), lr, weight_decay=0.0,
                         mu_dtype=mu_dtype, nu_dtype=nu_dtype)
    if mask is not None:
        mask = place_like(ddpm_runner._device_mask(mask, dev, pack_mask),
                          model)
    cfg = SFRonConfig(
        n_iters=n_iters, forget_alpha=forget_alpha,
        remain_alpha=remain_alpha,
        alpha_sched="cosine" if decay_forget_alpha else "const",
        forget_freq=1, forget_clip=grad_clip, remain_clip=None,
        method=method, ema_mu=ema_decay, grad_accum=grad_accum)
    step = make_sfron_step(cfg, wl.forget_loss_fn(unlearn_loss,
                                                  label_to_forget),
                           wl.train_loss_fn())
    batch_dim = 1 if grad_accum > 1 else 0
    forget_batches = (device_batch(b, dev) for b in forget_batches)
    remain_batches = (device_batch(b, dev) for b in remain_batches)
    if grad_accum > 1:  # effective batch = grad_accum x batch size
        forget_batches = stack_microbatches(forget_batches, grad_accum)
        remain_batches = stack_microbatches(remain_batches, grad_accum)
    state = init_state(model, opt, ema=True, mask=mask, ema_model=ema_model,
                       group=data_group(mesh))
    start_step = 0
    if ck is not None:
        opt.load_state_dict(shard_optimizer_state(ck["optimizer"], opt))
        state.step = start_step = int(ck["step"])
        log.info("resumed from %s at step %d", resume, start_step)
        del ck
    gen = torch.Generator(device=dev)
    model.train()
    start = time.time()
    with split_batches(mesh), _mode(wl, mesh, parallelism, pp_microbatches):
        for i in range(start_step, n_iters):
            fb = shard_batch(next(forget_batches), mesh, batch_dim=batch_dim)
            rb = shard_batch(next(remain_batches), mesh, batch_dim=batch_dim)
            gen.manual_seed(step_seed(seed, i))
            metrics = step(state, fb, rb, gen)
            if (i + 1) % log_freq == 0:
                log.info("step %d forget %.4f remain %.4f (%.2f steps/s)", i,
                         float(metrics["forget_loss"]),
                         float(metrics["remain_loss"]),
                         log_freq / (time.time() - start))
                start = time.time()
            if sample_hook is not None and (i + 1) % snapshot_freq == 0:
                sample_hook(state, i)
            if ckpt_dir and (i + 1) % ckpt_freq == 0:
                save_dit_checkpoint(
                    os.path.join(ckpt_dir, f"ckpt_{i:07d}.pt"), state.model,
                    state.ema_model)
                _save_train_state(resume, state)
                sync_global_devices("dit_ckpt")
    if ckpt_dir:
        save_dit_checkpoint(os.path.join(ckpt_dir, "final.pt"), state.model,
                            state.ema_model)
        sync_global_devices("dit_final")
    return state


def _mode(wl: DiTWorkload, mesh, parallelism: str,
          pp_microbatches: int | None):
    """The context of a run's loop: every forward of ``wl`` pipelined over
    the mesh's ``stage`` axis in ``pp_microbatches`` (default: the stage
    count) under ``pp``, every attention a ring over its ``seq`` axis under
    ``sp``; nothing without a mesh or under the other modes."""
    if mesh is None:
        return contextlib.nullcontext()
    if parallelism == "sp":
        return sequence_parallel(mesh)
    if parallelism == "pp":
        n_mb = pp_microbatches or mesh_shape(mesh)[STAGE]
        return wl.applying(lambda m, x, t, y, keep: dit_apply_pipelined(
            m, wl.cfg, x, t, y, mesh=mesh, n_microbatches=n_mb,
            cond_keep=keep))
    return contextlib.nullcontext()


def _take(it: Iterable, n: int):
    it = iter(it)
    for _ in range(n):
        yield next(it)


def dit_generate_fisher(wl: DiTWorkload, model: DiT, forget_batches,
                        remain_batches, *, n_iters: int, out_dir: str,
                        seed: int = 0) -> str:
    """Fisher diagonals (the squared batch-mean gradient of the training
    loss, averaged over ``n_iters`` batches) of the forget and the remain
    stream (DiT/generate_fisher.py:217-291), written to
    ``<out_dir>/{forget,remain}_fisher``. Both passes draw from generators
    seeded from ``(seed, batch index)``."""
    os.makedirs(out_dir, exist_ok=True)
    loss = wl.train_loss_fn()
    for name, it in (("forget", forget_batches), ("remain", remain_batches)):
        batches = (device_batch(b, wl.device) for b in _take(it, n_iters))
        fisher = accumulate_fisher(loss, model, batches, seed)
        save_checkpoint(os.path.join(out_dir, f"{name}_fisher"), fisher)
        log.info("saved %s fisher", name)
        del fisher
    return out_dir


def dit_generate_mask(fisher_dir: str, thresholds, params_like=None,
                      device: str | torch.device | None = None
                      ) -> dict[float, dict]:
    """Ratio-threshold masks, one a threshold, written to
    ``<fisher_dir>/fisher_<th>`` (DiT/generate_mask.py): the DDPM runner's
    :func:`~uurg_torch.workloads.ddpm_runner.generate_fisher_mask`, which
    computes on ``device`` (CUDA unless "cpu" is asked for)."""
    return ddpm_runner.generate_fisher_mask(fisher_dir, thresholds,
                                            like=params_like, device=device)


def dit_sample_grid(wl: DiTWorkload, model: DiT, out_path: str, *,
                    n_per_class: int = 2, classes=None,
                    respacing: str = "50", cond_scale: float = 4.0,
                    seed: int = 0, decode_fn: Callable | None = None) -> str:
    """A small CFG sample sheet (DiT/forget.py:344-345): ``n_per_class``
    samples of each class, the respaced ancestral sampler, written to
    ``out_path`` as npz: decoded uint8 ``images`` when a ``decode_fn``
    (latents -> images in [-1, 1]) is given, else the raw ``latents``;
    ``labels`` beside them. Every rank samples (a sharded model's forward
    is a collective); rank 0 writes."""
    classes = list(classes if classes is not None else range(8))
    labels = np.repeat(classes, n_per_class)
    sampler = wl.make_sampler(respacing=respacing, cond_scale=cond_scale)
    gen = torch.Generator(device=wl.device).manual_seed(seed)
    lat = sampler(model, torch.as_tensor(labels, device=wl.device), gen)
    arrays = ({"images": _uint8_images(decode_fn(lat))}
              if decode_fn is not None
              else {"latents": lat.float().cpu().numpy()})
    if rank() == 0:
        np.savez(out_path, labels=labels, **arrays)
    return out_path


def _uint8_images(img: torch.Tensor) -> np.ndarray:
    """Images in [-1, 1] -> uint8 on the host: clipped to [0, 1] after
    (x + 1) / 2, then times 255 cut toward zero, as the JAX package
    converts them."""
    img = torch.clamp((img.float() + 1) / 2, 0, 1)
    return (img * 255).to(torch.uint8).cpu().numpy()


def dit_sample_fid(wl: DiTWorkload, model: DiT, class_labels: np.ndarray, *,
                   respacing: str = "250", cond_scale: float = 1.5,
                   batch_size: int = 32, seed: int = 0,
                   decode_fn: Callable | None = None) -> np.ndarray:
    """Class-conditional samples of ``class_labels`` in order
    (DiT/sample_ddp.py), ``batch_size`` labels a sampler call, the last
    batch padded with label 0 and its samples cut: uint8 NHWC images when a
    ``decode_fn`` (latents -> images in [-1, 1]) is given, else the float32
    latents. Under a process group rank r of n samples
    ``class_labels[r::n]`` from the seed ``seed + r`` (DiT/sample_ddp.py's
    striding, as the JAX function strides by process). Every batch draws
    from one generator on the workload's device; each batch's output is
    copied to the host while the next one is sampled."""
    labels = np.asarray(class_labels)[rank()::world_size()]
    sampler = wl.make_sampler(respacing=respacing, cond_scale=cond_scale)
    gen = torch.Generator(device=wl.device).manual_seed(seed + rank())
    outs, pending = [], None

    def materialize(dev: torch.Tensor) -> np.ndarray:
        if decode_fn is not None:
            return _uint8_images(dev)
        return dev.float().cpu().numpy()

    for i in range(0, len(labels), batch_size):
        chunk = labels[i:i + batch_size]
        lab = torch.as_tensor(np.pad(chunk, (0, batch_size - len(chunk))),
                              device=wl.device)
        lat = sampler(model, lab, gen)[:len(chunk)]
        dev = decode_fn(lat) if decode_fn is not None else lat
        if pending is not None:
            outs.append(materialize(pending))
        pending = dev
    if pending is not None:
        outs.append(materialize(pending))
    return np.concatenate(outs)

