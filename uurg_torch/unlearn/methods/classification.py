"""The nine classification unlearning methods.

Port of ``uurg_tpu/unlearn/methods/classification.py`` (parity targets
Classification/unlearn/*): baseline, retrain, finetune, gradient_ascent,
random_label, bad_teacher, scrub, salun, sfron, under the same registry
names and default hyperparameters (the reference's CIFAR-10 settings, cited
per method). Each method is ``run(ctx) -> model``: it unlearns a copy of
``ctx.model`` (parameters and BatchNorm buffers) and leaves ``ctx.model``
as it was, so a comparison runs every method from the same weights.

The host streams (``infinite_batches``, ``epoch_batches``, the relabelling
and BadTeacher's permutation) are the JAX package's numpy streams, so the
same seed gives the same batches on both sides. SFR-on draws its batches on
the device by default (:func:`device_batcher`) and runs ``scan_chunk``
iterations (50, cut as the JAX package cuts it until it divides
``n_iters``) a call of :func:`uurg_torch.unlearn.sfron.make_sfron_scan`:
one CUDA graph replay on the card. Its stream seeds the generator once a
chunk from ``step_seed(seed, first step)`` and draws each step's forget
batch, then its remain batch. ``scan_chunk: 1`` steps one iteration at a
time, seeding the generator every iteration; ``device_data: False`` keeps
the host stream, one iteration at a time.
"""
from __future__ import annotations

import copy
import dataclasses
import logging
import os
import time
import zlib
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from uurg_torch.core import tree as tr
from uurg_torch.core.registry import Registry
from uurg_torch.core.rng import step_seed
from uurg_torch.data.arrays import ArrayDataset, epoch_batches, infinite_batches
from uurg_torch.io.checkpoint import restore_checkpoint, save_checkpoint
from uurg_torch.train.optim import cosine_annealing, make_optimizer, set_lr
from uurg_torch.unlearn.fisher import accumulate_fisher, sum_gradients
from uurg_torch.unlearn.saliency import fisher_ratio_mask, topk_saliency_mask
from uurg_torch.unlearn.sfron import (SFRonConfig, init_state,
                                      make_sfron_scan, make_sfron_step)
from uurg_torch.workloads.classification import Classifier, cross_entropy

unlearn_method_registry = Registry("unlearn method")
log = logging.getLogger("uurg.cls")


@dataclasses.dataclass
class UnlearnContext:
    """``init_fn(seed) -> model`` gives freshly initialised weights on the
    classifier's device (Retrain, BadTeacher's random teacher)."""

    classifier: Classifier
    model: torch.nn.Module
    retain_train: ArrayDataset
    forget_train: ArrayDataset
    num_classes: int
    batch_size: int = 256
    seed: int = 0
    save_path: str | None = None
    transform: Callable | None = None   # train-time augmentation
    init_fn: Callable | None = None
    overrides: dict = dataclasses.field(default_factory=dict)

    def hp(self, name, default):
        return self.overrides.get(name, default)


def _copy(model: torch.nn.Module) -> torch.nn.Module:
    out = copy.deepcopy(model)
    for p in out.parameters():
        p.grad = None
    return out


def device_batcher(batch_size: int, augment: bool = True):
    """``draw((images, labels), generator) -> (x, y)`` over a split held
    whole on the device: indices uniform with replacement, uint8 images
    divided by 255, and with ``augment`` the reference's train augmentation
    (a random horizontal flip and a random crop after 4-pixel zero padding,
    a sample each), all drawn from ``generator`` on the device. The JAX
    package's ``_device_batcher`` draws the same distribution from its own
    key; the two streams differ."""
    pad = 4

    def draw(data, generator: torch.Generator):
        images, labels = data
        dev = images.device
        idx = torch.randint(0, images.shape[0], (batch_size,),
                            generator=generator, device=dev)
        x = images[idx].float()
        if images.dtype == torch.uint8:
            x = x / 255.0
        if augment:
            flip = torch.rand(batch_size, generator=generator,
                              device=dev) < 0.5
            x = torch.where(flip[:, None, None, None], x.flip(2), x)
            h, w = x.shape[1:3]
            xp = F.pad(x, (0, 0, pad, pad, pad, pad))
            oy, ox = torch.randint(0, 2 * pad + 1, (2, batch_size),
                                   generator=generator, device=dev)
            rows = oy[:, None] + torch.arange(h, device=dev)
            cols = ox[:, None] + torch.arange(w, device=dev)
            x = xp[torch.arange(batch_size, device=dev)[:, None, None],
                   rows[:, :, None], cols[:, None, :]]
        return x, labels[idx]

    return draw


def _cosine_epoch_lr(lr: float, epoch: int, epochs: int) -> float:
    return lr * (1.0 + np.cos(np.pi * epoch / epochs)) / 2.0


def _grads(model: torch.nn.Module) -> dict[str, torch.Tensor]:
    return {n: p.grad for n, p in model.named_parameters()}


def _train_epochs(ctx: UnlearnContext, model: torch.nn.Module,
                  ds: ArrayDataset, *, lr: float, epochs: int,
                  opt_name: str = "sgd", momentum: float = 0.9,
                  weight_decay: float = 5e-4,
                  loss_builder: Callable | None = None,
                  clip: float | None = None, mask=None,
                  seed: int = 0) -> torch.nn.Module:
    """Generic epoch trainer of finetune, retrain, random-label and salun;
    trains ``model`` in place and returns it. The lr is the reference's
    per-EPOCH cosine (constant within an epoch); an epoch is
    ceil(len / batch) full batches, wrapping around the shuffled stream as
    the JAX package does where the reference's last batch is partial."""
    cls = ctx.classifier
    opt = make_optimizer(opt_name, model.parameters(), lr, momentum=momentum,
                         weight_decay=weight_decay)
    steps_per_epoch = max(1, -(-len(ds) // ctx.batch_size))
    loss_fn = loss_builder or (lambda m, batch, gen: cross_entropy(
        cls.train_apply(m, batch[0]), batch[1]))
    for epoch in range(epochs):
        set_lr(opt, _cosine_epoch_lr(lr, epoch, epochs))
        it = infinite_batches(ds, ctx.batch_size, seed=seed + epoch,
                              transform=ctx.transform)
        for _ in range(steps_per_epoch):
            opt.zero_grad(set_to_none=True)
            loss_fn(model, cls.batch(*next(it)), None).backward()
            if mask is not None:
                tr.tree_mul_(_grads(model), mask)
            if clip is not None:
                tr.clip_by_global_norm_(_grads(model), clip)
            opt.step()
    return model


# --- methods --------------------------------------------------------------

@unlearn_method_registry.register("Baseline")
def baseline(ctx: UnlearnContext) -> torch.nn.Module:
    """No-op (Classification/unlearn/baseline.py:4-8)."""
    return _copy(ctx.model)


@unlearn_method_registry.register("Finetune")
def finetune(ctx: UnlearnContext) -> torch.nn.Module:
    """Fine-tune on retain only, SGD lr 0.01 x 10 epochs
    (Classification/unlearn/finetune.py:27-32)."""
    return _train_epochs(ctx, _copy(ctx.model), ctx.retain_train,
                         lr=ctx.hp("lr", 0.01), epochs=ctx.hp("epochs", 10),
                         seed=ctx.seed)


@unlearn_method_registry.register("Retrain")
def retrain(ctx: UnlearnContext) -> torch.nn.Module:
    """Exact unlearning: re-init and train on retain, SGD lr 0.1 x 200 epochs
    (Classification/unlearn/retrain.py:29-35)."""
    if ctx.init_fn is None:
        raise ValueError("Retrain needs init_fn")
    return _train_epochs(ctx, ctx.init_fn(ctx.seed), ctx.retain_train,
                         lr=ctx.hp("lr", 0.1), epochs=ctx.hp("epochs", 200),
                         seed=ctx.seed)


@unlearn_method_registry.register("GradAscent")
def grad_ascent(ctx: UnlearnContext) -> torch.nn.Module:
    """Negated CE on forget, the model in eval mode during the ascent
    (BatchNorm statistics frozen), gradient clip 0.1, SGD lr 1e-4 x 9 epochs
    (Classification/unlearn/gradient_ascent.py:28-78)."""
    cls = ctx.classifier

    def neg_ce_eval_mode(model, batch, gen):
        return -cross_entropy(cls.eval_apply(model, batch[0]), batch[1])

    return _train_epochs(ctx, _copy(ctx.model), ctx.forget_train,
                         lr=ctx.hp("lr", 1e-4), epochs=ctx.hp("epochs", 9),
                         loss_builder=neg_ce_eval_mode,
                         clip=ctx.hp("max_norm", 0.1), seed=ctx.seed)


def _relabel(ds: ArrayDataset, num_classes: int, seed: int) -> ArrayDataset:
    """A random label other than y for each forget sample (Classification/
    unlearn/random_label.py:41-60)."""
    shift = np.random.default_rng(seed).integers(1, num_classes, len(ds))
    new_labels = (ds.labels + shift) % num_classes
    return ArrayDataset(ds.images, new_labels.astype(ds.labels.dtype))


def _merged(retain: ArrayDataset, forget: ArrayDataset):
    """The merged dataset and its forget flags (1 = forget sample), the
    reference's UnLearnDataset (unlearn_method.py:23-41)."""
    images = np.concatenate([retain.images, forget.images])
    labels = np.concatenate([retain.labels, forget.labels])
    flags = np.concatenate([np.zeros(len(retain), np.int32),
                            np.ones(len(forget), np.int32)])
    return ArrayDataset(images, labels), flags


@unlearn_method_registry.register("RandomLabel")
def random_label(ctx: UnlearnContext, mask=None) -> torch.nn.Module:
    """Train on retain + randomly relabelled forget, SGD lr 0.003 x 10
    epochs (Classification/unlearn/random_label.py:46-66,85-105)."""
    relabeled = _relabel(ctx.forget_train, ctx.num_classes, ctx.seed)
    merged = ArrayDataset(
        np.concatenate([ctx.retain_train.images, relabeled.images]),
        np.concatenate([ctx.retain_train.labels, relabeled.labels]))
    return _train_epochs(ctx, _copy(ctx.model), merged,
                         lr=ctx.hp("lr", 0.003), epochs=ctx.hp("epochs", 10),
                         mask=mask, seed=ctx.seed)


@unlearn_method_registry.register("SalUn")
def salun(ctx: UnlearnContext) -> torch.nn.Module:
    """Top-k |forget gradient| hard mask, then RandomLabel under it, th 0.2,
    lr 0.007 (Classification/unlearn/salun.py:36-43,140-195). The gradient
    is of the negated CE in eval mode, summed over one forget epoch."""
    cls = ctx.classifier

    def neg_ce(model, batch, gen):
        return -cross_entropy(cls.eval_apply(model, batch[0]), batch[1])

    acc = sum_gradients(neg_ce, ctx.model, (
        cls.batch(x, y) for x, y in epoch_batches(
            ctx.forget_train, ctx.batch_size, seed=ctx.seed)), ctx.seed)
    mask = topk_saliency_mask(acc, ctx.hp("th", 0.2))
    sub = dataclasses.replace(ctx, overrides={
        "lr": ctx.hp("lr", 0.007), "epochs": ctx.hp("epochs", 10)})
    return random_label(sub, mask=mask)


def _kl_terms(target: torch.Tensor, log_s: torch.Tensor) -> torch.Tensor:
    """Elementwise ``t (log t - log s)``, 0 where t is 0."""
    return torch.xlogy(target, target) - target * log_s


@unlearn_method_registry.register("BadTeacher")
def bad_teacher(ctx: UnlearnContext) -> torch.nn.Module:
    """Distillation from the full model (retain samples) and a randomly
    initialised teacher (forget samples), the KL target chosen by the forget
    flag, SGD lr 0.02 x 10 epochs (Classification/unlearn/bad_teacher.py
    :17-145). The epoch's last batch is partial, as the JAX loop's."""
    if ctx.init_fn is None:
        raise ValueError("BadTeacher needs init_fn")
    cls = ctx.classifier
    kl_T = ctx.hp("KL_temperature", 1.0)
    full = ctx.model
    rand = ctx.init_fn(ctx.seed + 1)
    merged, flags = _merged(ctx.retain_train, ctx.forget_train)
    model = _copy(ctx.model)
    lr = ctx.hp("lr", 0.02)
    opt = make_optimizer("sgd", model.parameters(), lr, momentum=0.9,
                         weight_decay=5e-4)
    epochs = ctx.hp("epochs", 10)
    bs = ctx.batch_size
    steps_per_epoch = max(1, -(-len(merged) // bs))
    rng = np.random.default_rng(ctx.seed)
    images = merged.images_f32()
    for epoch in range(epochs):
        set_lr(opt, _cosine_epoch_lr(lr, epoch, epochs))
        perm = rng.permutation(len(merged))
        for s in range(steps_per_epoch):
            take = perm[s * bs:(s + 1) * bs]
            x = images[take]
            if ctx.transform is not None:
                x = ctx.transform(x, rng)
            x, f = cls.batch(x, flags[take])
            f = f.float()[:, None]
            with torch.no_grad():
                f_soft = torch.softmax(cls.eval_apply(full, x) / kl_T, -1)
                u_soft = torch.softmax(cls.eval_apply(rand, x) / kl_T, -1)
                target = f * u_soft + (1 - f) * f_soft
            opt.zero_grad(set_to_none=True)
            log_s = torch.log_softmax(cls.train_apply(model, x) / kl_T, -1)
            # torch F.kl_div(reduction='mean'): the mean over batch x classes
            _kl_terms(target, log_s).mean().backward()
            opt.step()
    return model


@unlearn_method_registry.register("SCRUB")
def scrub(ctx: UnlearnContext) -> torch.nn.Module:
    """SCRUB max/min distillation (Classification/unlearn/scrub.py:17-277):
    epochs <= msteps run a maximize pass (-KL to the teacher on forget),
    every epoch a minimize pass (gamma CE + alpha KL on retain), one SGD
    state across both; optional SWA smoothing through ``param_dist``."""
    cls = ctx.classifier
    kd_T = ctx.hp("kd_T", 4.0)
    gamma, alpha = ctx.hp("gamma", 0.99), ctx.hp("alpha", 0.001)
    smoothing = ctx.hp("smoothing", 0.0)
    msteps = ctx.hp("msteps", 2)
    sstart = ctx.hp("sstart", 10)
    epochs = ctx.hp("sgda_epochs", 6)
    lr = ctx.hp("sgda_learning_rate", 8e-5)

    teacher = ctx.model
    model = _copy(ctx.model)
    params = list(model.parameters())
    swa = [p.detach().clone() for p in params]
    opt = make_optimizer("sgd", params, lr, momentum=0.9, weight_decay=5e-4)

    def distill_kl(logit_s, logit_t):
        p_s = torch.log_softmax(logit_s / kd_T, -1)
        p_t = torch.softmax(logit_t / kd_T, -1)
        return _kl_terms(p_t, p_s).sum() * kd_T ** 2 / logit_s.shape[0]

    def param_dist():
        # norm(0) has a NaN gradient: skipped entirely without smoothing
        return sum(torch.sqrt(torch.sum(torch.square(p - s)) + 1e-12)
                   for p, s in zip(params, swa))

    def step(x, loss_of_logits):
        with torch.no_grad():
            t_logits = cls.eval_apply(teacher, x)
        opt.zero_grad(set_to_none=True)
        loss = loss_of_logits(cls.train_apply(model, x), t_logits)
        if smoothing != 0.0:
            loss = loss + smoothing * param_dist()
        loss.backward()
        opt.step()

    for epoch in range(1, epochs + 1):
        set_lr(opt, _cosine_epoch_lr(lr, epoch - 1, epochs))
        if epoch <= msteps:
            for x, y in epoch_batches(ctx.forget_train, ctx.batch_size,
                                      shuffle=True, seed=ctx.seed + epoch):
                step(cls.batch(x, y)[0], lambda s, t: -distill_kl(s, t))
        for x, y in epoch_batches(ctx.retain_train, ctx.batch_size,
                                  shuffle=True, seed=ctx.seed + epoch,
                                  transform=ctx.transform):
            x, y = cls.batch(x, y)
            step(x, lambda s, t: gamma * cross_entropy(s, y)
                 + alpha * distill_kl(s, t))
        if epoch >= sstart:
            beta = ctx.hp("beta", 0.0)
            with torch.no_grad():
                for s, p in zip(swa, params):
                    s.mul_(1 - beta).add_(p, alpha=beta)
    return model


def _fisher_cache_tag(ctx: UnlearnContext) -> str:
    """Fingerprint of the Fisher's run identity: seed, the forget labels and
    four forget images, the retain size, and the model's parameter names and
    shapes. Keys the Fisher files, so that a rerun with another forget set,
    seed or model recomputes instead of reusing a stale diagonal."""
    h = zlib.crc32(np.int64(ctx.seed).tobytes())
    h = zlib.crc32(np.asarray(ctx.forget_train.labels).tobytes(), h)
    h = zlib.crc32(
        np.ascontiguousarray(ctx.forget_train.images[:4]).tobytes(), h)
    h = zlib.crc32(np.int64(len(ctx.retain_train)).tobytes(), h)
    for name, p in ctx.model.named_parameters():
        h = zlib.crc32(f"{name}{tuple(p.shape)}".encode(), h)
    return f"{h:08x}"


def _fisher_mask(ctx: UnlearnContext, model: torch.nn.Module) -> dict:
    """The Fisher-ratio saliency mask (eval-mode CE gradients over one pass
    of each split), the two Fishers cached in ``save_path`` as
    ``forget_fisher_<tag>`` and ``remain_fisher_<tag>`` (torch.save files
    under the JAX package's names; Classification/unlearn/sfron.py:269-271,
    296-298 saves and reuses them)."""
    cls = ctx.classifier
    dev = next(model.parameters()).device
    names = dict(model.named_parameters())
    ff_path = rf_path = None
    if ctx.save_path:
        tag = _fisher_cache_tag(ctx)
        ff_path = os.path.join(ctx.save_path, f"forget_fisher_{tag}")
        rf_path = os.path.join(ctx.save_path, f"remain_fisher_{tag}")
    if ff_path and os.path.isfile(ff_path) and os.path.isfile(rf_path):
        fishers = [{k: v.to(dev) for k, v in restore_checkpoint(
            p, like=names).items()} for p in (ff_path, rf_path)]
    else:
        def fisher_loss(m, batch, gen):
            return cross_entropy(cls.eval_apply(m, batch[0]), batch[1])

        fishers = [accumulate_fisher(fisher_loss, model, (
            cls.batch(x, y) for x, y in epoch_batches(ds, ctx.batch_size,
                                                      seed=ctx.seed)),
            ctx.seed) for ds in (ctx.forget_train, ctx.retain_train)]
        if ff_path:
            save_checkpoint(ff_path, fishers[0])
            save_checkpoint(rf_path, fishers[1])
    return fisher_ratio_mask(*fishers, ctx.hp("th", 1.0))


@unlearn_method_registry.register("SFRon")
def sfron(ctx: UnlearnContext) -> torch.nn.Module:
    """SFR-on for classifiers (Classification/unlearn/sfron.py:67-355),
    CIFAR-10 defaults: SGD lr 0.01 cosine-annealed over 1500 iterations
    (momentum 0.9, wd 5e-4), forget every 5 iterations with adaga CE ascent
    (lambda 0.5, alpha 25 cosine-decayed, clip 7.0, no remain clip), the
    Fisher-ratio mask at threshold 1, no fast-slow mix (ema_beta 1). Both
    phases run the model in train mode, so the BatchNorm statistics move in
    each. Batches are drawn on the device, ``scan_chunk`` iterations a
    chunk (see the module's docstring), unless ``device_data`` is False."""
    cls = ctx.classifier
    n_iters = ctx.hp("n_iters", 1500)
    model = _copy(ctx.model)
    dev = next(model.parameters()).device
    mask = _fisher_mask(ctx, model) if ctx.hp("mask", True) else None

    chunk = ctx.hp("scan_chunk", 50)
    while chunk > 1 and n_iters % chunk:
        chunk -= 1
    device_data = ctx.hp("device_data", True)
    scan = chunk > 1 and device_data
    opt = make_optimizer(ctx.hp("opt", "sgd"), model.parameters(),
                         ctx.hp("retain_lr", 0.01), momentum=0.9,
                         weight_decay=5e-4, capturable=scan)
    cfg = SFRonConfig(
        n_iters=n_iters,
        forget_alpha=ctx.hp("forget_alpha", 25.0),
        remain_alpha=1.0,
        alpha_sched=ctx.hp("sched", "cosine"),
        forget_freq=ctx.hp("forget_freq", 5),
        forget_clip=ctx.hp("max_norm", 7.0),
        remain_clip=None,
        fast_slow_beta=ctx.hp("ema_beta", 1.0),
    )
    forget_loss = (cls.neg_adaptive_ce_loss_fn(ctx.hp("lambd", 0.5))
                   if ctx.hp("unlearn_loss", "adaga") == "adaga"
                   else cls.neg_ce_loss_fn())
    sched = cosine_annealing(ctx.hp("retain_lr", 0.01), n_iters)
    state = init_state(model, opt, mask=mask)
    gen = torch.Generator(device=dev)
    start = time.time()

    def logged(done: int, remain_loss) -> None:
        log.info("sfron iter %d/%d remain L %.4f (%.1f it/s)", done,
                 n_iters, float(remain_loss), done / (time.time() - start))

    if device_data:
        # each split uploaded once, every batch drawn, converted and
        # augmented on the device: no host-to-device copy a step
        draw = device_batcher(ctx.batch_size,
                              augment=ctx.transform is not None)
        f_data, r_data = ((torch.as_tensor(ds.images).to(dev),
                           torch.as_tensor(ds.labels).to(dev, torch.long))
                          for ds in (ctx.forget_train, ctx.retain_train))
    if scan:
        run = make_sfron_scan(cfg, forget_loss, cls.ce_loss_fn(), chunk,
                              device_batcher=draw, lr_schedule=sched,
                              seed=ctx.seed)
        for outer in range(n_iters // chunk):
            metrics = run(state, f_data, r_data, gen)
            done = (outer + 1) * chunk
            if done % 250 < chunk:
                logged(done, metrics["remain_loss"][-1])
        return state.model

    step = make_sfron_step(cfg, forget_loss, cls.ce_loss_fn(),
                           lr_schedule=sched)
    if device_data:
        def batches(i):
            gen.manual_seed(step_seed(ctx.seed, i))
            return draw(f_data, gen), draw(r_data, gen)
    else:
        f_it = infinite_batches(ctx.forget_train, ctx.batch_size,
                                seed=ctx.seed, transform=ctx.transform)
        r_it = infinite_batches(ctx.retain_train, ctx.batch_size,
                                seed=ctx.seed + 1, transform=ctx.transform)

        def batches(i):
            gen.manual_seed(step_seed(ctx.seed, i))
            return cls.batch(*next(f_it)), cls.batch(*next(r_it))

    for i in range(n_iters):
        metrics = step(state, *batches(i), gen)
        if (i + 1) % 250 == 0:
            logged(i + 1, metrics["remain_loss"])
    return state.model
