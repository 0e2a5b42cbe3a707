"""Host-side DDPM runner: training, Fisher and saliency masks, SFR-on
unlearning and sampling.

Port of ``uurg_tpu/workloads/ddpm_runner.py``: ``pretrain`` (also the
retrain mode), ``generate_fisher``, ``generate_fisher_mask``,
``generate_salun_mask``, ``sfron_forget`` (also SalUn), ``sa_forget``
(Selective Amnesia), ``load_params`` and ``sample_images``. Under a process
group (``torchrun``) the training loops of ``pretrain`` and
``sfron_forget`` and ``sample_images`` run data parallel over every rank
with no flag, as the JAX runner shards its batches over the local devices.
Checkpoints are the reference ``<ckpt_dir>/ckpt.pth`` list format with the
optimizer state, written by rank 0 at every ``snapshot_freq`` and at the
end, and read back on resume by every rank (``sa_forget`` never resumes,
as in the JAX runner). Fishers and masks are
``torch.save`` files of named tensors (:mod:`uurg_torch.io.checkpoint`)
under the JAX runner's names.
"""
from __future__ import annotations

import logging
import os
import time
from typing import Callable

import numpy as np
import torch

from uurg_torch.core.device import resolve_device
from uurg_torch.core.rng import step_seed
from uurg_torch.core.tree import PackedMask, pack_mask
from uurg_torch.data.arrays import (ArrayDataset, epoch_batches,
                                    infinite_batches, random_flip_batch)
from uurg_torch.data.datasets import (load_cifar10, load_image_folder,
                                      synthetic_dataset)
from uurg_torch.data.splits import class_forget_split
from uurg_torch.data.transforms import data_transform, inverse_data_transform
from uurg_torch.io.checkpoint import restore_checkpoint, save_checkpoint
from uurg_torch.io.jax_interop import (load_reference_checkpoint,
                                       load_training_checkpoint,
                                       save_reference_checkpoint)
from uurg_torch.models.unet_cond import CondUNet
from uurg_torch.parallel.dist import (is_initialized, rank,
                                      sync_global_devices, world_size)
from uurg_torch.parallel.mesh import (data_group, gather_rows, local_rows,
                                      make_mesh, replicate, shard_batch,
                                      split_batches)
from uurg_torch.train.optim import build_reference_optimizer
from uurg_torch.unlearn.fisher import accumulate_fisher, sum_gradients
from uurg_torch.unlearn.saliency import (fisher_ratio_mask, mask_sparsity,
                                         topk_saliency_mask)
from uurg_torch.unlearn.sfron import (SFRonConfig, SFRonState, init_state,
                                      make_sfron_step)
from uurg_torch.workloads.ddpm import DDPMWorkload

log = logging.getLogger("uurg_torch.ddpm")


def _load_train_dataset(args, config) -> ArrayDataset:
    """CIFAR-10 from ``data.path``, or the synthetic stand-in when it is not
    there (the same arrays as the JAX runner's: ``synthetic_n`` samples,
    ``base_seed=0`` so every fallback shares one class-pattern set)."""
    if config.data.dataset == "CIFAR10":
        try:
            return load_cifar10(config.data.get("path", "./data"), train=True)
        except FileNotFoundError:
            log.warning("CIFAR-10 not found under %s — synthetic fallback",
                        config.data.get("path"))
    return synthetic_dataset(config.data.get("synthetic_n", 2048),
                             config.data.image_size,
                             config.data.channels, config.data.n_classes,
                             base_seed=0)


def _flip(config):
    if config.data.get("random_flip", False):
        return random_flip_batch
    return None


def _device_batch(config, x: np.ndarray, c: np.ndarray,
                  device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """A host batch on the device: float32 images in model range, int64
    labels."""
    x = torch.from_numpy(np.ascontiguousarray(x)).to(device)
    c = torch.from_numpy(np.asarray(c, np.int64)).to(device)
    return data_transform(config, x), c


def _data_mesh():
    """A ``data`` mesh over every rank of the process group (the JAX
    runner's ``_data_sharding`` over local devices); None without a
    group."""
    return make_mesh({"data": world_size()}) if is_initialized() else None


def _save(ckpt_dir: str, state: SFRonState) -> None:
    """``ckpt.pth``, written by rank 0; every rank waits for it."""
    if rank() == 0:
        os.makedirs(ckpt_dir, exist_ok=True)
        save_reference_checkpoint(os.path.join(ckpt_dir, "ckpt.pth"),
                                  state.model, state.optimizer, state.step,
                                  state.ema_model)
    sync_global_devices("ddpm_ckpt")


def _try_resume(ckpt_dir: str, state: SFRonState) -> tuple[SFRonState, int]:
    """Restore model, optimizer, EMA and step from ``<ckpt_dir>/ckpt.pth``
    if the run wrote one; returns (state, step)."""
    path = os.path.join(ckpt_dir, "ckpt.pth")
    if not os.path.exists(path):
        return state, 0
    state.step = load_training_checkpoint(path, state.model, state.optimizer,
                                          state.ema_model)
    log.info("resumed from %s at step %d", path, state.step)
    return state, state.step


def _train(args, config, ckpt_dir: str, wl: DDPMWorkload, state: SFRonState,
           step_fn, forget: ArrayDataset | None, remain: ArrayDataset,
           sample_hook: Callable | None = None) -> SFRonState:
    """The host loop shared by pretrain and sfron_forget. Under a process
    group every rank starts from rank 0's weights, takes its rows of each
    global batch (when the ranks divide the batch, as the JAX runner
    checks; else every rank runs the whole batch) and averages the
    gradients over the group."""
    state, start_step = _try_resume(ckpt_dir, state)
    bs = config.training.batch_size
    mesh = _data_mesh()
    if mesh is not None:
        for m in (state.model, state.ema_model):
            if m is not None:
                replicate(m)
        state.group = data_group(mesh)
        if bs % world_size():
            mesh = None
    # the JAX runner's streams: pretrain draws from seed, sfron_forget its
    # forget split from seed and its remain split from seed + 1
    r_seed = args.seed if forget is None else args.seed + 1
    r_it = infinite_batches(remain, bs, seed=r_seed, transform=_flip(config))
    f_it = (infinite_batches(forget, bs, seed=args.seed,
                             transform=_flip(config))
            if forget is not None else None)
    gen = torch.Generator(device=wl.device)
    state.model.train()
    start = time.time()
    with split_batches(mesh):
        for i in range(start_step, config.training.n_iters):
            rb = shard_batch(_device_batch(config, *next(r_it), wl.device),
                             mesh)
            fb = (shard_batch(_device_batch(config, *next(f_it), wl.device),
                              mesh) if f_it else rb)
            gen.manual_seed(step_seed(args.seed, i))
            metrics = step_fn(state, fb, rb, gen)
            if (i + 1) % config.training.log_freq == 0 and rank() == 0:
                log.info("step:%04d remain L:%.4f forget L:%.4f forget "
                         "a:%.6f time:%.2f", i, float(metrics["remain_loss"]),
                         float(metrics["forget_loss"]),
                         metrics["forget_alpha"], time.time() - start)
                start = time.time()
            if (i + 1) % config.training.snapshot_freq == 0:
                _save(ckpt_dir, state)
                if sample_hook is not None:
                    sample_hook(state, i)
    _save(ckpt_dir, state)
    return state


def pretrain(args, config, ckpt_dir: str, dataset: ArrayDataset | None = None,
             device: str | torch.device | None = None) -> SFRonState:
    """Conditional DDPM pretraining (DDPM/runners/diffusion.py:101-177):
    the SFR-on engine with forgetting off (remain-only descent plus the EMA
    shadow). ``dataset`` overrides the config's (retrain passes the remain
    split). Runs on ``device``, CUDA unless "cpu" is asked for."""
    wl = DDPMWorkload.from_config(config, device=device)
    model = wl.init_params(args.seed)
    opt = build_reference_optimizer(config, model.parameters())
    cfg = SFRonConfig(
        n_iters=config.training.n_iters, forget_alpha=0.0,
        alpha_sched="const", forget_freq=1,
        forget_clip=None, remain_clip=config.optim.get("grad_clip", None),
        ema_mu=config.model.ema_rate if config.model.get("ema") else None,
    )
    step = make_sfron_step(cfg, None, wl.train_loss_fn())
    state = init_state(model, opt, ema=bool(config.model.get("ema")))
    ds = dataset if dataset is not None else _load_train_dataset(args, config)
    return _train(args, config, ckpt_dir, wl, state, step, None, ds)


def generate_fisher(args, config, out_dir: str,
                    device: str | torch.device | None = None) -> str:
    """Forget and remain Fisher diagonals (DDPM/runners/diffusion.py:
    1210-1364) of the model ``load_params`` gives, in eval mode, over one
    unshuffled pass of each split with the ragged last batch kept, written
    to ``<out_dir>/{forget,remain}_fisher``. Runs on ``device``, CUDA
    unless "cpu" is asked for."""
    wl = DDPMWorkload.from_config(config, device=device)
    model = load_params(args, config, wl)
    remain, forget = class_forget_split(_load_train_dataset(args, config),
                                        args.label_to_forget)
    loss_fn = wl.fisher_loss_fn(cond_scale=getattr(args, "cond_scale", 2.0))

    def batches(split):
        for x, c in epoch_batches(split, config.training.batch_size,
                                  drop_last=False):
            yield _device_batch(config, x, c, wl.device)

    was_training = model.training
    model.eval()
    try:
        for name, split in (("forget", forget), ("remain", remain)):
            fisher = accumulate_fisher(loss_fn, model, batches(split),
                                       args.seed)
            save_checkpoint(os.path.join(out_dir, f"{name}_fisher"), fisher)
            log.info("saved %s fisher (%d examples)", name, len(split))
    finally:
        model.train(was_training)
    return out_dir


# the Fisher files and the mask name of each layout: the DDPM and DiT
# runners' and sd_generate_fisher's
FISHER_LAYOUTS = {"ddpm": (("forget_fisher", "remain_fisher"), "fisher_{th}"),
                  "sd": (("nude_forget", "nude_remain"), "nude_mask_{th}")}


def generate_fisher_mask(fisher_dir: str, thresholds, like=None,
                         device: str | torch.device | None = None,
                         layout: str = "ddpm") -> dict[float, dict]:
    """Fisher-ratio saliency masks (DDPM/generate_fisher_mask.py:6-48 and
    SD/train-scripts/generate_fisher_mask.py:17-48), one a threshold, from
    the two Fisher files of ``layout`` in ``fisher_dir`` (FISHER_LAYOUTS:
    ``forget_fisher`` and ``remain_fisher`` -> ``fisher_<th>``, or
    ``nude_forget`` and ``nude_remain`` -> ``nude_mask_<th>``), written
    beside them (bool leaves). ``like`` (a model or named tensors) checks
    the Fishers' keys and shapes. Computes on ``device``, CUDA unless
    "cpu" is asked for."""
    dev = resolve_device(device)
    names, out_name = FISHER_LAYOUTS[layout]
    ff, rf = ({k: v.to(dev) for k, v in restore_checkpoint(
        os.path.join(fisher_dir, name), like).items()} for name in names)
    out = {}
    for th in np.atleast_1d(thresholds):
        mask = fisher_ratio_mask(ff, rf, float(th))
        log.info("threshold %.3g -> sparsity %.2f%%", th,
                 mask_sparsity(mask) * 100)
        save_checkpoint(os.path.join(fisher_dir, out_name.format(th=th)),
                        mask)
        out[float(th)] = mask
    return out


def generate_salun_mask(args, config, out_dir: str, ratios,
                        device: str | torch.device | None = None) -> str:
    """SalUn top-k |grad| masks (DDPM/runners/diffusion.py:930-1036
    generate_mask): the ``ga`` loss gradients of the model ``load_params``
    gives, in training mode (dropout, label dropout), summed over one pass
    of the forget split, then one mask a ratio, written to
    ``<out_dir>/with_<ratio>``. Runs on ``device``, CUDA unless "cpu" is
    asked for."""
    wl = DDPMWorkload.from_config(config, device=device)
    model = load_params(args, config, wl)
    _, forget = class_forget_split(_load_train_dataset(args, config),
                                   args.label_to_forget)
    batches = (_device_batch(config, x, c, wl.device)
               for x, c in epoch_batches(forget, config.training.batch_size))
    was_training = model.training
    model.train()
    try:
        grads = sum_gradients(wl.ga_forget_loss_fn(), model, batches,
                              args.seed)
    finally:
        model.train(was_training)
    for ratio in np.atleast_1d(ratios):
        save_checkpoint(os.path.join(out_dir, f"with_{ratio}"),
                        topk_saliency_mask(grads, float(ratio)))
    return out_dir


def _device_mask(mask: dict, device: torch.device,
                 pack: bool = False) -> dict:
    """Packed leaves stay packed; 0/1 leaves become bool (1 byte/element),
    bit-packed on the device with ``pack``."""
    out = {}
    for k, v in mask.items():
        if isinstance(v, PackedMask):
            out[k] = v.to(device)
        else:
            v = torch.as_tensor(v).to(device=device, dtype=torch.bool)
            out[k] = pack_mask({k: v})[k] if pack else v
    return out


def load_mask(path: str, model: CondUNet, pack: bool = False) -> dict:
    """A saliency mask file for ``model`` (keys and shapes checked): bool
    leaves, or bit-plane packed with ``pack``."""
    mask = {k: v.unpack(torch.bool) if isinstance(v, PackedMask)
            else v.to(torch.bool)
            for k, v in restore_checkpoint(path, model).items()}
    return pack_mask(mask) if pack else mask


def sfron_forget(args, config, ckpt_dir: str, mask: dict | None = None,
                 sample_hook: Callable | None = None,
                 device: str | torch.device | None = None) -> SFRonState:
    """SFR-on unlearning (DDPM/runners/diffusion.py:1038-1208): forget step
    (adaga/ga/rl, masked, clipped), remain step, EMA, from the model
    ``load_params`` gives. ``mask`` is the saliency mask, ``dict[str,
    Tensor]`` of 0/1 or bool tensors or of PackedMask, keyed by parameter
    name; without it the file ``args.mask_path`` is read when set (packed
    when ``args.pack_mask``), else no mask. Runs on ``device``, CUDA unless
    "cpu" is asked for."""
    wl = DDPMWorkload.from_config(config, device=device)
    model = load_params(args, config, wl)
    if mask is None and getattr(args, "mask_path", None):
        mask = load_mask(args.mask_path, model,
                         getattr(args, "pack_mask", False))
    # nu_dtype (a torch dtype or None): the Adam second moment's storage,
    # the memory knob of the JAX runner
    opt = build_reference_optimizer(
        config, model.parameters(), nu_dtype=getattr(args, "nu_dtype", None))
    sf_cfg = SFRonConfig(
        n_iters=config.training.n_iters,
        forget_alpha=args.forget_alpha,
        remain_alpha=getattr(args, "remain_alpha", 1.0),
        alpha_sched="cosine" if getattr(args, "decay_forget_alpha", False)
        else "const",
        forget_freq=1,
        forget_clip=config.optim.get("grad_clip"),
        remain_clip=config.optim.get("grad_clip"),
        method=getattr(args, "method", "ron"),
        ema_mu=config.model.ema_rate if config.model.get("ema") else None,
    )
    forget_loss = wl.forget_loss_fn(
        getattr(args, "unlearn_loss", "adaga"), args.label_to_forget,
        config.data.n_classes)
    step = make_sfron_step(sf_cfg, forget_loss, wl.train_loss_fn())
    state = init_state(model, opt, ema=bool(config.model.get("ema")),
                       mask=None if mask is None
                       else _device_mask(mask, wl.device))
    remain, forget = class_forget_split(_load_train_dataset(args, config),
                                        args.label_to_forget)
    return _train(args, config, ckpt_dir, wl, state, step, forget, remain,
                  sample_hook)


def _remember_dataset(args, config) -> ArrayDataset:
    """The 'remember' samples of SA: ``<ckpt_folder>/class_samples`` (one
    subdirectory of generated images a class) without the forgotten
    class's (all_but_one_class_path_dataset), or the remain split of the
    training set when there is no such folder or it holds no image. Files
    beside the subdirectories are passed over (the JAX runner falls back to
    the remain split on one)."""
    samples_dir = os.path.join(args.ckpt_folder, "class_samples")
    try:
        classes = [c for c in sorted(os.listdir(samples_dir))
                   if c != str(args.label_to_forget)
                   and os.path.isdir(os.path.join(samples_dir, c))]
        return load_image_folder(samples_dir, config.data.image_size, classes)
    except (FileNotFoundError, NotADirectoryError):
        log.warning("no class_samples under %s; falling back to the remain "
                    "split", args.ckpt_folder)
        remain, _ = class_forget_split(_load_train_dataset(args, config),
                                       args.label_to_forget)
        return remain


def sa_forget(args, config, ckpt_dir: str,
              device: str | torch.device | None = None) -> SFRonState:
    """Selective Amnesia (EWC) forgetting (DDPM/runners/diffusion.py:
    354-477): the eps-loss of uniform-noise images under the forgotten
    label, plus ``training.gamma`` times the eps-loss of remember samples,
    plus ``training.lmbda`` times the EWC pull toward the starting weights,
    weighted by the per-sample Fisher ``<ckpt_folder>/fisher_dict`` that
    ``python -m uurg_torch.cli.fim`` writes. The model ``load_params``
    gives runs in eval mode (no dropout, no label dropout); each step clips
    the gradient at ``optim.grad_clip``, applies the optimizer and the EMA
    at ``model.ema_rate``. ``ckpt.pth`` is written at every
    ``snapshot_freq`` and at the end; there is no resume. Runs on
    ``device``, CUDA unless "cpu" is asked for."""
    folder = getattr(args, "ckpt_folder", None)
    fisher_path = os.path.join(folder or "", "fisher_dict")
    if not folder or not os.path.exists(fisher_path):
        raise FileNotFoundError(
            f"sa_forget needs the per-sample Fisher {fisher_path}: write it "
            f"with python -m uurg_torch.cli.fim --ckpt_folder {folder or 'DIR'}")
    wl = DDPMWorkload.from_config(config, device=device)
    model = load_params(args, config, wl)
    fisher = {k: v.to(wl.device) for k, v in
              restore_checkpoint(fisher_path, like=model).items()}
    params_mle = {k: p.detach().clone().float()
                  for k, p in model.named_parameters()}
    loss_fn = wl.sa_loss_fn(args.label_to_forget,
                            config.training.get("gamma", 1.0),
                            config.training.get("lmbda", 100.0), fisher,
                            params_mle)
    opt = build_reference_optimizer(config, model.parameters())
    ema = bool(config.model.get("ema"))
    # the SFR-on engine with forgetting off, as pretrain: one descent step
    # on the SA loss, clipped, then the EMA
    cfg = SFRonConfig(
        n_iters=config.training.n_iters, forget_alpha=0.0,
        alpha_sched="const", forget_clip=None,
        remain_clip=config.optim.get("grad_clip"),
        ema_mu=config.model.get("ema_rate", 0.9999) if ema else None)
    step = make_sfron_step(cfg, None, loss_fn)
    state = init_state(model, opt, ema=ema)
    model.eval()
    it = infinite_batches(_remember_dataset(args, config),
                          config.training.batch_size, seed=args.seed)
    gen = torch.Generator(device=wl.device)
    for i in range(config.training.n_iters):
        batch = _device_batch(config, *next(it), wl.device)
        gen.manual_seed(step_seed(args.seed, i))
        metrics = step(state, batch, batch, gen)
        if (i + 1) % config.training.log_freq == 0:
            log.info("step %d loss %.4f", i, float(metrics["remain_loss"]))
        if (i + 1) % config.training.snapshot_freq == 0:
            _save(ckpt_dir, state)
    _save(ckpt_dir, state)
    return state


def load_params(args, config, wl: DDPMWorkload,
                use_ema: bool = False) -> CondUNet:
    """The model from ``<ckpt_folder>/ckpts/ckpt.pth`` (reference list
    format), or a fresh model seeded by ``args.seed`` when no folder is
    given or it holds no checkpoint. An Orbax checkpoint from a JAX run has
    to be exported to ``ckpt.pth`` first (``cli/export_torch.py``)."""
    path = getattr(args, "ckpt_folder", None)
    if not path:
        return wl.init_params(args.seed)
    torch_path = os.path.join(path, "ckpts", "ckpt.pth")
    if os.path.exists(torch_path):
        model = CondUNet(wl.unet_cfg)
        step = load_reference_checkpoint(torch_path, model, use_ema=use_ema)
        log.info("loaded %s (step %d, ema=%s)", torch_path, step, use_ema)
        return model.to(wl.device).eval()
    if os.path.isdir(os.path.join(path, "ckpts", "ckpt")):
        raise FileNotFoundError(
            f"{path} holds an Orbax checkpoint; export it with "
            f"cli/export_torch.py to {torch_path} first")
    log.warning("no checkpoint under %s — initializing fresh params", path)
    return wl.init_params(args.seed)


def to_uint8(config, x: torch.Tensor) -> torch.Tensor:
    """Model-range images -> uint8 (inverse transform, x255, round)."""
    return (inverse_data_transform(config, x) * 255.0).round().to(torch.uint8)


def sample_images(args, config, model: CondUNet, labels: np.ndarray,
                  *, num_steps: int = 50, method: str = "ddim",
                  cond_scale: float = 2.0, batch_size: int | None = None,
                  seed: int = 0) -> np.ndarray:
    """Batched class-conditional sampling -> uint8 NHWC images.

    Runs on the model's device, in eval mode (no dropout, as the reference
    samples with ``train=False``); the model's mode is restored after. The
    last batch is padded to the batch size with class 0 and the padding is
    dropped from the output. Under a process group the batch size is
    rounded to a multiple of the ranks (as the JAX runner rounds to its
    devices), each rank samples its rows of every batch from the global
    draw of x_T, and the rows are gathered: every rank returns the whole
    array."""
    device = next(model.parameters()).device
    wl = DDPMWorkload.from_config(config, dtype=model.cfg.dtype, device=device)
    sampler = wl.make_sampler(num_steps=num_steps, cond_scale=cond_scale,
                              method=method)
    bs = batch_size or config.sampling.batch_size
    mesh = _data_mesh()
    if mesh is not None:
        bs = max(bs, world_size()) // world_size() * world_size()
    generator = torch.Generator(device=device).manual_seed(seed)
    out = []
    was_training = model.training
    model.eval()
    try:
        with split_batches(mesh):
            for start in range(0, len(labels), bs):
                chunk = np.asarray(labels[start:start + bs])
                lab = torch.as_tensor(np.pad(chunk, (0, bs - len(chunk))),
                                      dtype=torch.long, device=device)
                x = gather_rows(sampler(model, local_rows(lab), generator))
                out.append(to_uint8(config, x[:len(chunk)]).cpu())
    finally:
        model.train(was_training)
    return torch.cat(out).numpy()
