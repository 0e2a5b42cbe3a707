"""Shared setup of the DiT CLIs (``forget``, ``dit_generate_fisher``,
``dit_generate_mask``, and the VAE of ``encode_latents`` and
``dit_sample``).

Port of ``cli/dit_common.py``: the workload and its model, with a reference
``.pt`` checkpoint loaded (DiT/forget.py:199-215 ``find_model``), and the
forget and remain batch streams over the data tiers, none of which holds the
corpus in RAM:

- a directory of npz latent shards (or a glob prefix of several): the
  sharded reader, ImageNet-256 scale;
- a single ``.npz`` of ``latents`` and ``labels``: in memory;
- an image folder (a subdirectory a class): images decoded per batch and
  encoded by the frozen VAE in the loop (DiT/forget.py:265-267), the VAE
  read from ``--vae_ckpt`` (a CompVis first-stage ``.ckpt``/``.pth`` or the
  port's own ``.pt``, :mod:`uurg_torch.io.vae_interop`) or a seeded init;
- no ``--data-path``: seeded synthetic latents (1,024 of them).

An Orbax checkpoint directory, which the port cannot read without JAX,
raises, for ``--ckpt`` and ``--vae_ckpt`` alike.
"""
from __future__ import annotations

import logging
import os


def build_workload(args, device=None):
    """(DiTWorkload, model) on ``device`` (CUDA unless "cpu"): seeded init
    from ``--global-seed``, then ``--ckpt`` (a reference ``.pt``/``.pth``)
    when given; ``--remat_policy`` full (the default) or one of the
    others. A ``--vae_ckpt`` the port cannot read raises here, before the
    model is built."""
    from uurg_torch.io.dit_interop import load_dit_reference_checkpoint
    from uurg_torch.io.vae_interop import check_vae_checkpoint
    from uurg_torch.workloads.dit import DiTWorkload

    if getattr(args, "vae_ckpt", ""):
        check_vae_checkpoint(args.vae_ckpt)
    remat_policy = getattr(args, "remat_policy", "full")
    wl = DiTWorkload.build(
        args.model, args.image_size, args.num_classes, device=device,
        remat_policy=None if remat_policy == "full" else remat_policy)
    model = wl.init_params(args.global_seed)
    if args.ckpt:
        check_dit_checkpoint(args.ckpt)
        load_dit_reference_checkpoint(args.ckpt, model)
    return wl, model


def check_dit_checkpoint(path: str) -> None:
    """Raise ValueError unless ``path`` names a reference DiT file."""
    if not path.endswith((".pt", ".pth", ".ckpt")):
        raise ValueError(
            f"--ckpt {path}: the port reads reference .pt/.pth checkpoints "
            f"only; an Orbax directory of the JAX package cannot be read "
            f"without JAX")


def build_vae(vae_ckpt: str, device, seed: int = 0):
    """The frozen VAE on ``device``: read from ``vae_ckpt``
    (:func:`uurg_torch.io.vae_interop.load_vae`), or the seeded init of the
    SD / DiT configuration when it is empty."""
    from uurg_torch.core.device import resolve_device
    from uurg_torch.io.vae_interop import load_vae
    from uurg_torch.models.autoencoder_kl import init_vae

    dev = resolve_device(device)
    if vae_ckpt:
        return load_vae(vae_ckpt, dev)
    return init_vae(seed, device=dev)


def forget_remain_iterators(args, device=None):
    """(forget_it, remain_it): infinite batch streams of float32 latents
    and integer labels over the data tiers above (an image folder's latents
    on ``device``, the others on the host); the forget stream draws from
    ``--global-seed``, the remain stream from ``--global-seed`` + 1."""
    import numpy as np
    import torch

    from uurg_torch.data.arrays import ArrayDataset, infinite_batches
    from uurg_torch.data.datasets import synthetic_dataset
    from uurg_torch.data.lazy import (LazyImageFolder, list_latent_shards,
                                      sharded_latent_batches)
    from uurg_torch.data.splits import class_forget_split

    latent_size = args.image_size // 8
    shards = list_latent_shards(args.data_path) if args.data_path else []
    if args.data_path and os.path.isdir(args.data_path) and not shards:
        ds = LazyImageFolder(args.data_path, args.image_size)
        remain, forget = class_forget_split(ds, args.label_to_forget)
        vae = build_vae(getattr(args, "vae_ckpt", ""), device)
        dev = next(vae.parameters()).device

        def batches(d, seed):
            gen = torch.Generator(device=dev).manual_seed(seed)
            for x, y in infinite_batches(d, args.global_batch_size,
                                         seed=seed):
                with torch.inference_mode():
                    z = vae.encode(torch.from_numpy(x * 2.0 - 1.0).to(dev),
                                   generator=gen)
                # a clone outside inference mode, which autograd may save
                yield z.clone(), y

        return (batches(forget, args.global_seed),
                batches(remain, args.global_seed + 1))
    # a shard DIR (even with one file) streams; a bare .npz loads in memory
    if len(shards) > 1 or (shards and os.path.isdir(args.data_path)):
        label = args.label_to_forget
        forget_it = sharded_latent_batches(
            shards, args.global_batch_size, seed=args.global_seed,
            keep_label=lambda y: y == label)
        remain_it = sharded_latent_batches(
            shards, args.global_batch_size, seed=args.global_seed + 1,
            keep_label=lambda y: y != label)
        return forget_it, remain_it
    if shards:
        data = np.load(shards[0])
        ds = ArrayDataset(data["latents"], data["labels"])
    else:
        logging.warning("no latent dataset; synthetic latents")
        ds = synthetic_dataset(1024, latent_size, 4, args.num_classes,
                               args.global_seed)
    remain, forget = class_forget_split(ds, args.label_to_forget)
    return (infinite_batches(forget, args.global_batch_size,
                             seed=args.global_seed),
            infinite_batches(remain, args.global_batch_size,
                             seed=args.global_seed + 1))
