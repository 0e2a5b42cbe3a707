"""Shared setup of the DiT CLIs (``forget``, ``dit_generate_fisher``,
``dit_generate_mask``).

Port of ``cli/dit_common.py``: the workload and its model, with a reference
``.pt`` checkpoint loaded (DiT/forget.py:199-215 ``find_model``), and the
forget and remain batch streams over the data tiers, none of which holds the
corpus in RAM:

- a directory of npz latent shards (or a glob prefix of several): the
  sharded reader, ImageNet-256 scale;
- a single ``.npz`` of ``latents`` and ``labels``: in memory;
- no ``--data-path``: seeded synthetic latents (1,024 of them).

An image folder (encoded per batch by the frozen VAE) and ``--vae_ckpt``
come with the VAE (ROADMAP Queue 1 item 6(b)) and raise, as does an Orbax
checkpoint directory, which the port cannot read without JAX.
"""
from __future__ import annotations

import logging
import os

VAE_ITEM = ("the VAE, its image-folder mode and --vae_ckpt come with ROADMAP "
            "Queue 1 item 6(b)")


def build_workload(args, device=None):
    """(DiTWorkload, model) on ``device`` (CUDA unless "cpu"): seeded init
    from ``--global-seed``, then ``--ckpt`` (a reference ``.pt``/``.pth``)
    when given; ``--remat_policy`` full (the default) or one of the
    others."""
    from uurg_torch.io.dit_interop import load_dit_reference_checkpoint
    from uurg_torch.workloads.dit import DiTWorkload

    if getattr(args, "vae_ckpt", ""):
        raise NotImplementedError(f"--vae_ckpt: {VAE_ITEM}")
    remat_policy = getattr(args, "remat_policy", "full")
    wl = DiTWorkload.build(
        args.model, args.image_size, args.num_classes, device=device,
        remat_policy=None if remat_policy == "full" else remat_policy)
    model = wl.init_params(args.global_seed)
    if args.ckpt:
        if not args.ckpt.endswith((".pt", ".pth", ".ckpt")):
            raise ValueError(
                f"--ckpt {args.ckpt}: the port reads reference .pt/.pth "
                f"checkpoints only; an Orbax directory of the JAX package "
                f"cannot be read without JAX")
        load_dit_reference_checkpoint(args.ckpt, model)
    return wl, model


def forget_remain_iterators(args):
    """(forget_it, remain_it): infinite host batch streams of float32
    latents and integer labels over the data tiers above; the forget stream
    draws from ``--global-seed``, the remain stream from ``--global-seed``
    + 1."""
    import numpy as np

    from uurg_torch.data.arrays import ArrayDataset, infinite_batches
    from uurg_torch.data.datasets import synthetic_dataset
    from uurg_torch.data.lazy import list_latent_shards, sharded_latent_batches
    from uurg_torch.data.splits import class_forget_split

    latent_size = args.image_size // 8
    shards = list_latent_shards(args.data_path) if args.data_path else []
    if args.data_path and os.path.isdir(args.data_path) and not shards:
        raise NotImplementedError(
            f"{args.data_path} holds no npz latent shards: an image folder "
            f"needs the VAE; {VAE_ITEM}")
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
