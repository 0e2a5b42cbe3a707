"""Shared setup of the SD CLIs: the workload, its three models and the
pre-encoded batch streams (SD/train-scripts/dataset.py:36-176).

Port of ``cli/sd_common.py``. The UNet, the VAE and the text encoder start
from seeded inits (seeds 0, 1 and 2, as the JAX CLIs' keys); ``--ckpt_path``
then reads the UNet from a CompVis ``sd-v1-*`` ``.ckpt``/``.pt``/``.pth``
(its ``model.diffusion_model`` subtree, :mod:`uurg_torch.io.sd_interop`).
An Orbax directory of the JAX package cannot be read without JAX and
raises. Prompts go through the best local tokenizer tier
(:func:`uurg_torch.models.clip_text.active_tokenizer`), without vocab files
the crc32 stand-in.
"""
from __future__ import annotations

import logging
import os

import numpy as np
import torch

_CKPT_SUFFIXES = (".ckpt", ".pt", ".pth")


def check_sd_checkpoint(path: str) -> None:
    """Raise ValueError unless ``path`` names a CompVis checkpoint file."""
    if os.path.isdir(path) or not path.endswith(_CKPT_SUFFIXES):
        raise ValueError(
            f"--ckpt_path {path}: the port reads a CompVis .ckpt/.pt/.pth; "
            f"an Orbax directory of the JAX package cannot be read without "
            f"JAX")


def setup_workload(args, device=None):
    """(SDWorkload with its VAE and text encoder, UNet) on ``device`` (CUDA
    unless "cpu"): seeded inits, then ``--ckpt_path`` when given."""
    from uurg_torch.io.dit_interop import _load
    from uurg_torch.io.sd_interop import compvis_unet_to_torch
    from uurg_torch.models.autoencoder_kl import init_vae
    from uurg_torch.models.clip_text import init_clip_text
    from uurg_torch.workloads.sd import SDWorkload

    ckpt = getattr(args, "ckpt_path", "")
    if ckpt:
        check_sd_checkpoint(ckpt)
    wl = SDWorkload.build(device=device)
    wl.vae = init_vae(1, wl.vae_cfg, wl.device)
    wl.text = init_clip_text(2, wl.text_cfg, wl.device)
    unet = wl.init_unet(0)
    if ckpt:
        sd = _load(ckpt)
        sd = sd.get("state_dict", sd)
        unet.load_state_dict(compvis_unet_to_torch(sd, wl.unet_cfg),
                             strict=True)
    return wl, unet


def load_images_or_synthetic(path: str, image_size: int,
                             seed: int = 0) -> np.ndarray:
    """[-1, 1] float32 NHWC images of an image folder (a subdirectory a
    class); without one, 32 seeded synthetic images and a warning, as the
    JAX CLI does."""
    from uurg_torch.data.datasets import load_image_folder, synthetic_dataset

    try:
        ds = load_image_folder(path, image_size)
        return ds.images_f32() * 2.0 - 1.0
    except (FileNotFoundError, NotADirectoryError):
        logging.warning("no images at %s — synthetic fallback", path)
        return synthetic_dataset(
            32, image_size, 3, 2, seed).images_f32() * 2 - 1


def latent_prompt_batches(wl, images: np.ndarray, prompt: str,
                          batch_size: int, seed: int,
                          extra_prompt: str | None = None):
    """Infinite (z, ctx[, ctx2]) batches on the workload's device: the
    images encoded once (posterior draws from a generator seeded with
    ``seed``), then ``batch_size`` latents a batch drawn with replacement
    by a numpy generator seeded with ``seed``, the prompt's context (and
    ``extra_prompt``'s) repeated over the batch."""
    from uurg_torch.workloads.sd_runner import encode_image_folder

    gen = torch.Generator(device=wl.device).manual_seed(seed)
    z, ctx = encode_image_folder(wl, images, [prompt], gen)
    ctx2 = (wl.get_learned_conditioning([extra_prompt])
            if extra_prompt is not None else None)
    rng = np.random.default_rng(seed)
    while True:
        idx = torch.as_tensor(rng.integers(0, len(z), batch_size),
                              device=z.device)
        c = ctx.expand(batch_size, *ctx.shape[1:])
        if ctx2 is not None:
            yield z[idx], c, ctx2.expand(batch_size, *ctx2.shape[1:])
        else:
            yield z[idx], c


def save_unet(path: str, unet) -> None:
    """The UNet as a CompVis checkpoint file (its weights under
    ``state_dict``, ``model.diffusion_model.*``), which ``--ckpt_path``
    reads back; written beside ``path`` and renamed over it. A sharded
    (FSDP) UNet is gathered whole, which every rank calls; rank 0 alone
    writes."""
    from uurg_torch.io.sd_interop import torch_unet_to_compvis
    from uurg_torch.parallel.dist import rank
    from uurg_torch.parallel.mesh import full_state_dict

    weights = torch_unet_to_compvis(full_state_dict(unet), unet.cfg)
    if rank() != 0:
        return
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.tmp"
    torch.save({"state_dict": weights}, tmp)
    os.replace(tmp, path)


def run_paired_method(args, runner, extra_prompt: str | None = None,
                      **kwargs) -> str:
    """The shared body of the gradient-ascent, proximal-gradient and
    random-label CLIs: the workload and UNet (``setup_workload``), the
    forget and remain folders (synthetic with seeds ``seed`` and ``seed +
    1`` when missing) pre-encoded into batch streams seeded the same way
    (the forget stream with ``extra_prompt``'s context), ``runner(wl,
    unet, forget, remain, n_iters=, lr=, remain_alpha=, seed=,
    **kwargs)``, then ``<save_path>/final.pt``; returns its path."""
    wl, unet = setup_workload(args, args.device)
    f_imgs = load_images_or_synthetic(args.forget_data, args.image_size,
                                      args.seed)
    r_imgs = load_images_or_synthetic(args.remain_data, args.image_size,
                                      args.seed + 1)
    fb = latent_prompt_batches(wl, f_imgs, args.forget_prompt,
                               args.batch_size, args.seed,
                               extra_prompt=extra_prompt)
    rb = latent_prompt_batches(wl, r_imgs, args.remain_prompt,
                               args.batch_size, args.seed + 1)
    runner(wl, unet, fb, rb, n_iters=args.n_iters, lr=args.lr,
           remain_alpha=args.remain_alpha, seed=args.seed, **kwargs)
    path = os.path.join(args.save_path, "final.pt")
    save_unet(path, unet)
    return path
