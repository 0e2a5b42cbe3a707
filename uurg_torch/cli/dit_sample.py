"""DiT sampling CLI, the flags of ``cli/dit_sample.py`` plus ``--device``:
DiT/sample.py (one CFG grid) and DiT/sample_ddp.py (FID samples -> npz),
the latents decoded to images by the frozen VAE.

    python -m uurg_torch.cli.dit_sample --ckpt DiT-XL-2-256x256.pt \\
        --mode fid_npz --num-fid-samples 50000 --vae-ckpt VAE.ckpt

``--mode grid`` writes ``<sample-dir>/sample.png``, the samples of
``--class-labels`` in rows of 8 (Pillow; under ``torchrun`` rank 0 writes
every rank's samples, in label order); ``--mode fid_npz`` writes
``<sample-dir>/samples_0.npz`` with ``arr_0`` (N, H, W, 3) uint8 and
``labels``, for ``--num-fid-samples`` labels cycling over the classes
(under ``torchrun`` rank r writes ``samples_<r>.npz`` of every n-th label
from the r-th, DiT/sample_ddp.py's striding). The
DiT is a seeded init from ``--seed`` or a reference ``.pt``/``.pth``
(``--ckpt``); the VAE a seeded init or ``--vae-ckpt`` (a CompVis
first-stage ``.ckpt``/``.pth`` or the port's own ``.pt``). An Orbax
directory of the JAX package raises for either.
"""
from __future__ import annotations

import argparse
import logging
import os


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--model", type=str, default="DiT-XL/2")
    p.add_argument("--image-size", type=int, default=256)
    p.add_argument("--num-classes", type=int, default=1000)
    p.add_argument("--ckpt", type=str, default="",
                   help="DiT checkpoint (reference .pt/.pth)")
    p.add_argument("--mode", type=str, default="grid",
                   choices=["grid", "fid_npz"])
    p.add_argument("--class-labels", type=int, nargs="*",
                   default=[207, 360, 387, 974, 88, 979, 417, 279])
    p.add_argument("--num-fid-samples", type=int, default=50000)
    p.add_argument("--cfg-scale", type=float, default=4.0)
    p.add_argument("--num-sampling-steps", type=int, default=250)
    p.add_argument("--per-proc-batch-size", type=int, default=32)
    p.add_argument("--vae-ckpt", type=str, default="",
                   help="VAE weights: a CompVis first-stage .ckpt/.pth or "
                        "the port's own .pt; a seeded init when empty")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--sample-dir", type=str, default="results/dit_samples")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; fails without a GPU) or cpu")
    return p.parse_args(argv)


def _label_order(part, n: int):
    """The samples of all ``n`` labels in label order, from every rank's
    samples of its ``labels[r::world]`` (a collective under a process
    group; ``part`` itself without one)."""
    import numpy as np
    import torch.distributed as dist

    from uurg_torch.parallel import world_size

    world = world_size()
    if world == 1:
        return part
    parts = [None] * world
    dist.all_gather_object(parts, part)
    out = np.empty((n,) + part.shape[1:], part.dtype)
    for r, p in enumerate(parts):
        out[r::world] = p
    return out


def main(argv=None):
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    import numpy as np
    import torch

    from uurg_torch.cli.dit_common import build_vae, check_dit_checkpoint
    from uurg_torch.io.dit_interop import load_dit_reference_checkpoint
    from uurg_torch.io.vae_interop import check_vae_checkpoint
    from uurg_torch.parallel import initialize_distributed, rank, world_size
    from uurg_torch.workloads.dit import DiTWorkload
    from uurg_torch.workloads.dit_runner import dit_sample_fid

    initialize_distributed(device=args.device)

    if args.ckpt:
        check_dit_checkpoint(args.ckpt)
    if args.vae_ckpt:
        check_vae_checkpoint(args.vae_ckpt)
    wl = DiTWorkload.build(args.model, args.image_size, args.num_classes,
                           device=args.device)
    model = wl.init_params(args.seed)
    if args.ckpt:
        load_dit_reference_checkpoint(args.ckpt, model)
    model.eval()
    vae = build_vae(args.vae_ckpt, wl.device, seed=1)

    def decode(z):
        with torch.inference_mode():
            return vae.decode(z.float())

    os.makedirs(args.sample_dir, exist_ok=True)
    if args.mode == "grid":
        labels = np.asarray(args.class_labels)
    else:
        labels = np.tile(np.arange(args.num_classes),
                         -(-args.num_fid_samples // args.num_classes)
                         )[:args.num_fid_samples]
    imgs = dit_sample_fid(
        wl, model, labels, respacing=str(args.num_sampling_steps),
        cond_scale=args.cfg_scale, batch_size=args.per_proc_batch_size,
        seed=args.seed, decode_fn=decode)
    # under a process group rank r sampled labels[r::n] (dit_sample_fid)
    if args.mode == "grid":
        from uurg_torch.utils.images import save_grid

        imgs = _label_order(imgs, len(labels))
        if rank() == 0:
            save_grid(imgs, os.path.join(args.sample_dir, "sample.png"),
                      ncol=min(8, len(imgs)))
    else:
        np.savez(os.path.join(args.sample_dir, f"samples_{rank()}.npz"),
                 arr_0=imgs, labels=labels[rank()::world_size()])
    print(f"wrote {args.sample_dir}")


if __name__ == "__main__":
    main()
