"""SD nsfw-concept removal, the flags of ``cli/nsfw_removal.py``
(SD/train-scripts/nsfw_removal.py) plus ``--device``: SFR-on's two-phase
erasure on the SD v1 UNet.

    python -m uurg_torch.cli.nsfw_removal --nsfw_data NSFW \\
        --not_nsfw_data CLOTHED --mask_path FISHER/nude_mask_0.5 \\
        --pack_mask --n_iters 1000 --save_path OUT

``--nsfw_data`` and ``--not_nsfw_data`` are image folders (a subdirectory
a class; 32 seeded synthetic images each when missing), trained with the
reference's nude / clothed prompt pair. ``--mask_path`` reads a mask file
that ``sd_generate_fisher`` or ``generate_fisher_mask`` wrote. Every
``--snapshot_freq`` steps the UNet is written twice, as the reference's
``save_model`` does: ``step_<i>.pt``, a CompVis checkpoint that every SD
CLI reads back with ``--ckpt_path``, and ``step_<i>_diffusers.npz``, the
diffusers ``UNet2DConditionModel`` keys; the run ends with ``final.pt``.
``--mesh data=N`` (or ``data=N,model=M``, ``data=N,seq=S``) and
``--parallelism dp|fsdp|tp|sp`` run on every rank of a ``torchrun`` group
(``torchrun --nproc_per_node 2 -m uurg_torch.cli.nsfw_removal --mesh
model=2 --parallelism tp ...``: the transformers' projections over
``model``, ``SD_TP_RULES``, the rest FSDP-sharded over it; ``--mesh seq=2
--parallelism sp``: the self-attention as a ring over ``seq``); rank 0
writes the files. ``--profile_dir DIR`` writes a ``torch.profiler`` trace
of the run to ``DIR/trace.json``.
"""
from __future__ import annotations

import argparse
import logging
import os


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--train_method", type=str, default="full",
                   choices=["full", "xattn", "selfattn", "noxattn",
                            "notime", "xlayer", "selflayer"])
    p.add_argument("--n_iters", type=int, default=1000)
    p.add_argument("--lr", type=float, default=1e-5)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--forget_alpha", type=float, default=1.0)
    p.add_argument("--remain_alpha", type=float, default=1.0)
    p.add_argument("--ckpt_path", type=str, default="",
                   help="a CompVis sd-v1 .ckpt/.pt/.pth (the UNet is read)")
    p.add_argument("--mask_path", type=str, default="")
    p.add_argument("--nsfw_data", type=str, default="data/nsfw")
    p.add_argument("--not_nsfw_data", type=str, default="data/not-nsfw")
    p.add_argument("--forget_prompt", type=str,
                   default="a photo of a nude person")
    p.add_argument("--pseudo_prompt", type=str,
                   default="a photo of a person wearing clothes")
    p.add_argument("--image_size", type=int, default=512)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--save_path", type=str,
                   default="results/sd/nsfw_removal")
    p.add_argument("--snapshot_freq", type=int, default=200)
    p.add_argument("--mesh", type=str, default="",
                   help="mesh over the ranks, e.g. data=2 or "
                        "data=2,model=2 (-1 fills the rest)")
    p.add_argument("--grad_accum", type=int, default=1,
                   help="gradient-accumulation microbatches per update")
    p.add_argument("--parallelism", type=str, default="dp",
                   choices=["dp", "fsdp", "tp", "sp"],
                   help="dp, fsdp or tp over the mesh; sp: ring "
                        "attention over a 'seq' axis")
    p.add_argument("--nu_dtype", type=str, default="f32",
                   choices=["f32", "bf16"],
                   help="Adam second-moment storage dtype")
    p.add_argument("--pack_mask", action="store_true",
                   help="bit-pack the saliency mask (8x less memory)")
    p.add_argument("--profile_dir", type=str, default="",
                   help="write a torch.profiler trace of the run there "
                        "(trace.json, Chrome/Perfetto); empty = off")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; fails without a GPU) or cpu")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    from uurg_torch.core.device import refuse_multi_device

    refuse_multi_device(args.parallelism)
    import numpy as np
    import torch

    from uurg_torch.cli.sd_common import (latent_prompt_batches,
                                          load_images_or_synthetic,
                                          save_unet, setup_workload)
    from uurg_torch.io.checkpoint import restore_checkpoint
    from uurg_torch.io.diffusers_interop import torch_unet_to_diffusers
    from uurg_torch.parallel import (initialize_distributed, make_mesh,
                                     parse_mesh_spec, rank)
    from uurg_torch.parallel.mesh import full_state_dict
    from uurg_torch.utils.profiling import maybe_trace
    from uurg_torch.workloads.sd_runner import nsfw_removal

    initialize_distributed(device=args.device)
    mesh = make_mesh(parse_mesh_spec(args.mesh)) if args.mesh else None
    wl, unet = setup_workload(args, args.device)
    # both folders' synthetic stand-ins from --seed, as the JAX CLI draws
    # them; the batch indices from numpy generators seeded seed, seed + 1
    fb = latent_prompt_batches(
        wl, load_images_or_synthetic(args.nsfw_data, args.image_size,
                                     args.seed),
        args.forget_prompt, args.batch_size, args.seed,
        extra_prompt=args.pseudo_prompt)
    rb = latent_prompt_batches(
        wl, load_images_or_synthetic(args.not_nsfw_data, args.image_size,
                                     args.seed),
        args.pseudo_prompt, args.batch_size, args.seed + 1)
    mask = (restore_checkpoint(args.mask_path, like=unet)
            if args.mask_path else None)
    os.makedirs(args.save_path, exist_ok=True)

    def snapshot(model, step):
        save_unet(os.path.join(args.save_path, f"step_{step}.pt"), model)
        weights = torch_unet_to_diffusers(full_state_dict(model), model.cfg)
        if rank() == 0:
            np.savez(os.path.join(args.save_path,
                                  f"step_{step}_diffusers.npz"), **weights)

    with maybe_trace(args.profile_dir):
        nsfw_removal(
            wl, unet, fb, rb, n_iters=args.n_iters, lr=args.lr,
            train_method=args.train_method, saliency_mask=mask,
            forget_alpha=args.forget_alpha, remain_alpha=args.remain_alpha,
            seed=args.seed, snapshot_hook=snapshot,
            snapshot_freq=args.snapshot_freq, mesh=mesh,
            parallelism=args.parallelism, grad_accum=args.grad_accum,
            nu_dtype=torch.bfloat16 if args.nu_dtype == "bf16" else None,
            pack_mask=args.pack_mask)
    save_unet(os.path.join(args.save_path, "final.pt"), unet)
    print(f"done: {args.save_path}")


if __name__ == "__main__":
    main()
