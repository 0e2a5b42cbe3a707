"""SD ESD erasure, the flags of ``cli/train_esd.py``
(SD/train-scripts/train-esd.py) plus ``--device``: negative-guidance
erasure of ``--prompt`` on latents the current model partially denoises
itself each step, against a frozen copy of the starting UNet on the same
device, then ``<save_path>/final.pt`` (a CompVis checkpoint that
``--ckpt_path`` reads back).

    python -m uurg_torch.cli.train_esd --prompt nudity --iterations 1000 \\
        --ckpt_path SD.ckpt --save_path OUT
"""
from __future__ import annotations

import argparse
import logging
import os


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--prompt", type=str, default="nudity",
                   help="concept to erase")
    p.add_argument("--train_method", type=str, default="xattn",
                   choices=["full", "xattn", "selfattn", "noxattn",
                            "notime", "xlayer", "selflayer"])
    p.add_argument("--iterations", type=int, default=1000)
    p.add_argument("--lr", type=float, default=1e-5)
    p.add_argument("--negative_guidance", type=float, default=1.0)
    p.add_argument("--start_guidance", type=float, default=3.0,
                   help="CFG scale of the partial-denoise sampling")
    p.add_argument("--ddim_steps", type=int, default=50)
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--image_size", type=int, default=512)
    p.add_argument("--ckpt_path", type=str, default="",
                   help="a CompVis sd-v1 .ckpt/.pt/.pth (the UNet is read)")
    p.add_argument("--mask_path", type=str, default="",
                   help="optional saliency mask multiplied into the grads")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--save_path", type=str, default="results/sd/esd")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; fails without a GPU) or cpu")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    from uurg_torch.cli.sd_common import save_unet, setup_workload
    from uurg_torch.io.checkpoint import restore_checkpoint
    from uurg_torch.workloads.sd_runner import esd_batch_builder, train_esd

    wl, unet = setup_workload(args, args.device)
    # the training latents come from the current model each step
    # (train-esd.py:266-301, quick_sample_till_t)
    builder = esd_batch_builder(
        wl, wl.get_learned_conditioning([args.prompt]),
        wl.get_learned_conditioning([""]), ddim_steps=args.ddim_steps,
        start_guidance=args.start_guidance,
        latent_size=args.image_size // 8, batch_size=args.batch_size)
    mask = (restore_checkpoint(args.mask_path, like=unet)
            if args.mask_path else None)
    train_esd(wl, unet, builder, n_iters=args.iterations, lr=args.lr,
              train_method=args.train_method,
              negative_guidance=args.negative_guidance, seed=args.seed,
              saliency_mask=mask)
    save_unet(os.path.join(args.save_path, "final.pt"), unet)
    print(f"done: {args.save_path}")


if __name__ == "__main__":
    main()
