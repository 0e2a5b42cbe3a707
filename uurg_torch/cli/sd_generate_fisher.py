"""SD Fisher diagonals and saliency masks, the flags of
``cli/sd_generate_fisher.py`` (SD/train-scripts/generate_fisher.py +
generate_fisher_mask.py) plus ``--device``: the squared gradients of the
CFG-composed eps loss averaged over ``--n_batches`` batches of the nsfw and
of the not-nsfw folder, then the Fisher-ratio masks. Writes
``<save_path>/nude_forget``, ``nude_remain`` and ``nude_mask_<th>`` (the
JAX CLI's names; ``torch.save`` files of named tensors,
:mod:`uurg_torch.io.checkpoint`).

    python -m uurg_torch.cli.sd_generate_fisher --nsfw_data NSFW \\
        --not_nsfw_data CLOTHED --n_batches 50 --save_path OUT
"""
from __future__ import annotations

import argparse
import logging
import os


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--nsfw_data", type=str, default="data/nsfw")
    p.add_argument("--not_nsfw_data", type=str, default="data/not-nsfw")
    p.add_argument("--forget_prompt", type=str,
                   default="a photo of a nude person")
    p.add_argument("--remain_prompt", type=str,
                   default="a photo of a person wearing clothes")
    p.add_argument("--guidance_scale", type=float, default=3.0)
    p.add_argument("--n_batches", type=int, default=50)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--image_size", type=int, default=512)
    p.add_argument("--ckpt_path", type=str, default="",
                   help="a CompVis sd-v1 .ckpt/.pt/.pth (the UNet is read)")
    p.add_argument("--threshold", type=float, nargs="+", default=[0.5])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--save_path", type=str, default="results/sd/fisher")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; fails without a GPU) or cpu")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    from uurg_torch.cli.sd_common import (latent_prompt_batches,
                                          load_images_or_synthetic,
                                          setup_workload)
    from uurg_torch.io.checkpoint import save_checkpoint
    from uurg_torch.unlearn.fisher import accumulate_fisher
    from uurg_torch.unlearn.saliency import fisher_ratio_mask, mask_sparsity

    wl, unet = setup_workload(args, args.device)
    loss = wl.fisher_loss_fn(args.guidance_scale)
    os.makedirs(args.save_path, exist_ok=True)

    fishers = {}
    for name, folder, prompt in (
            ("forget", args.nsfw_data, args.forget_prompt),
            ("remain", args.not_nsfw_data, args.remain_prompt)):
        imgs = load_images_or_synthetic(folder, args.image_size, args.seed)
        it = latent_prompt_batches(wl, imgs, prompt, args.batch_size,
                                   args.seed, extra_prompt="")
        fishers[name] = accumulate_fisher(loss, unet, it, args.seed,
                                          num_batches=args.n_batches)
        save_checkpoint(os.path.join(args.save_path, f"nude_{name}"),
                        fishers[name])
        logging.info("saved %s fisher", name)

    for th in args.threshold:
        mask = fisher_ratio_mask(fishers["forget"], fishers["remain"], th)
        logging.info("th %.3g sparsity %.2f%%", th,
                     mask_sparsity(mask) * 100)
        save_checkpoint(os.path.join(args.save_path, f"nude_mask_{th}"),
                        mask)
    print(f"done: {args.save_path}")


if __name__ == "__main__":
    main()
