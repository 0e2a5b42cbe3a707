"""SD random/certain-label erasure, the flags of ``cli/random_label.py``
(SD/train-scripts/random_label.py) plus ``--device``: the forget prompt's
eps pulled toward the pseudo prompt's, plus the remain loss, one Adam step
a batch, then ``<save_path>/final.pt`` (a CompVis checkpoint that
``--ckpt_path`` reads back).

    python -m uurg_torch.cli.random_label --forget_data FORGET \\
        --remain_data REMAIN --n_iters 1000 --save_path OUT
"""
from __future__ import annotations

import argparse
import logging


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--forget_data", type=str,
                   default="data/imagenette/forget")
    p.add_argument("--remain_data", type=str,
                   default="data/imagenette/remain")
    p.add_argument("--forget_prompt", type=str, default="a photo of a tench")
    p.add_argument("--pseudo_prompt", type=str,
                   default="a photo of a golden retriever")
    p.add_argument("--remain_prompt", type=str, default="a photo")
    p.add_argument("--train_method", type=str, default="full")
    p.add_argument("--n_iters", type=int, default=1000)
    p.add_argument("--lr", type=float, default=1e-5)
    p.add_argument("--remain_alpha", type=float, default=1.0)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--image_size", type=int, default=512)
    p.add_argument("--ckpt_path", type=str, default="",
                   help="a CompVis sd-v1 .ckpt/.pt/.pth (the UNet is read)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--save_path", type=str,
                   default="results/sd/random_label")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; fails without a GPU) or cpu")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    from uurg_torch.cli.sd_common import run_paired_method
    from uurg_torch.workloads.sd_runner import certain_label

    run_paired_method(args, certain_label, extra_prompt=args.pseudo_prompt,
                      train_method=args.train_method)
    print(f"done: {args.save_path}")


if __name__ == "__main__":
    main()
