"""SD proximal-gradient erasure, the flags of ``cli/proximal_gradient.py``
(SD/train-scripts/proximal_gradient.py) plus ``--device``: the
gradient-ascent loss over every parameter, each step followed by the L1
prox that shrinks the move from the starting weights at the top
``--top_ratio`` of their magnitudes, then ``<save_path>/final.pt`` (a
CompVis checkpoint that ``--ckpt_path`` reads back).

    python -m uurg_torch.cli.proximal_gradient --forget_data NSFW \\
        --remain_data CLOTHED --n_iters 1000 --save_path OUT
"""
from __future__ import annotations

import argparse
import logging


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--forget_data", type=str, default="data/nsfw")
    p.add_argument("--remain_data", type=str, default="data/not-nsfw")
    p.add_argument("--forget_prompt", type=str,
                   default="a photo of a nude person")
    p.add_argument("--remain_prompt", type=str,
                   default="a photo of a person wearing clothes")
    p.add_argument("--n_iters", type=int, default=1000)
    p.add_argument("--lr", type=float, default=1e-5)
    p.add_argument("--remain_alpha", type=float, default=1.0)
    p.add_argument("--top_ratio", type=float, default=0.01)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--image_size", type=int, default=512)
    p.add_argument("--ckpt_path", type=str, default="",
                   help="a CompVis sd-v1 .ckpt/.pt/.pth (the UNet is read)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--save_path", type=str, default="results/sd/proximal")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; fails without a GPU) or cpu")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    from uurg_torch.cli.sd_common import run_paired_method
    from uurg_torch.workloads.sd_runner import proximal_gradient

    run_paired_method(args, proximal_gradient, top_ratio=args.top_ratio)
    print(f"done: {args.save_path}")


if __name__ == "__main__":
    main()
