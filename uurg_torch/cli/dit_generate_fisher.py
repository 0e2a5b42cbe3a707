"""DiT Fisher-diagonal CLI, the flags of ``cli/dit_generate_fisher.py``
(DiT/generate_fisher.py:296-316) plus ``--device``: the squared gradients of
the diffusion loss averaged over ``--n-iters`` forget and remain batches,
saved as ``<mask-path>/<forget-class>/{forget,remain}_fisher`` (the
reference layout, DiT/generate_fisher.py:251,291; the port's files of named
tensors). ``--data-path`` takes the data tiers of
:mod:`uurg_torch.cli.dit_common`, an image folder included.

    python -m uurg_torch.cli.dit_generate_fisher --data-path SHARDS \\
        --forget-class 0 --mask-path MASKS
"""
from __future__ import annotations

import argparse
import logging
import os


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--data-path", type=str, default="")
    p.add_argument("--results-dir", type=str, default="results/dit")
    p.add_argument("--model", type=str, default="DiT-XL/2")
    p.add_argument("--image-size", type=int, default=256,
                   choices=[256, 512])
    p.add_argument("--num-classes", type=int, default=1000)
    p.add_argument("--n-iters", type=int, default=2000)
    p.add_argument("--batch-size", "--global-batch-size", type=int,
                   default=1, dest="global_batch_size")
    p.add_argument("--seed", "--global-seed", type=int, default=0,
                   dest="global_seed")
    p.add_argument("--vae", type=str, default="ema",
                   help="accepted for reference parity")
    p.add_argument("--num-workers", type=int, default=0,
                   help="accepted for reference parity (host pipeline)")
    p.add_argument("--log-every", type=int, default=100)
    p.add_argument("--ckpt", type=str, default="",
                   help="pretrained DiT checkpoint (reference .pt)")
    p.add_argument("--forget-class", "--label-to-forget", type=int,
                   required=True, dest="label_to_forget")
    p.add_argument("--mask-path", type=str, required=True,
                   help="Fisher files land in <mask-path>/<class>/")
    p.add_argument("--vae_ckpt", type=str, default="",
                   help="the frozen VAE that encodes an image folder: a "
                        "CompVis first-stage .ckpt/.pth or the port's own "
                        ".pt; a seeded init when empty")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; fails without a GPU) or cpu")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    from uurg_torch.cli.dit_common import (build_workload,
                                           forget_remain_iterators)
    from uurg_torch.workloads.dit_runner import dit_generate_fisher

    wl, model = build_workload(args, args.device)
    forget_it, remain_it = forget_remain_iterators(args, args.device)
    out_dir = os.path.join(args.mask_path, str(args.label_to_forget))
    dit_generate_fisher(wl, model, forget_it, remain_it,
                        n_iters=args.n_iters, out_dir=out_dir,
                        seed=args.global_seed)
    logging.info("fisher files: %s", out_dir)
    print(f"done: {out_dir}")


if __name__ == "__main__":
    main()
