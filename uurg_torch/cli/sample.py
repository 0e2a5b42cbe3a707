"""DDPM sampling CLI, the flags of ``cli/sample.py`` (DDPM/sample.py:15-103).

Run as ``python -m uurg_torch.cli.sample --config configs/cifar10_sfron.yml
--ckpt_folder RUN_DIR``. Needs PyYAML (config) and Pillow (PNG output).

Modes:
  sample_fid       — n_samples per remaining class -> PNG folder for FID
  sample_classes   — grid of samples for every class
  visualization    — one grid image of all classes
  sample_one_class — n_samples of --class_label -> PNG folder
"""
from __future__ import annotations

import argparse
import logging
import os

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--config", type=str, required=True)
    p.add_argument("--mode", type=str, default="sample_fid",
                   choices=["sample_fid", "sample_classes", "visualization",
                            "sample_one_class"])
    p.add_argument("--class_label", type=int, default=0,
                   help="class sampled by sample_one_class")
    p.add_argument("--ckpt_folder", type=str, required=True)
    p.add_argument("--label_to_forget", type=int, default=-1,
                   help="class excluded from sample_fid (-1 = none)")
    p.add_argument("--cond_scale", type=float, default=2.0)
    p.add_argument("--n_samples_per_class", type=int, default=500)
    p.add_argument("--classes_to_generate", type=str, default="",
                   help="reference class-list syntax, e.g. '1,2' or 'x0' "
                        "(exclude class 0)")
    p.add_argument("--sample_steps", "--timesteps", type=int, default=50)
    p.add_argument("--sampler", type=str, default="ddim",
                   choices=["ddim", "ddpm"])
    p.add_argument("--sample_type", type=str, default="",
                   choices=["", "generalized", "ddpm_noisy"],
                   help="reference name for --sampler (generalized=ddim)")
    p.add_argument("--skip_type", type=str, default="uniform",
                   choices=["uniform", "quad"])
    p.add_argument("--eta", type=float, default=0.0)
    p.add_argument("--sequence", action="store_true",
                   help="accepted for reference parity")
    # EMA params by default (the reference samples the EMA shadow);
    # --no_ema samples the raw params
    p.add_argument("--use_ema", action=argparse.BooleanOptionalAction,
                   default=True)
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--out", type=str, default="")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; fails without a GPU) or cpu")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    from uurg_torch.core.config import load_config
    from uurg_torch.parallel import initialize_distributed, rank
    from uurg_torch.utils.images import save_grid, save_png_folder
    from uurg_torch.workloads import ddpm_runner as R
    from uurg_torch.workloads.ddpm import DDPMWorkload

    initialize_distributed(device=args.device)

    config = load_config(args.config)
    wl = DDPMWorkload.from_config(config, device=args.device)
    model = R.load_params(args, config, wl, use_ema=args.use_ema)
    out = args.out or os.path.join(args.ckpt_folder, "samples", args.mode)

    if args.sample_type:
        args.sampler = "ddpm" if args.sample_type == "ddpm_noisy" else "ddim"

    n_classes = config.data.n_classes
    grid = args.mode not in ("sample_one_class", "sample_fid")
    if args.mode == "sample_one_class":
        labels = np.full(args.n_samples_per_class, args.class_label, np.int64)
    elif args.mode == "sample_fid":
        if args.classes_to_generate:
            from uurg_torch.data.splits import create_class_labels

            classes, _ = create_class_labels(args.classes_to_generate,
                                             n_classes)
        else:
            classes = [c for c in range(n_classes)
                       if c != args.label_to_forget]
        labels = np.repeat(classes, args.n_samples_per_class)
    else:
        per = 10 if args.mode == "visualization" else args.n_samples_per_class
        labels = np.tile(np.arange(n_classes), per)
    # under a process group every rank samples its rows of each batch and
    # gets the whole array; rank 0 writes it
    imgs = R.sample_images(args, config, model, labels,
                           num_steps=args.sample_steps, method=args.sampler,
                           cond_scale=args.cond_scale, seed=args.seed)
    if rank() == 0:
        if grid:
            os.makedirs(out, exist_ok=True)
            save_grid(imgs, os.path.join(out, "grid.png"), ncol=n_classes)
        else:
            save_png_folder(imgs, labels, out)
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
