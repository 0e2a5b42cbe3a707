"""Fisher-ratio masks from saved Fishers, the flags of
``cli/generate_fisher_mask.py`` (DDPM/generate_fisher_mask.py:17-48 and
SD/train-scripts/generate_fisher_mask.py:17-48) plus ``--device``.

    python -m uurg_torch.cli.generate_fisher_mask --ckpt_folder DIR \\
        --threshold 1.0 0.5

Thresholds ``(F_forget + eps) / (F_remain + eps) >= th`` over the Fishers
in DIR, without recomputing them, and writes one mask a threshold beside
them. The layout is read from the files DIR holds: ``forget_fisher`` and
``remain_fisher`` (``--mode generate_fisher``, the DiT Fisher CLI) give
``fisher_<th>``; ``nude_forget`` and ``nude_remain``
(``sd_generate_fisher``) give ``nude_mask_<th>``.
"""
from __future__ import annotations

import argparse
import logging
import os


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--ckpt_folder", type=str, required=True,
                   help="Path to fisher ckpt path")
    p.add_argument("--threshold", type=float, nargs="+", default=[1.0],
                   help="Saliency map threshold, lambda in paper")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; fails without a GPU) or cpu")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    from uurg_torch.workloads import ddpm_runner as R

    folder = args.ckpt_folder
    # the port's Fishers are files (the JAX package's, Orbax directories)
    layout = next((name for name, (files, _) in R.FISHER_LAYOUTS.items()
                   if os.path.exists(os.path.join(folder, files[0]))), None)
    if layout is None:
        raise SystemExit(
            f"no Fisher files in {folder}: expected forget_fisher and "
            f"remain_fisher (DDPM, DiT) or nude_forget and nude_remain (SD)")
    R.generate_fisher_mask(folder, args.threshold, device=args.device,
                           layout=layout)
    print(f"done: {folder}")


if __name__ == "__main__":
    main()
