"""Fisher-ratio masks from saved Fishers, the flags of
``cli/generate_fisher_mask.py`` (DDPM/generate_fisher_mask.py:17-48).

    python -m uurg_torch.cli.generate_fisher_mask --ckpt_folder DIR \\
        --threshold 1.0 0.5

Thresholds ``(F_forget + eps) / (F_remain + eps) >= th`` over the
``forget_fisher`` and ``remain_fisher`` files that ``--mode
generate_fisher`` wrote to DIR, without recomputing them, and writes
``DIR/fisher_<th>`` for each threshold. The SD layout (``nude_forget``,
``nude_remain``) comes with the SD slice.
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
    folder = args.ckpt_folder
    if os.path.exists(os.path.join(folder, "nude_forget")):
        raise NotImplementedError(
            f"{folder} holds SD Fishers (nude_forget, nude_remain); their "
            f"masks come with the SD slice")
    if not os.path.exists(os.path.join(folder, "forget_fisher")):
        raise SystemExit(f"no Fisher files in {folder}: expected "
                         f"forget_fisher and remain_fisher")
    from uurg_torch.workloads import ddpm_runner as R

    R.generate_fisher_mask(folder, args.threshold, device=args.device)
    print(f"done: {folder}")


if __name__ == "__main__":
    main()
