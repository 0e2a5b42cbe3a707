"""DiT saliency-mask CLI, the flags of ``cli/dit_generate_mask.py``
(DiT/generate_mask.py:48-56) plus ``--device``: threshold the Fisher ratio
``(F_forget + eps) / (F_remain + eps) >= th`` for each class and threshold
and save ``<mask-path>/<class>/fisher_<th>`` beside the Fisher files
(DiT/generate_mask.py:17-46).

    python -m uurg_torch.cli.dit_generate_mask --mask-path MASKS \\
        --forget-class 0 --thresholds 1.0
"""
from __future__ import annotations

import argparse
import logging
import os


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--mask-path", type=str, required=True,
                   help="dir holding <class>/{forget,remain}_fisher")
    p.add_argument("--forget-class", nargs="+", type=int, required=True)
    p.add_argument("--thresholds", nargs="+", type=float,
                   default=[0.5, 1, 3, 5, 10])
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; fails without a GPU) or cpu")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    from uurg_torch.workloads.dit_runner import dit_generate_mask

    for cls in args.forget_class:
        fisher_dir = os.path.join(args.mask_path, str(cls))
        dit_generate_mask(fisher_dir, args.thresholds, device=args.device)
        logging.info("masks for class %d: %s", cls, fisher_dir)
    print(f"done: {args.mask_path}")


if __name__ == "__main__":
    main()
