"""Export the CIFAR-10 training images without one class, the FID reference
of the evaluation stage (DDPM/save_base_dataset.py), with the flags of
``cli/save_base_dataset.py``.

Run as ``python -m uurg_torch.cli.save_base_dataset --label_to_forget 0
--as_npz``: one ``<out>.npz`` (``arr_0``, uint8 NHWC), or without
``--as_npz`` a folder of ``<label>_<index>.png`` files (Pillow needed).
Without CIFAR-10 under ``--data_path`` it writes the synthetic stand-in the
smoke runs use (2,048 images of base seed 0, rounded to uint8), as the JAX
CLI does. Needs no GPU and no JAX.
"""
from __future__ import annotations

import argparse
import logging
import os


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--data_path", type=str, default="./data")
    p.add_argument("--label_to_forget", type=int, default=0)
    p.add_argument("--out", type=str, default="")
    p.add_argument("--as_npz", action="store_true",
                   help="write one npz instead of PNG files (faster IO)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    import numpy as np

    from uurg_torch.data.datasets import load_cifar10, synthetic_dataset
    from uurg_torch.data.splits import class_forget_split

    try:
        ds = load_cifar10(args.data_path, train=True)
    except FileNotFoundError:
        logging.warning("CIFAR-10 not found under %s — synthetic fallback "
                        "(same distribution the smoke-train runners use)",
                        args.data_path)
        ds = synthetic_dataset(2048, 32, 3, 10, base_seed=0)
        ds.images = (ds.images * 255).round().astype(np.uint8)
    remain, _ = class_forget_split(ds, args.label_to_forget)
    out = args.out or f"cifar10_without_label_{args.label_to_forget}"
    if args.as_npz:
        np.savez_compressed(out if out.endswith(".npz") else out + ".npz",
                            arr_0=remain.images)
        print(f"wrote {len(remain)} images -> {out}.npz")
        return
    from PIL import Image

    os.makedirs(out, exist_ok=True)
    for i, (img, lab) in enumerate(zip(remain.images, remain.labels)):
        Image.fromarray(img).save(
            os.path.join(out, f"{int(lab)}_{i:06d}.png"))
    print(f"wrote {len(remain)} images -> {out}/")


if __name__ == "__main__":
    main()
