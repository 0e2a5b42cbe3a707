"""Generative-metric evaluator CLI, the flags of ``cli/evaluator.py``
(DDPM/evaluator.py) plus ``--device``.

Run as ``python -m uurg_torch.cli.evaluator REF SAMPLES
[--inception_weights W.npz]``: Inception Score, FID, sFID, precision and
recall of a sample folder or npz against a reference one, printed and
appended to ``--csv``. ``--inception_weights`` is the JAX package's
flax-layout npz (``cli/convert_inception.py`` writes it); without it the
InceptionV3 is a seeded random init and the metrics are not comparable to
published numbers. Pillow is needed only to read a folder of images.
"""
from __future__ import annotations

import argparse
import csv
import logging
import os

import numpy as np


def load_images(path: str) -> np.ndarray:
    """Folder of PNG/JPEG files or an .npz with key 'arr_0' -> uint8 NHWC."""
    if path.endswith(".npz"):
        return np.load(path)["arr_0"]
    from PIL import Image

    files = sorted(
        f for f in os.listdir(path)
        if f.lower().endswith((".png", ".jpg", ".jpeg")))
    if not files:
        raise FileNotFoundError(f"no images in {path}")
    return np.stack([np.asarray(Image.open(os.path.join(path, f))
                                .convert("RGB"), np.uint8) for f in files])


def append_csv(path: str, row: dict) -> None:
    """Append ``row`` to the CSV at ``path``, with a header line when the
    file is new."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    write_header = not os.path.exists(path)
    with open(path, "a", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(row))
        if write_header:
            w.writeheader()
        w.writerow(row)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("ref_batch", type=str,
                   help="reference images (folder or npz)")
    p.add_argument("sample_batch", type=str,
                   help="generated images (folder or npz)")
    p.add_argument("--inception_weights", type=str, default="",
                   help="InceptionV3 weights: the JAX package's .npz "
                        "(flax layout) or pytorch-fid's pt_inception .pth")
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--csv", type=str,
                   default="results/cifar10/forget/result.csv")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; fails without a GPU) or cpu")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    from uurg_torch.core.device import resolve_device
    from uurg_torch.eval.generative import evaluate_all
    from uurg_torch.eval.inception import load_inception, make_extractor

    device = resolve_device(args.device)
    extractor = make_extractor(load_inception(args.inception_weights)
                               .to(device), materialize=False)

    ref = load_images(args.ref_batch)
    sample = load_images(args.sample_batch)
    metrics = evaluate_all(extractor, ref, sample, args.batch_size)

    print("Inception Score:", metrics["inception_score"])
    print("FID:", metrics["fid"])
    print("sFID:", metrics["sfid"])
    print("Precision:", metrics["precision"])
    print("Recall:", metrics["recall"])
    append_csv(args.csv, {"ref": args.ref_batch, "sample": args.sample_batch,
                          **metrics})


if __name__ == "__main__":
    main()
