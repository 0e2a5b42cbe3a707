"""SD classifier evaluation CLI, the flags of ``cli/imageclassify.py``
(SD/eval-scripts/imageclassify.py) plus ``--device``: the top-k classes of
each image of a folder, as a CSV.

    python -m uurg_torch.cli.imageclassify --folder_path IMAGES \\
        --save_path topk.csv --classifier_ckpt CLASSIFIER.pth

The classifier is ``create_model(--model, --num_classes)`` as the JAX CLI
builds it (ResNet50 with the CIFAR stem by default) on images resized to
224 px. ``--classifier_ckpt`` is a torch ``.pth`` in torchvision or
reference-CIFAR layout, loaded strictly; an Orbax directory of the JAX
package raises (it needs JAX to read). Without one the classifier is a
seeded random init and its class ids mean nothing.
"""
from __future__ import annotations

import argparse
import csv
import logging
import os

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--folder_path", type=str, required=True)
    p.add_argument("--save_path", type=str, required=True,
                   help="output CSV (image, topk classes)")
    p.add_argument("--classifier_ckpt", type=str, default="",
                   help="torch .pth classifier checkpoint; random init if "
                        "empty")
    p.add_argument("--model", type=str, default="ResNet50")
    p.add_argument("--num_classes", type=int, default=10)
    p.add_argument("--topk", type=int, default=5)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; fails without a GPU) or cpu")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    import torch
    from PIL import Image

    from uurg_torch.core.device import resolve_device
    from uurg_torch.eval.classifier_eval import topk_classification
    from uurg_torch.io.tv_resnet_interop import load_torch_resnet_checkpoint
    from uurg_torch.models import create_model, init_classifier

    device = resolve_device(args.device)
    model = create_model(args.model, args.num_classes)
    if args.classifier_ckpt:
        model.load_state_dict(
            load_torch_resnet_checkpoint(args.classifier_ckpt), strict=True)
    else:
        init_classifier(torch.Generator().manual_seed(0), model)
        logging.warning("random-init classifier — class ids are not "
                        "meaningful without a trained checkpoint")
    model = model.to(device).eval()

    names = sorted(f for f in os.listdir(args.folder_path)
                   if f.lower().endswith((".png", ".jpg", ".jpeg")))
    imgs = np.stack([
        np.asarray(Image.open(os.path.join(args.folder_path, f))
                   .convert("RGB"), np.uint8) for f in names])
    topk = topk_classification(model, imgs, k=args.topk,
                               batch_size=args.batch_size, device=device)

    os.makedirs(os.path.dirname(args.save_path) or ".", exist_ok=True)
    with open(args.save_path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["image"] + [f"top{i+1}" for i in range(args.topk)])
        for name, row in zip(names, topk):
            w.writerow([name] + [int(c) for c in row])
    print(f"wrote {args.save_path} ({len(names)} images)")


if __name__ == "__main__":
    main()
