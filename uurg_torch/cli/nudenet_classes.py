"""NudeNet evaluation CLI, the flags of ``cli/nudenet_classes.py``
(SD/eval-scripts/nudenet-classes.py): the nudity classes detected in each
image of a folder, as a CSV.

    python -m uurg_torch.cli.nudenet_classes --folder IMAGES \\
        --save_path classes.csv [--model_path 320n.onnx] [--threshold 0.6]

The detector, in this order: ``--model_path`` ending in ``.npz`` is a
file of recorded YOLO heads (image basename -> (1, 4 + C, anchors)) that
stands in for the network, everything else running as it would;
another ``--model_path`` is a local NudeNet ``320n.onnx`` run through
``onnxruntime`` with :mod:`uurg_torch.eval.nudenet`'s pre- and
post-processing; without one, the ``nudenet`` package. The folders
``uurg_torch.cli.generate_images`` writes are read as they are. No card
work: the detector runs on the host.
"""
from __future__ import annotations

import argparse
import csv
import os
import sys


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--folder", type=str, required=True)
    p.add_argument("--csv_path", type=str, default="",
                   help="prompt csv to join case numbers against")
    p.add_argument("--save_path", type=str, required=True)
    p.add_argument("--threshold", type=float, default=0.0)
    p.add_argument("--model_path", type=str, default="",
                   help="local NudeNet detector .onnx (needs onnxruntime), "
                        "or an .npz of recorded heads")
    return p.parse_args(argv)


def make_detector(model_path: str):
    """``detect(path) -> [{'class', 'score', 'box'}]`` of the first tier
    that applies (see the module's docstring)."""
    from uurg_torch.eval.nudenet import make_npz_detector, make_onnx_detector

    if model_path.endswith(".npz"):
        return make_npz_detector(model_path)
    if model_path:
        return make_onnx_detector(model_path)
    try:
        from nudenet import NudeDetector
    except ImportError:
        sys.exit(
            "nudenet is not installed; either install it (+ weights) "
            "or pass --model_path <320n.onnx> with onnxruntime "
            "available (SD/eval-scripts/nudenet-classes.py parity).")
    return NudeDetector().detect


def main(argv=None):
    args = parse_args(argv)
    detect = make_detector(args.model_path)
    rows = []
    for fname in sorted(os.listdir(args.folder)):
        if not fname.lower().endswith((".png", ".jpg", ".jpeg")):
            continue
        dets = detect(os.path.join(args.folder, fname))
        labels = [d["class"] for d in dets
                  if d.get("score", 1.0) >= args.threshold]
        rows.append({"image": fname, "classes": ";".join(labels)})
    with open(args.save_path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["image", "classes"])
        w.writeheader()
        w.writerows(rows)
    print(f"wrote {args.save_path} ({len(rows)} images)")


if __name__ == "__main__":
    main()
