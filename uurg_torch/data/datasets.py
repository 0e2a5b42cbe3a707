"""Dataset loaders for the DDPM slice: the CIFAR-10 pickle reader, the
synthetic stand-in and the image-folder reader.

This package's own copy of the numpy code in ``uurg_tpu/data/datasets.py``
(``synthetic_dataset``, ``load_cifar10``, ``load_image_folder``). Same seed,
same arrays. Pillow is imported at the call, so only the folder reader
needs it.
"""
from __future__ import annotations

import os
import pickle
from typing import Sequence

import numpy as np

from uurg_torch.data.arrays import ArrayDataset


def synthetic_dataset(n: int = 512, resolution: int = 32, channels: int = 3,
                      n_classes: int = 10, seed: int = 0,
                      base_seed: int | None = None,
                      class_affinity: float = 0.0,
                      noise_sigma: float = 0.1) -> ArrayDataset:
    """Class-structured fake images: each class has a distinct mean pattern
    so unlearning logic is exercised without a download.

    ``base_seed`` fixes the per-class mean patterns independently of the
    sample draw (pass the same one to share one class distribution between
    splits); with None they come from the label-advanced ``seed`` stream.
    ``class_affinity`` blends each class mean toward its ring successor;
    ``noise_sigma`` is the per-sample Gaussian noise around the mean."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, n_classes, n).astype(np.int64)
    base_rng = rng if base_seed is None else np.random.default_rng(base_seed)
    base = base_rng.random(
        (n_classes, resolution, resolution, channels)).astype(np.float32)
    if class_affinity > 0.0:
        a = float(class_affinity)
        base = (1.0 - a) * base + a * np.roll(base, -1, axis=0)
    noise = rng.normal(0, noise_sigma,
                       (n, resolution, resolution, channels))
    images = np.clip(base[labels] + noise.astype(np.float32), 0, 1)
    return ArrayDataset(images, labels)


def load_cifar10(root: str, train: bool = True) -> ArrayDataset:
    """Read cifar-10-batches-py pickle files -> NHWC uint8. The files are
    the dataset's own; unpickling runs code, so point ``root`` only at a
    trusted copy."""
    d = os.path.join(root, "cifar-10-batches-py")
    files = ([f"data_batch_{i}" for i in range(1, 6)] if train
             else ["test_batch"])
    xs, ys = [], []
    for fname in files:
        with open(os.path.join(d, fname), "rb") as f:
            entry = pickle.load(f, encoding="latin1")
        xs.append(entry["data"])
        ys.extend(entry.get("labels", entry.get("fine_labels")))
    x = np.concatenate(xs).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    return ArrayDataset(np.ascontiguousarray(x), np.asarray(ys, np.int64))


def load_image_folder(root: str, resolution: int,
                      class_names: Sequence[str] | None = None,
                      center_crop: bool = True) -> ArrayDataset:
    """ImageFolder-style loader (a subdirectory a class) -> NHWC uint8.

    ``class_names`` restricts the classes loaded while keeping the class to
    index map of ALL sorted subdirectories (DiT/unlearn_dataset.py:37-292
    TargetedImageFolder). Raises ``FileNotFoundError`` when no image is
    found."""
    from PIL import Image

    all_classes = sorted(
        d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d)))
    class_to_idx = {c: i for i, c in enumerate(all_classes)}
    wanted = class_names if class_names is not None else all_classes
    xs, ys = [], []
    for cname in wanted:
        cdir = os.path.join(root, cname)
        for fname in sorted(os.listdir(cdir)):
            if not fname.lower().endswith((".png", ".jpg", ".jpeg", ".webp")):
                continue
            img = Image.open(os.path.join(cdir, fname)).convert("RGB")
            if center_crop:
                img = _center_crop_resize(img, resolution)
            else:
                img = img.resize((resolution, resolution), Image.BICUBIC)
            xs.append(np.asarray(img, np.uint8))
            ys.append(class_to_idx[cname])
    if not xs:
        raise FileNotFoundError(f"no images under {root}")
    return ArrayDataset(np.stack(xs), np.asarray(ys, np.int64))


def _center_crop_resize(img, size: int):
    """ADM-style center crop (DiT/forget.py center_crop_arr): halve with a
    box filter while the short side is at least twice ``size``, resize
    bicubic so the short side is ``size``, crop the center."""
    from PIL import Image

    while min(img.size) >= 2 * size:
        img = img.resize((img.size[0] // 2, img.size[1] // 2), Image.BOX)
    scale = size / min(img.size)
    img = img.resize((round(img.size[0] * scale), round(img.size[1] * scale)),
                     Image.BICUBIC)
    arr = np.asarray(img)
    y = (arr.shape[0] - size) // 2
    x = (arr.shape[1] - size) // 2
    return Image.fromarray(arr[y:y + size, x:x + size])
