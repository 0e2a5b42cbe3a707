"""Dataset loaders for the DDPM slice: the CIFAR-10 pickle reader and the
synthetic stand-in.

This package's own copy of the numpy code in ``uurg_tpu/data/datasets.py``
(``synthetic_dataset``, ``load_cifar10``). Same seed, same arrays.
"""
from __future__ import annotations

import os
import pickle

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
