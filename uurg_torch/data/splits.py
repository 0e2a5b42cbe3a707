"""Forget/remain splitting and class-list parsing (port of
``uurg_tpu/data/splits.py``).

- class split: DDPM/dataset/__init__.py:120-177 get_forget_dataset.
- random split with persisted indices: Classification/dataset/cifar10.py
  :76-99 (``random_idx.npy``, so retrain and unlearn runs share the split).
The numpy streams are the JAX package's: same seed, same split.
"""
from __future__ import annotations

import os

import numpy as np

from uurg_torch.data.arrays import ArrayDataset


def class_forget_split(ds: ArrayDataset, label_to_forget: int
                       ) -> tuple[ArrayDataset, ArrayDataset]:
    """(remain, forget), each in dataset order (DDPM/dataset/__init__.py
    :120-177 get_forget_dataset)."""
    forget_idx = np.where(ds.labels == label_to_forget)[0]
    remain_idx = np.where(ds.labels != label_to_forget)[0]
    return ds.subset(remain_idx), ds.subset(forget_idx)


def random_forget_split(ds: ArrayDataset, forget_ratio: float, seed: int,
                        save_path: str | None = None
                        ) -> tuple[ArrayDataset, ArrayDataset]:
    """(remain, forget) for random subset forgetting: the first
    ``int(n * forget_ratio)`` of a seeded permutation, persisted to and
    reused from ``<save_path>/random_idx.npy``."""
    n = len(ds)
    n_forget = int(n * forget_ratio)
    idx_file = os.path.join(save_path, "random_idx.npy") if save_path else None
    if idx_file and os.path.exists(idx_file):
        forget_idx = np.load(idx_file)
    else:
        forget_idx = np.random.default_rng(seed).permutation(n)[:n_forget]
        if idx_file:
            os.makedirs(save_path, exist_ok=True)
            np.save(idx_file, forget_idx)
    mask = np.zeros(n, dtype=bool)
    mask[forget_idx] = True
    return ds.subset(np.where(~mask)[0]), ds.subset(np.where(mask)[0])


def incremental_random_split(ds: ArrayDataset, forget_ratio: float,
                             num_stages: int, seed: int,
                             save_path: str | None = None
                             ) -> list[tuple[ArrayDataset, ArrayDataset]]:
    """Incremental unlearning stages (Classification/dataset/cifar10.py
    IncrementalRandomUnlearn): one persisted permutation
    (``incremental_idx.npy``), cumulative forget sets of ``i / num_stages``
    of the forget ratio at stage ``i``. Returns ``[(remain_i, forget_i)]``.
    """
    n = len(ds)
    total_forget = int(n * forget_ratio)
    idx_file = (os.path.join(save_path, "incremental_idx.npy")
                if save_path else None)
    if idx_file and os.path.exists(idx_file):
        order = np.load(idx_file)
    else:
        order = np.random.default_rng(seed).permutation(n)[:total_forget]
        if idx_file:
            os.makedirs(save_path, exist_ok=True)
            np.save(idx_file, order)
    stages = []
    for i in range(1, num_stages + 1):
        mask = np.zeros(n, dtype=bool)
        mask[order[:total_forget * i // num_stages]] = True
        stages.append((ds.subset(np.where(~mask)[0]),
                       ds.subset(np.where(mask)[0])))
    return stages


def create_class_labels(spec: str, n_classes: int = 10):
    """Parse the reference's class-list syntax
    (DDPM/functions/__init__.py:120-134): "1,2,3" selects classes; any
    "x<k>" entries EXCLUDE those classes from range(n_classes).
    Returns (class_list, excluded_list)."""
    parts = spec.split(",")
    if any(x.startswith("x") for x in parts):
        excluded = [int(x[1:]) for x in parts if x.startswith("x")]
        classes = [c for c in range(n_classes) if c not in excluded]
    else:
        excluded = []
        classes = [int(x) for x in parts]
    return classes, excluded
