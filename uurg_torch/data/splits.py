"""Forget/remain splitting and class-list parsing (port of
``uurg_tpu/data/splits.py``: ``class_forget_split``, ``create_class_labels``)."""
from __future__ import annotations

import numpy as np

from uurg_torch.data.arrays import ArrayDataset


def class_forget_split(ds: ArrayDataset, label_to_forget: int
                       ) -> tuple[ArrayDataset, ArrayDataset]:
    """(remain, forget), each in dataset order (DDPM/dataset/__init__.py
    :120-177 get_forget_dataset)."""
    forget_idx = np.where(ds.labels == label_to_forget)[0]
    remain_idx = np.where(ds.labels != label_to_forget)[0]
    return ds.subset(remain_idx), ds.subset(forget_idx)


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
