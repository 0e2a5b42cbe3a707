"""Class-list parsing (port of ``uurg_tpu/data/splits.py::create_class_labels``)."""
from __future__ import annotations


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
