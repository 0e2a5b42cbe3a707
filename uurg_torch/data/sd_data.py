"""SD data setup over local image folders (SD/train-scripts/dataset.py:
120-176).

Port of ``uurg_tpu/data/sd_data.py``, the same numpy code over the port's
:class:`~uurg_torch.data.lazy.LazyImageFolder` and
:func:`~uurg_torch.data.arrays.infinite_batches`, so the same folders and
seeds give the same batches. The reference pulls Imagenette and the nsfw /
not-nsfw sets through the HF hub; here they are folders:

- Imagenette: ``<root>/<class_name>/*.png``; prompts are "an image of a
  <label>", the reference's descriptions.
- NSFW / not-NSFW: flat folders of images (``data/nsfw``,
  ``data/not-nsfw``).

Each ``setup_*`` returns an infinite stream of (float32 [-1, 1] NHWC
images, labels) batches and the descriptions, as the reference's
(DataLoader, descriptions) pairs.
"""
from __future__ import annotations

import os

import numpy as np

from uurg_torch.data.arrays import infinite_batches
from uurg_torch.data.lazy import _EXTS, LazyImageFolder

# the Imagenette v2 class names (HF frgfm/imagenette label order)
IMAGENETTE_CLASSES = [
    "tench", "English springer", "cassette player", "chain saw", "church",
    "French horn", "garbage truck", "gas pump", "golf ball", "parachute",
]


def _descriptions(class_names) -> list[str]:
    return [f"an image of a {label}" for label in class_names]


def _signed(it):
    for x, y in it:
        yield x * 2.0 - 1.0, y


def _class_names(root: str) -> list[str]:
    return sorted(d for d in os.listdir(root)
                  if os.path.isdir(os.path.join(root, d)))


def setup_data(class_to_forget, batch_size, image_size,
               root="data/imagenette"):
    """The whole train stream and the descriptions (dataset.py:120-129)."""
    ds = LazyImageFolder(root, image_size)
    return (_signed(infinite_batches(ds, batch_size, seed=0)),
            _descriptions(_class_names(root)))


def setup_forget_data(class_to_forget, batch_size, image_size,
                      root="data/imagenette", seed=0):
    """The forget class's stream (dataset.py:156-164)."""
    ds = LazyImageFolder(root, image_size)
    sub = ds.subset(np.where(ds.labels == class_to_forget)[0])
    return (_signed(infinite_batches(sub, batch_size, seed=seed)),
            _descriptions(_class_names(root)))


# gradient ascent reads the same shuffled forget stream (dataset.py:132-141)
setup_ga_data = setup_forget_data


def setup_remain_data(class_to_forget, batch_size, image_size,
                      root="data/imagenette", seed=0):
    """Every class but the forget class (dataset.py:144-153)."""
    ds = LazyImageFolder(root, image_size)
    sub = ds.subset(np.where(ds.labels != class_to_forget)[0])
    return (_signed(infinite_batches(sub, batch_size, seed=seed)),
            _descriptions(_class_names(root)))


def setup_forget_nsfw_data(batch_size, image_size, nsfw_root="data/nsfw",
                           remain_root="data/not-nsfw", seed=0):
    """(forget stream, remain stream) over flat image folders
    (dataset.py:167-176), every image of a folder in one class."""

    def flat(root):
        entries = [os.path.join(root, f) for f in sorted(os.listdir(root))
                   if f.lower().endswith(_EXTS)]
        if not entries:
            raise FileNotFoundError(f"no images under {root}")
        return LazyImageFolder("", image_size, paths=np.asarray(entries),
                               labels=np.zeros(len(entries), np.int64))

    f = _signed(infinite_batches(flat(nsfw_root), batch_size, seed=seed))
    r = _signed(infinite_batches(flat(remain_root), batch_size,
                                 seed=seed + 1))
    return f, r
