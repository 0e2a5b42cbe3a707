"""Host-side array datasets, shuffled batchers and the classification
augmentation.

This package's own copy of the numpy code in ``uurg_tpu/data/arrays.py``
that the DDPM trainer and the classification methods use (the reference's
DataLoader + ``cycle()`` idiom): datasets are in-memory numpy arrays,
batches come from a shuffled index stream. Same seed, same batches and the
same augmentation as the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Iterator

import numpy as np


@dataclasses.dataclass
class ArrayDataset:
    """Images NHWC uint8 or float32 in [0,1]; labels int."""

    images: np.ndarray
    labels: np.ndarray

    def __post_init__(self):
        if len(self.images) != len(self.labels):
            raise ValueError(f"{len(self.images)} images but "
                             f"{len(self.labels)} labels")

    def __len__(self) -> int:
        return len(self.images)

    def subset(self, idx: np.ndarray) -> "ArrayDataset":
        return ArrayDataset(self.images[idx], self.labels[idx])

    def images_f32(self) -> np.ndarray:
        if self.images.dtype == np.uint8:
            return self.images.astype(np.float32) / 255.0
        return self.images.astype(np.float32)

    def get_batch(self, idx: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """(float32 [0,1] images, int32 labels) for these indices."""
        x = self.images[idx]
        if x.dtype == np.uint8:
            x = x.astype(np.float32) / 255.0
        else:
            x = x.astype(np.float32)
        return x, self.labels[idx].astype(np.int32)


def random_flip_batch(x: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Horizontal random flip, per-sample (data.random_flip: true)."""
    flip = rng.random(len(x)) < 0.5
    x = x.copy()
    x[flip] = x[flip, :, ::-1, :]
    return x


def pad_crop_batch(x: np.ndarray, pad: int,
                   rng: np.random.Generator) -> np.ndarray:
    """Random crop after zero padding (the classification augmentation), one
    gather for the whole batch: offsets in [0, 2 pad] a sample, rows then
    columns, drawn from ``rng`` in that order."""
    n, h, w, c = x.shape
    padded = np.zeros((n, h + 2 * pad, w + 2 * pad, c), x.dtype)
    padded[:, pad:-pad, pad:-pad, :] = x
    ys = rng.integers(0, 2 * pad + 1, n)
    xs = rng.integers(0, 2 * pad + 1, n)
    rows = ys[:, None] + np.arange(h)[None, :]          # (n, h)
    cols = xs[:, None] + np.arange(w)[None, :]          # (n, w)
    return padded[np.arange(n)[:, None, None],
                  rows[:, :, None], cols[:, None, :], :]


def epoch_batches(
    ds: ArrayDataset,
    batch_size: int,
    *,
    shuffle: bool = False,
    seed: int = 0,
    drop_last: bool = False,
    transform: Callable | None = None,
) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """One pass over the dataset (Fisher accumulation, eval)."""
    rng = np.random.default_rng(seed)
    idx = np.arange(len(ds))
    if shuffle:
        rng.shuffle(idx)
    end = len(idx) - (len(idx) % batch_size) if drop_last else len(idx)
    for start in range(0, end, batch_size):
        x, y = ds.get_batch(idx[start:start + batch_size])
        if transform is not None:
            x = transform(x, rng)
        yield x, y


def infinite_batches(
    ds: ArrayDataset,
    batch_size: int,
    *,
    seed: int = 0,
    transform: Callable | None = None,
) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """Infinite reshuffled stream (the ``cycle(DataLoader)`` replacement).
    A dataset smaller than a batch (a forget split under a large batch) is
    wrapped so every batch has the full size and every sample appears."""
    rng = np.random.default_rng(seed)
    n = len(ds)
    while True:
        perm = rng.permutation(n)
        if n < batch_size:
            x, y = ds.get_batch(np.resize(perm, batch_size))
            if transform is not None:
                x = transform(x, rng)
            yield x, y
            continue
        for start in range(0, n - batch_size + 1, batch_size):
            x, y = ds.get_batch(perm[start:start + batch_size])
            if transform is not None:
                x = transform(x, rng)
            yield x, y
