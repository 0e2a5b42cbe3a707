"""Disk-backed DiT datasets that never hold the corpus in RAM.

Port of ``uurg_tpu/data/lazy.py``, the same numpy code, so a reader given
the same files, seed and filter yields the same batches bit for bit:

- ``LazyImageFolder``: a (path, label) index built up front, images
  decoded per batch (Pillow, imported at the call); the same ``labels``,
  ``subset`` and ``get_batch`` surface as ``ArrayDataset``, so
  ``class_forget_split`` and the batchers take it unchanged. The DiT CLIs
  encode its batches with the frozen VAE.
- latent shards: ``write_latent_shards`` streams (latents, labels) batches
  into fixed-size npz shard files; ``sharded_latent_batches`` is an
  infinite shuffled reader that holds ONE shard in RAM at a time
  (shard-order and in-shard shuffling, per-host strided slicing like
  DiT/sample_ddp.py:94-104 shards by rank).
"""
from __future__ import annotations

import glob
import os
from typing import Iterator, Sequence

import numpy as np

_EXTS = (".png", ".jpg", ".jpeg", ".webp")


class LazyImageFolder:
    """ImageFolder with per-batch decoding: a subdirectory a class, the
    global class -> index map kept under ``class_names`` (as
    DiT/unlearn_dataset.py's TargetedImageFolder does)."""

    def __init__(self, root: str, resolution: int,
                 class_names: Sequence[str] | None = None,
                 center_crop: bool = True,
                 paths: np.ndarray | None = None,
                 labels: np.ndarray | None = None):
        self.resolution = resolution
        self.center_crop = center_crop
        if paths is not None:
            self.paths, self.labels = paths, labels
            return
        all_classes = sorted(
            d for d in os.listdir(root)
            if os.path.isdir(os.path.join(root, d)))
        class_to_idx = {c: i for i, c in enumerate(all_classes)}
        wanted = class_names if class_names is not None else all_classes
        ps, ys = [], []
        for cname in wanted:
            cdir = os.path.join(root, cname)
            for fname in sorted(os.listdir(cdir)):
                if fname.lower().endswith(_EXTS):
                    ps.append(os.path.join(cdir, fname))
                    ys.append(class_to_idx[cname])
        if not ps:
            raise FileNotFoundError(f"no images under {root}")
        self.paths = np.asarray(ps)
        self.labels = np.asarray(ys, np.int64)

    def __len__(self) -> int:
        return len(self.paths)

    def subset(self, idx: np.ndarray) -> "LazyImageFolder":
        return LazyImageFolder("", self.resolution,
                               center_crop=self.center_crop,
                               paths=self.paths[idx],
                               labels=self.labels[idx])

    def get_batch(self, idx: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Decode just these indices -> (float32 [0, 1] NHWC, int32
        labels): the ADM center crop, or a bicubic resize without
        ``center_crop``."""
        from PIL import Image

        from uurg_torch.data.datasets import _center_crop_resize

        out = np.empty((len(idx), self.resolution, self.resolution, 3),
                       np.float32)
        for i, j in enumerate(np.asarray(idx)):
            img = Image.open(self.paths[j]).convert("RGB")
            if self.center_crop:
                img = _center_crop_resize(img, self.resolution)
            else:
                img = img.resize((self.resolution, self.resolution),
                                 Image.BICUBIC)
            out[i] = np.asarray(img, np.float32) / 255.0
        return out, self.labels[np.asarray(idx)].astype(np.int32)


def write_latent_shards(out_prefix: str,
                        batches: Iterator[tuple[np.ndarray, np.ndarray]],
                        shard_size: int) -> list[str]:
    """Stream (latents, labels) batches into ``<prefix>-NNNNN.npz`` shard
    files of ~shard_size items each. Returns the shard paths."""
    os.makedirs(os.path.dirname(out_prefix) or ".", exist_ok=True)
    paths: list[str] = []
    buf_x: list[np.ndarray] = []
    buf_y: list[np.ndarray] = []
    count = 0

    def flush():
        nonlocal buf_x, buf_y
        if not buf_x:
            return
        path = f"{out_prefix}-{len(paths):05d}.npz"
        np.savez(path, latents=np.concatenate(buf_x),
                 labels=np.concatenate(buf_y))
        paths.append(path)
        buf_x, buf_y = [], []

    for x, y in batches:
        buf_x.append(np.asarray(x))
        buf_y.append(np.asarray(y))
        count += len(x)
        if count >= shard_size:
            flush()
            count = 0
    flush()
    return paths


def list_latent_shards(path: str) -> list[str]:
    """Accepts a shard dir, a glob prefix, or a single npz."""
    if os.path.isdir(path):
        return sorted(glob.glob(os.path.join(path, "*.npz")))
    if path.endswith(".npz"):
        return [path]
    return sorted(glob.glob(path + "-*.npz"))


def sharded_latent_batches(
    shard_paths: Sequence[str],
    batch_size: int,
    *,
    seed: int = 0,
    keep_label=None,
    infinite: bool = True,
    process_index: int = 0,
    process_count: int = 1,
) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """Infinite (or one-epoch) batch stream over npz latent shards, one
    shard resident at a time. ``keep_label`` filters rows (e.g.
    ``lambda y: y != forget_label``); short shard tails roll into the next
    shard so every batch has the full size. Yields float32 latents and
    int32 labels."""
    if not shard_paths:
        raise FileNotFoundError("no latent shards")
    rng = np.random.default_rng(seed)
    carry_x: np.ndarray | None = None
    carry_y: np.ndarray | None = None
    while True:
        order = rng.permutation(len(shard_paths))
        for si in order:
            with np.load(shard_paths[si]) as d:
                x, y = d["latents"], d["labels"]
            if keep_label is not None:
                sel = keep_label(y)
                x, y = x[sel], y[sel]
            if carry_x is not None and len(carry_x):
                x = np.concatenate([carry_x, x])
                y = np.concatenate([carry_y, y])
            perm = rng.permutation(len(x))
            x, y = x[perm], y[perm]
            n_full = len(x) // batch_size * batch_size
            for s in range(0, n_full, batch_size):
                bx = x[s:s + batch_size][process_index::process_count]
                by = y[s:s + batch_size][process_index::process_count]
                yield bx.astype(np.float32), by.astype(np.int32)
            carry_x, carry_y = x[n_full:], y[n_full:]
        if not infinite:
            return
