"""Latent shards: the disk-backed DiT dataset that never holds the corpus
in RAM.

Port of the latent-shard part of ``uurg_tpu/data/lazy.py``, the same numpy
code, so a reader given the same shards, seed and filter yields the same
batches bit for bit. ``write_latent_shards`` streams (latents, labels)
batches into fixed-size npz shard files; ``sharded_latent_batches`` is an
infinite shuffled reader that holds ONE shard in RAM at a time (shard-order
and in-shard shuffling, per-host strided slicing like DiT/sample_ddp.py:
94-104 shards by rank). ``LazyImageFolder`` (images decoded per batch,
encoded by the frozen VAE) comes with the VAE.
"""
from __future__ import annotations

import glob
import os
from typing import Iterator, Sequence

import numpy as np


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
