"""Image helpers: PNG folders for FID eval and grid sheets for visual
spot-checks (port of ``uurg_tpu/utils/images.py``; Pillow is imported at
the call, so only the CLIs need it), and the bilinear resize that the
evaluation networks' preprocessing shares."""
from __future__ import annotations

import os

import numpy as np
import torch


def save_png_folder(images: np.ndarray, labels: np.ndarray, out_dir: str,
                    start_index: int = 0) -> None:
    """uint8 NHWC images -> <label>_<index>.png files."""
    from PIL import Image

    os.makedirs(out_dir, exist_ok=True)
    for i, (img, lab) in enumerate(zip(images, labels)):
        Image.fromarray(img).save(
            os.path.join(out_dir, f"{int(lab)}_{start_index + i:06d}.png"))


def save_grid(images: np.ndarray, path: str, ncol: int = 10) -> None:
    """uint8 NHWC images -> one tiled grid PNG."""
    from PIL import Image

    n, h, w, c = images.shape
    nrow = (n + ncol - 1) // ncol
    grid = np.zeros((nrow * h, ncol * w, c), np.uint8)
    for i, img in enumerate(images):
        r, col = divmod(i, ncol)
        grid[r * h:(r + 1) * h, col * w:(col + 1) * w] = img
    Image.fromarray(grid).save(path)


def _resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) float32 weights of ``jax.image.resize(..., "bilinear")``
    along one axis: the triangle kernel at half-pixel sample positions,
    widened by the scale when shrinking (antialiasing), renormalised over
    the taps inside the image (``jax.image.scale_and_translate``). Computed
    as XLA's fused code computes them on the CPU: the sample position
    ``(i + 0.5) / scale - 0.5`` with one rounding (a fused multiply-add)
    and the kernel's widening as a multiply by its reciprocal; in the
    unfused order the positions move by an ulp and the resized images by up
    to 2.6e-4 on the [0, 255] scale."""
    f32 = np.float32
    inv = f32(1.0 / (n_out / n_in))
    widen = f32(1.0) / max(inv, f32(1.0))
    centers = np.arange(n_out, dtype=f32) + f32(0.5)
    sample = (centers.astype(np.float64) * np.float64(inv) - 0.5).astype(f32)
    dist = np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None])
    w = np.maximum(f32(0.0), f32(1.0) - dist * widen)
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(f32).eps,
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


def resize_bilinear(x: torch.Tensor, size: int) -> torch.Tensor:
    """Float NCHW images -> (N, C, size, size) by the bilinear resize of
    ``jax.image.resize`` (antialiased when shrinking), as two products with
    per-axis weight matrices, height first. ``F.interpolate`` places its
    samples otherwise: 3-5e-5 from the JAX package on the [0, 255] scale
    when enlarging 32 px images, where this is within an ulp."""
    h, w = x.shape[-2:]
    wh, ww = (torch.from_numpy(_resize_weights(n, size)).to(x.device, x.dtype)
              for n in (h, w))
    return torch.matmul(torch.matmul(wh.T, x), ww)
