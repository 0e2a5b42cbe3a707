"""Image IO helpers (port of ``uurg_tpu/utils/images.py``): PNG folders for
FID eval, grid sheets for visual spot-checks. Pillow is imported at the
call, so only the CLI needs it."""
from __future__ import annotations

import os

import numpy as np


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
