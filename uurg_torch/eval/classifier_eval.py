"""Classifier-probe evaluation of generated samples (unlearning accuracy).

Port of ``uurg_tpu/eval/classifier_eval.py`` (parity target
DDPM/classifier_evaluation.py:16-147): run a fine-tuned classifier
(reference: ResNet-34 at 224 px) over samples generated for the forgotten
class and report the average entropy of its softmax, the average
probability of the forgotten class and the accuracy on the forgotten class
(UA, lower is better unlearning). Also the top-k classification of
SD/eval-scripts/imageclassify.py. ``logits_fn`` takes NCHW float images in
[0, 1] on ``device`` and returns logits.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from uurg_torch.core.device import resolve_device
from uurg_torch.eval.features import entropy, softmax
from uurg_torch.utils.images import resize_bilinear


def resize_batch(images_uint8: np.ndarray, size: int | None = 224,
                 device: str | torch.device | None = None) -> torch.Tensor:
    """uint8 NHWC -> float32 NCHW in [0, 1] on ``device`` (CUDA unless
    "cpu" is asked for), bilinear-resized to ``size`` as
    ``jax.image.resize`` resizes (``None`` keeps the size)."""
    x = torch.from_numpy(np.ascontiguousarray(images_uint8)).to(
        resolve_device(device))
    x = x.permute(0, 3, 1, 2).float() / 255.0
    return resize_bilinear(x, size) if size else x


def _logits(logits_fn, images_uint8, batch_size, resize_to, device):
    dev = resolve_device(device)
    for i in range(0, len(images_uint8), batch_size):
        x = resize_batch(images_uint8[i : i + batch_size], resize_to, dev)
        with torch.inference_mode():
            z = logits_fn(x).float().cpu().numpy()
        yield z


def classifier_probe(
    logits_fn: Callable[[torch.Tensor], torch.Tensor],
    images_uint8: np.ndarray,
    forgotten_label: int,
    batch_size: int = 64,
    resize_to: int | None = 224,
    device: str | torch.device | None = None,
) -> dict:
    """Evaluate samples generated while CONDITIONING on the forgotten class
    with any classifier, on ``device`` (CUDA unless "cpu" is asked for)."""
    p = np.concatenate([softmax(z) for z in _logits(
        logits_fn, images_uint8, batch_size, resize_to, device)])
    return {
        "avg_entropy": float(entropy(p).mean()),
        "avg_prob_forgotten": float(p[:, forgotten_label].mean()),
        "forget_accuracy": float(
            (p.argmax(axis=1) == forgotten_label).mean()),
        "n": len(p),
    }


def topk_classification(
    logits_fn: Callable[[torch.Tensor], torch.Tensor],
    images_uint8: np.ndarray,
    k: int = 5,
    batch_size: int = 64,
    resize_to: int | None = 224,
    device: str | torch.device | None = None,
) -> np.ndarray:
    """Per-image top-k class indices (SD/eval-scripts/imageclassify.py)."""
    return np.concatenate([np.argsort(-z, axis=1)[:, :k] for z in _logits(
        logits_fn, images_uint8, batch_size, resize_to, device)])
