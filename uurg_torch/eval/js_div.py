"""Output-distribution divergence between unlearned and retrained models on
the forget set (Classification/evaluation/js_div.py:5-29). This package's
own copy of ``uurg_tpu/eval/js_div.py`` (numpy)."""
from __future__ import annotations

import numpy as np


def kl_divergence(p: np.ndarray, q: np.ndarray) -> np.ndarray:
    eps = 1e-20
    return np.sum(p * (np.log(p + eps) - np.log(q + eps)), axis=1)


def js_divergence(p: np.ndarray, q: np.ndarray) -> np.ndarray:
    m = 0.5 * (p + q)
    return 0.5 * kl_divergence(p, m) + 0.5 * kl_divergence(q, m)


def get_js_divergence(unlearn_probs: np.ndarray,
                      retrain_probs: np.ndarray) -> float:
    """Mean JS divergence over the forget set; probs from softmax outputs of
    the two models on identical inputs."""
    return float(js_divergence(unlearn_probs, retrain_probs).mean())
