"""Per-sample features of softmax probabilities: entropy, modified entropy,
confidence, correctness.

This package's own copy of ``uurg_tpu/eval/features.py`` (numpy only; the
probe and the membership-inference attacks run them on the host after
inference). ``m_entropy`` gathers each sample's own true class, the
Song & Mittal modified entropy, as the JAX package does.
"""
from __future__ import annotations

import numpy as np


def softmax(logits: np.ndarray) -> np.ndarray:
    z = logits - logits.max(axis=-1, keepdims=True)
    e = np.exp(z)
    return e / e.sum(axis=-1, keepdims=True)


def entropy(p: np.ndarray) -> np.ndarray:
    return -np.sum(np.where(p > 0, p * np.log(p, where=p > 0), 0.0), axis=-1)


def m_entropy(p: np.ndarray, labels: np.ndarray) -> np.ndarray:
    """Modified entropy: -sum_i mod_p_i * mod_log_p_i where the true-class
    column uses (1-p, log p) and the rest use (p, log(1-p))."""
    eps = 1e-30
    n = np.arange(len(p))
    log_p = np.log(np.maximum(p, eps))
    log_rev = np.log(np.maximum(1.0 - p, eps))
    mod_p = p.copy()
    mod_p[n, labels] = 1.0 - p[n, labels]
    mod_log = log_rev.copy()
    mod_log[n, labels] = log_p[n, labels]
    return -np.sum(mod_p * mod_log, axis=-1)


def confidence(p: np.ndarray, labels: np.ndarray) -> np.ndarray:
    return p[np.arange(len(p)), labels]


def correctness(p: np.ndarray, labels: np.ndarray) -> np.ndarray:
    return (np.argmax(p, axis=-1) == labels).astype(np.int32)
