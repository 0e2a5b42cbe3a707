"""Generative-model evaluation metrics: FID, sFID, Inception Score,
Precision/Recall.

This package's own copy of the numpy code of ``uurg_tpu/eval/generative.py``
(parity target: DDPM/evaluator.py:39-743, the ADM evaluation suite). The
metric math is extractor-agnostic: any callable mapping uint8 NHWC images
to (pool_features, spatial_features, logits) drives it, numpy arrays or
tensors on any device. The bundled extractor is the InceptionV3 of
:mod:`uurg_torch.eval.inception`.

- FID:   Frechet distance between Gaussians fit to pool3 (2048-d) features.
- sFID:  the same distance on early spatial features (mixed_6/conv, first
         7 channels of 17x17x768, flattened).
- IS:    exp(E_x KL(p(y|x) || p(y))) over softmax logits.
- P/R:   improved precision/recall via k-NN radii (ManifoldEstimator,
         DDPM/evaluator.py:261-344 semantics, k=3).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class FIDStatistics:
    mu: np.ndarray
    sigma: np.ndarray

    @classmethod
    def from_features(cls, feats: np.ndarray) -> "FIDStatistics":
        return cls(mu=np.mean(feats, axis=0),
                   sigma=np.cov(feats, rowvar=False))

    def frechet_distance(self, other: "FIDStatistics",
                         eps: float = 1e-6) -> float:
        """d^2 = |mu1 - mu2|^2 + Tr(C1 + C2 - 2 sqrt(C1 C2))."""
        import scipy.linalg

        mu1, s1, mu2, s2 = self.mu, self.sigma, other.mu, other.sigma
        diff = mu1 - mu2
        # no ``disp``: SciPy 1.18 removed it (earlier versions return the
        # matrix alone without it, as they do for the retry below)
        covmean = scipy.linalg.sqrtm(s1.dot(s2))
        if not np.isfinite(covmean).all():
            offset = np.eye(s1.shape[0]) * eps
            covmean = scipy.linalg.sqrtm(
                (s1 + offset).dot(s2 + offset))
        if np.iscomplexobj(covmean):
            covmean = covmean.real
        return float(diff.dot(diff) + np.trace(s1) + np.trace(s2)
                     - 2 * np.trace(covmean))


def compute_fid(feats_ref: np.ndarray, feats_sample: np.ndarray) -> float:
    return FIDStatistics.from_features(feats_ref).frechet_distance(
        FIDStatistics.from_features(feats_sample))


def inception_score(logits: np.ndarray, split_size: int = 5000) -> float:
    """Mean IS over splits (ADM convention)."""
    scores = []
    for i in range(0, len(logits), split_size):
        part = logits[i : i + split_size]
        # softmax
        z = part - part.max(axis=1, keepdims=True)
        p = np.exp(z)
        p /= p.sum(axis=1, keepdims=True)
        kl = p * (np.log(p + 1e-10) - np.log(p.mean(axis=0, keepdims=True)
                                             + 1e-10))
        scores.append(np.exp(kl.sum(axis=1).mean()))
    return float(np.mean(scores))


def _sq_dists_block(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Squared euclidean distances for one (row, col) block pair.

    float32 compute — the reference's DistanceBlock runs the same
    ||a||^2 + ||b||^2 - 2ab expansion in TF float32
    (DDPM/evaluator.py:224-259)."""
    a = np.ascontiguousarray(a, np.float32)
    b = np.ascontiguousarray(b, np.float32)
    d = (np.sum(a * a, axis=1)[:, None] + np.sum(b * b, axis=1)[None, :]
         - 2.0 * (a @ b.T))
    return np.maximum(d, 0.0, out=d)


def knn_radii(feats: np.ndarray, k: int = 3, row_block: int = 4096,
              col_block: int = 4096) -> np.ndarray:
    """Distance to the k-th nearest neighbor (excluding self), blocked on
    BOTH axes so memory stays at O(row_block * col_block) — the reference's
    ManifoldEstimator.manifold_radii row/col batching
    (DDPM/evaluator.py:300-336) taken one step further (the reference still
    holds one full [row_batch, N] strip; at 50k x 50k that strip alone is
    2 GB, ours is ~64 MB)."""
    n = len(feats)
    radii = np.empty(n, np.float32)
    for i0 in range(0, n, row_block):
        rows = feats[i0 : i0 + row_block]
        m = len(rows)
        # running k smallest distances per row across all column blocks
        best = np.full((m, k), np.inf, np.float32)
        for j0 in range(0, n, col_block):
            d = _sq_dists_block(rows, feats[j0 : j0 + col_block])
            # exclude self-distances where the row/col blocks overlap
            ii = np.arange(m)
            jj = ii + (i0 - j0)
            valid = (jj >= 0) & (jj < d.shape[1])
            d[ii[valid], jj[valid]] = np.inf
            kk = min(k, d.shape[1])
            cand = np.concatenate(
                [best, np.partition(d, kk - 1, axis=1)[:, :kk]], axis=1)
            best = np.partition(cand, k - 1, axis=1)[:, :k]
        radii[i0 : i0 + m] = best.max(axis=1)  # k-th smallest overall
    return radii


def precision_recall(feats_ref: np.ndarray, feats_sample: np.ndarray,
                     k: int = 3, row_block: int = 4096,
                     col_block: int = 4096) -> tuple[float, float]:
    """Improved precision/recall (Kynkaanniemi et al.), ADM k=3.

    precision: fraction of samples inside some ref manifold sphere;
    recall: fraction of refs inside some sample manifold sphere.
    Both directions accumulate over block pairs in one sweep, so peak
    memory is one row_block x col_block tile (reference protocol:
    DDPM/evaluator.py:261-344 at 50k x 50k scale)."""
    r_ref = knn_radii(feats_ref, k, row_block, col_block)
    r_sam = knn_radii(feats_sample, k, row_block, col_block)
    in_ref = np.zeros(len(feats_sample), bool)  # sample in some ref sphere
    in_sam = np.zeros(len(feats_ref), bool)     # ref in some sample sphere
    for i0 in range(0, len(feats_sample), row_block):
        rows = feats_sample[i0 : i0 + row_block]
        for j0 in range(0, len(feats_ref), col_block):
            d = _sq_dists_block(rows, feats_ref[j0 : j0 + col_block])
            nc = d.shape[1]
            in_ref[i0 : i0 + len(rows)] |= np.any(
                d <= r_ref[j0 : j0 + nc][None, :], axis=1)
            in_sam[j0 : j0 + nc] |= np.any(
                d <= r_sam[i0 : i0 + len(rows)][:, None], axis=0)
    return float(in_ref.mean()), float(in_sam.mean())


def featurize(extractor, images: np.ndarray, batch_size: int = 256,
              columns: tuple | None = None):
    """Run ``extractor`` over ``images`` in batches -> concatenated
    (pool, spatial, logits) numpy arrays; the ragged last batch runs as it
    is.

    Batch i is copied to the host only after batch i+1 has been launched:
    with an extractor that returns CUDA tensors
    (``make_extractor(..., materialize=False)``) the card computes the next
    batch while the previous one is copied. Extractors that already return
    numpy run serially.

    ``columns`` selects which extractor outputs to copy (e.g. ``(0, 1)`` =
    pool + spatial only); the others never leave the device and come back
    as None: the reference pass of an FID run has no use for logits."""
    outs = []
    pending = None

    def host(o):
        return o.cpu().numpy() if hasattr(o, "cpu") else np.asarray(o)

    def materialize(batch_out):
        return tuple(
            host(o) if columns is None or j in columns else None
            for j, o in enumerate(batch_out))

    for i in range(0, len(images), batch_size):
        cur = extractor(images[i : i + batch_size])
        if pending is not None:
            outs.append(materialize(pending))
        pending = cur
    if pending is not None:
        outs.append(materialize(pending))
    return tuple(
        np.concatenate(col) if col[0] is not None else None
        for col in zip(*outs))


def evaluate_all(
    extractor,
    ref_images: np.ndarray,
    sample_images: np.ndarray,
    batch_size: int = 256,
) -> dict:
    """Full ADM metric sweep (DDPM/evaluator.py:60-76 printout parity)."""
    ref_pool, ref_sp, _ = featurize(extractor, ref_images, batch_size,
                                    columns=(0, 1))
    sam_pool, sam_sp, sam_logits = featurize(extractor, sample_images,
                                             batch_size)
    prec, rec = precision_recall(ref_pool, sam_pool)
    return {
        "inception_score": inception_score(sam_logits),
        "fid": compute_fid(ref_pool, sam_pool),
        "sfid": compute_fid(ref_sp, sam_sp),
        "precision": prec,
        "recall": rec,
    }
