"""Quality metrics (the port's copy of `lumina_t2x_tpu/eval/fid.py`):
Frechet distances over (mu, Sigma) feature statistics, the Inception Score
and improved precision/recall, in numpy/scipy so that any feature extractor
plugs in.

- `compute_statistics` / `frechet_distance`: FID with a numerically stable
  tr(sqrt(S1 S2)) (eigendecomposition of the symmetrized product);
- `fid_from_feature_batches`: the same, accumulated over feature batches;
- `inception_score`: exp(E_x KL(p(y|x) || p(y))) over class probabilities;
- `precision_recall`: improved precision/recall (Kynkaanniemi et al.) from
  k-NN radii, the ADM evaluator's P/R columns;
- `load_adm_npz`: the `arr_0` batch that `pipelines/sample.py
  --num_fid_samples` writes.
"""

from __future__ import annotations

from typing import Callable, Iterable, Tuple

import numpy as np


def compute_statistics(features: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(N, D) features -> (mu (D,), Sigma (D, D))."""
    features = np.asarray(features, np.float64)
    mu = features.mean(axis=0)
    sigma = np.cov(features, rowvar=False)
    return mu, np.atleast_2d(sigma)


def _sqrtm_product(sigma1: np.ndarray, sigma2: np.ndarray) -> np.ndarray:
    """Stable tr(sqrt(S1 S2)) via eigen-decomposition of the symmetrized
    form sqrt(S1) S2 sqrt(S1)."""
    w1, v1 = np.linalg.eigh(sigma1)
    w1 = np.clip(w1, 0, None)
    s1_half = (v1 * np.sqrt(w1)) @ v1.T
    inner = s1_half @ sigma2 @ s1_half
    w = np.linalg.eigvalsh(inner)
    return np.sum(np.sqrt(np.clip(w, 0, None)))


def frechet_distance(mu1, sigma1, mu2, sigma2) -> float:
    """||mu1 - mu2||^2 + tr(S1 + S2 - 2 sqrt(S1 S2))."""
    mu1, mu2 = np.asarray(mu1, np.float64), np.asarray(mu2, np.float64)
    diff = mu1 - mu2
    tr_sqrt = _sqrtm_product(np.asarray(sigma1, np.float64), np.asarray(sigma2, np.float64))
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2) - 2.0 * tr_sqrt)


def fid_from_feature_batches(real_iter: Iterable[np.ndarray],
                             fake_iter: Iterable[np.ndarray]) -> float:
    """Streaming FID over feature batches (memory-bounded accumulation)."""

    def accumulate(it):
        n, s, ss = 0, None, None
        for batch in it:
            b = np.asarray(batch, np.float64)
            if s is None:
                s = b.sum(axis=0)
                ss = b.T @ b
            else:
                s += b.sum(axis=0)
                ss += b.T @ b
            n += b.shape[0]
        if n < 2:
            # clear error instead of a TypeError (n=0) or a 0-division nan
            # covariance (n=1) deep in the statistics
            raise ValueError(f"FID needs >= 2 feature rows per side, got {n}")
        mu = s / n
        sigma = (ss - n * np.outer(mu, mu)) / (n - 1)
        return mu, sigma

    mu1, sig1 = accumulate(real_iter)
    mu2, sig2 = accumulate(fake_iter)
    return frechet_distance(mu1, sig1, mu2, sig2)


def inception_score(probs: np.ndarray, splits: int = 10) -> Tuple[float, float]:
    """exp(E KL(p(y|x) || p(y))) over class probabilities (N, C).

    `splits` is clamped to N so small sample sets (smoke runs) never produce
    empty partitions (which would NaN the mean)."""
    probs = np.asarray(probs, np.float64)
    scores = []
    n = probs.shape[0]
    if n == 0:
        return float("nan"), float("nan")
    for part in np.array_split(probs, min(splits, n)):
        py = part.mean(axis=0, keepdims=True)
        kl = part * (np.log(part + 1e-12) - np.log(py + 1e-12))
        scores.append(np.exp(kl.sum(axis=1).mean()))
    return float(np.mean(scores)), float(np.std(scores))


def precision_recall(real_feats: np.ndarray, fake_feats: np.ndarray,
                     k: int = 3) -> Tuple[float, float]:
    """Improved precision/recall via k-NN manifold radii (ADM's P/R)."""
    real = np.asarray(real_feats, np.float64)
    fake = np.asarray(fake_feats, np.float64)

    def pairwise(a, b):
        return np.sqrt(np.maximum(
            (a**2).sum(1)[:, None] + (b**2).sum(1)[None] - 2 * a @ b.T, 0.0
        ))

    def knn_radii(x):
        d = pairwise(x, x)
        np.fill_diagonal(d, np.inf)
        return np.sort(d, axis=1)[:, k - 1]

    r_real = knn_radii(real)
    r_fake = knn_radii(fake)
    d_fr = pairwise(fake, real)  # (Nf, Nr)
    precision = float((d_fr <= r_real[None]).any(axis=1).mean())
    d_rf = d_fr.T
    recall = float((d_rf <= r_fake[None]).any(axis=1).mean())
    return precision, recall


def load_adm_npz(path: str) -> np.ndarray:
    """Read an ADM-evaluator sample batch (`arr_0`)."""
    return np.load(path)["arr_0"]
