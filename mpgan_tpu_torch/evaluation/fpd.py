"""Frechet distances on physics features (``mpgan_tpu/evaluation/fpd.py``,
numpy and scipy on the host as there: the matrices are 35 x 35).

``fpd`` is the Frechet Physics Distance (arXiv:2211.10295): the Frechet
distance between the real and generated distributions of the degree <= 4 EFP
basis (20 primes and 15 composites, energyflow's ``("d<=", 4)`` set without its
constant column, which adds exactly zero), standardized by the real sample's
moments and extrapolated to infinite sample size (``fgd_inf``). The reference
picks its best epoch by it (train.py:794-809).
"""

from __future__ import annotations

import numpy as np
import torch
from scipy import linalg

from .efp import efps


def _psd_sqrt(sigma: np.ndarray) -> np.ndarray:
    """Symmetric PSD square root via eigh with eigenvalue clipping."""
    w, v = linalg.eigh((sigma + sigma.T) / 2.0)
    return (v * np.sqrt(np.clip(w, 0.0, None))) @ v.T


def frechet_distance(mu1, sigma1, mu2, sigma2) -> float:
    """d^2 = |mu1 - mu2|^2 + Tr(C1 + C2 - 2 sqrt(C1 C2)) (Dowson-Landau), with
    ``Tr sqrt(C1 C2) = sum sqrt(eig(S1 C2 S1))``, ``S1 = sqrt(C1)``: symmetric
    eigh throughout (``scipy.linalg.sqrtm`` of the non-symmetric product can
    overflow on degenerate EFP covariances). Non-finite moments give ``inf``."""
    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
    # a generator's negative-pT jets make the z-weights unbounded; eigh raises
    # on non-finite input, and an infinite distance is the honest value
    if not all(np.isfinite(a).all() for a in (mu1, mu2, sigma1, sigma2)):
        return float("inf")
    diff = mu1 - mu2
    s1_half = _psd_sqrt(sigma1)
    inner = s1_half @ sigma2 @ s1_half
    w = linalg.eigvalsh((inner + inner.T) / 2.0)
    tr_covmean = float(np.sum(np.sqrt(np.clip(w, 0.0, None))))
    d2 = float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2) - 2 * tr_covmean)
    return max(d2, 0.0)  # float noise on (near-)identical inputs


def _gaussian_moments(x: np.ndarray):
    return np.mean(x, axis=0), np.cov(x, rowvar=False)


def fgd_inf(
    real_features: np.ndarray,
    gen_features: np.ndarray,
    min_samples: int = 20000,
    max_samples: int = 50000,
    num_batches: int = 20,
    num_points: int = 10,
    seed: int = 42,
) -> tuple[float, float]:
    """FGD extrapolated to infinite sample size: fit FGD(N) ~ a + b/N over
    ``num_points`` batch sizes; returns ``(a, std of a)``."""
    rng = np.random.default_rng(seed)
    n = min(len(real_features), len(gen_features))
    max_samples = min(max_samples, n)
    min_samples = min(min_samples, max_samples // 2 if max_samples >= 40 else max_samples)
    batches = np.linspace(min_samples, max_samples, num_points).astype(int)

    vals = np.zeros((num_points, num_batches))
    for i, bs in enumerate(batches):
        for j in range(num_batches):
            ri = rng.choice(len(real_features), size=bs, replace=False)
            gi = rng.choice(len(gen_features), size=bs, replace=False)
            mu1, s1 = _gaussian_moments(real_features[ri])
            mu2, s2 = _gaussian_moments(gen_features[gi])
            vals[i, j] = frechet_distance(mu1, s1, mu2, s2)

    if not np.isfinite(vals).all():
        # a clean subsample must not hide contaminated features: fitting only
        # the finite points would score a generator of inf/NaN jets as finite
        return float("inf"), float("inf")
    means = vals.mean(axis=1)
    coeffs, cov = np.polyfit(1.0 / batches, means, 1, cov=True)
    return float(coeffs[1]), float(np.sqrt(cov[1, 1]))


def fpd(
    real_jets: np.ndarray,
    gen_jets: np.ndarray,
    min_samples: int = 20000,
    max_samples: int = 50000,
    seed: int = 42,
    real_efps: np.ndarray | None = None,
    gen_efps: np.ndarray | None = None,
    device: torch.device | str = "cuda",
) -> tuple[float, float]:
    """Frechet Physics Distance: ``fgd_inf`` on the 35 d<=4 EFP columns
    standardized by the real sample's mean and std. Precomputed ``*_efps`` are
    used as given (the reference's cache, train.py:744-757); otherwise they are
    computed by :func:`efps` on ``device``. Returns ``(value, std)``."""
    if real_efps is None:
        real_efps = efps(real_jets, select="d<=4-all", device=device)
    if gen_efps is None:
        gen_efps = efps(gen_jets, select="d<=4-all", device=device)
    mean, std = real_efps.mean(axis=0), real_efps.std(axis=0)
    std = np.where(std > 0, std, 1.0)
    real_n = (real_efps - mean) / std
    gen_n = (gen_efps - mean) / std
    return fgd_inf(real_n, gen_n, min_samples=min_samples, max_samples=max_samples, seed=seed)
