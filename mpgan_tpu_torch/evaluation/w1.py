"""Wasserstein-1 metrics ``w1p``, ``w1m`` and ``w1efp`` (numpy;
``mpgan_tpu/evaluation/w1.py``, the native versions of
``jetnet.evaluation.w1p / w1m / w1efp`` called at train.py:543-593).

Protocol: ``num_batches`` random batches of ``num_eval_samples`` jets from
each of the real and generated sets, the 1-D W1 distance per batch pair, and
the mean and standard deviation over batches.
"""

from __future__ import annotations

import numpy as np
import torch

from .efp import efps
from .jet_features import jet_features


def wasserstein1d(a: np.ndarray, b: np.ndarray) -> float:
    """W1 between two empirical 1-D distributions (the area between the CDFs)."""
    a = np.sort(np.asarray(a, dtype=np.float64))
    b = np.sort(np.asarray(b, dtype=np.float64))
    all_v = np.concatenate([a, b])
    all_v.sort(kind="mergesort")
    deltas = np.diff(all_v)
    cdf_a = np.searchsorted(a, all_v[:-1], side="right") / a.size
    cdf_b = np.searchsorted(b, all_v[:-1], side="right") / b.size
    return float(np.sum(np.abs(cdf_a - cdf_b) * deltas))


def _batches(n: int, num_eval_samples: int, num_batches: int, rng: np.random.Generator):
    for _ in range(num_batches):
        yield rng.choice(n, size=min(num_eval_samples, n), replace=False)


def w1p(real_jets: np.ndarray, gen_jets: np.ndarray, exclude_zeros: bool = True,
        num_eval_samples: int = 10000, num_batches: int = 5,
        average_over_features: bool = False, return_std: bool = True, seed: int = 42):
    """W1 between the particle-feature distributions (eta_rel, phi_rel, pt_rel),
    zero-padded particles excluded by default."""
    num_features = min(real_jets.shape[-1], gen_jets.shape[-1], 3)
    rng = np.random.default_rng(seed)
    num_batches = max(num_batches, 1)
    scores = np.zeros((num_batches, num_features))
    for b, (ri, gi) in enumerate(zip(
        _batches(len(real_jets), num_eval_samples, num_batches, rng),
        _batches(len(gen_jets), num_eval_samples, num_batches, rng),
    )):
        r = real_jets[ri][..., :num_features].reshape(-1, num_features)
        g = gen_jets[gi][..., :num_features].reshape(-1, num_features)
        if exclude_zeros:
            r = r[np.linalg.norm(r, axis=1) != 0]
            g = g[np.linalg.norm(g, axis=1) != 0]
        for f in range(num_features):
            scores[b, f] = wasserstein1d(r[:, f], g[:, f])
    means, stds = scores.mean(axis=0), scores.std(axis=0)
    if average_over_features:
        means, stds = means.mean(), stds.mean()
    return (means, stds) if return_std else means


def w1m(real_jets: np.ndarray, gen_jets: np.ndarray, num_eval_samples: int = 10000,
        num_batches: int = 5, return_std: bool = True, seed: int = 42):
    """W1 between the jet-mass distributions."""
    real_m = jet_features(real_jets)["mass"]
    gen_m = jet_features(gen_jets)["mass"]
    rng = np.random.default_rng(seed)
    num_batches = max(num_batches, 1)
    scores = np.asarray([
        wasserstein1d(real_m[ri], gen_m[gi])
        for ri, gi in zip(
            _batches(len(real_m), num_eval_samples, num_batches, rng),
            _batches(len(gen_m), num_eval_samples, num_batches, rng),
        )
    ])
    return (scores.mean(), scores.std()) if return_std else scores.mean()


def w1efp(real_jets: np.ndarray, gen_jets: np.ndarray, num_eval_samples: int = 10000,
          num_batches: int = 5, average_over_efps: bool = False, return_std: bool = True,
          seed: int = 42, efp_select: str = "n4d4", device: torch.device | str = "cuda"):
    """W1 between the EFP distributions; by default jetnet's set, the 5 prime
    EFPs with 4 vertices and 4 edges. The EFPs are computed by :func:`efps` on
    ``device``."""
    real_efps = efps(real_jets, select=efp_select, device=device)
    gen_efps = efps(gen_jets, select=efp_select, device=device)
    num_efps = real_efps.shape[1]
    rng = np.random.default_rng(seed)
    num_batches = max(num_batches, 1)
    scores = np.zeros((num_batches, num_efps))
    for b, (ri, gi) in enumerate(zip(
        _batches(len(real_efps), num_eval_samples, num_batches, rng),
        _batches(len(gen_efps), num_eval_samples, num_batches, rng),
    )):
        for f in range(num_efps):
            scores[b, f] = wasserstein1d(real_efps[ri, f], gen_efps[gi, f])
    means, stds = scores.mean(axis=0), scores.std(axis=0)
    if average_over_efps:
        means, stds = means.mean(), stds.mean()
    return (means, stds) if return_std else means
