"""The jets a cell trains on and the labels it generates for, made from the seed.

A frozen copy of the synthetic JetNet-like generator the port ships for runs
without the dataset: angular coordinates with a gluon-like spread, a falling
pT spectrum normalised to sum 1 over the real particles, a binomial
multiplicity at 0.8 of N for gluon jets, particles sorted by pT. The features
are then normalised as the reference's training normalises JetNet
(``x / max + shift`` with the per-type maxima of arXiv:2106.11535, shifts 0, 0,
-0.5, -0.5, the mask last), and the label is the particle count over N.
"""

from __future__ import annotations

import zlib

import numpy as np

SPREAD = {"g": 0.22, "q": 0.18, "t": 0.35, "w": 0.28, "z": 0.28}
MULTIPLICITY = {"g": 0.8, "q": 0.55, "t": 0.85, "w": 0.7, "z": 0.7}
FEATURE_MAXES = {"g": [1.4532885551452637, 0.520724892616272, 0.8537549376487732, 1.0],
                 "q": [1.6211985349655151, 0.4568111002445221, 0.8896132111549377, 1.0],
                 "t": [1.4242753982543945, 0.4949831962585449, 0.8774275183677673, 1.0]}
FEATURE_SHIFTS = [0.0, 0.0, -0.5, -0.5]


def _rng(jet_type: str, seed: int) -> np.random.Generator:
    return np.random.default_rng(int(seed) % 2**63 + zlib.crc32(jet_type.encode()) % 1000)


def counts(jet_type: str, num_jets: int, num_particles: int, seed: int) -> np.ndarray:
    """The particle counts of :func:`synthetic_jets` alone (its first draw)."""
    rng = _rng(jet_type, seed)
    return np.clip(rng.binomial(num_particles, MULTIPLICITY.get(jet_type, 0.7), size=num_jets),
                   1, num_particles)


def synthetic_jets(jet_type: str, num_jets: int, num_particles: int,
                   seed: int) -> tuple[np.ndarray, np.ndarray]:
    """``(particles [B, N, 4] = [eta, phi, pT, mask], counts [B])``, unnormalised."""
    rng = _rng(jet_type, seed)
    spread = SPREAD.get(jet_type, 0.25)
    cnt = np.clip(rng.binomial(num_particles, MULTIPLICITY.get(jet_type, 0.7), size=num_jets),
                  1, num_particles)
    eta = rng.normal(0, spread, (num_jets, num_particles))
    phi = rng.normal(0, spread, (num_jets, num_particles))
    if jet_type in ("t", "w", "z"):
        prongs = 3 if jet_type == "t" else 2
        centers = rng.normal(0, spread, (num_jets, prongs, 2))
        assign = rng.integers(0, prongs, (num_jets, num_particles))
        rows = np.arange(num_jets)[:, None]
        eta = centers[rows, assign, 0] + rng.normal(0, spread / 3, (num_jets, num_particles))
        phi = centers[rows, assign, 1] + rng.normal(0, spread / 3, (num_jets, num_particles))
    pt = rng.exponential(1.0, (num_jets, num_particles))
    mask = np.arange(num_particles)[None, :] < cnt[:, None]
    pt = np.where(mask, pt, 0.0)
    pt = pt / np.sum(pt, axis=1, keepdims=True)
    order = np.argsort(-pt, axis=1)
    take = lambda a: np.take_along_axis(a, order, axis=1)  # noqa: E731
    eta, phi, pt = take(eta), take(phi), take(pt)
    mask = take(mask.astype(np.float32))
    particles = np.stack([np.where(mask > 0, eta, 0), np.where(mask > 0, phi, 0), pt, mask],
                         axis=-1).astype(np.float32)
    return particles, cnt


def normalise(jet_type: str, particles: np.ndarray) -> np.ndarray:
    maxes = FEATURE_MAXES.get(jet_type, FEATURE_MAXES["q"])
    out = np.array(particles, dtype=np.float32, copy=True)
    for i in range(out.shape[-1]):
        out[..., i] = out[..., i] / maxes[i]
        if FEATURE_SHIFTS[i]:
            out[..., i] += FEATURE_SHIFTS[i]
    return out


def labels(cnt: np.ndarray, num_particles: int) -> np.ndarray:
    """The ``[B, 1]`` conditioning labels, count / N in float32."""
    return (cnt[:, None].astype(np.float32) * (1.0 / num_particles)).astype(np.float32)
