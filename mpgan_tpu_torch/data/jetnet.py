"""Native JetNet data layer (numpy only; ``mpgan_tpu/data/jetnet.py``).

Loads the JetNet / JetNet150 HDF5 files (``<jet_type>.hdf5`` with
``particle_features [num_jets, N, 4]`` = [eta_rel, phi_rel, pt_rel, mask] and
``jet_features [num_jets, 4]`` = [pt, eta, mass, num_particles]) from a local
``data_dir``; zero-egress environments must pre-stage the files (the Zenodo
records are 3601443 for JetNet / 6975118 for JetNet150). For development,
testing and benchmarking without the real dataset, ``synthetic_jets``
generates statistically jet-like clouds with the same layout.

Normalization matches the reference training setup (train.py:41-61):
particles via ``FeaturewiseLinearBounded(feature_norms=1, feature_shifts=
[0, 0, -0.5(, -0.5)], feature_maxes=fpnd table)``, the particle-count label
via ``1/N`` scaling; deterministic [train, valid] split in file order
(split_fraction [0.7, 0.3, 0]).
"""

from __future__ import annotations

import pathlib

import numpy as np

from .normalize import (
    FPND_FEATURE_MAXES,
    FPND_NORM_MAXES,
    FeaturewiseLinear,
    FeaturewiseLinearBounded,
)


def synthetic_jets(
    jet_type: str,
    num_jets: int,
    num_particles: int = 30,
    seed: int = 42,
) -> tuple[np.ndarray, np.ndarray]:
    """Generate jet-like particle clouds: angular coordinates with a
    jet-type-dependent spread, a falling pT spectrum normalized to sum <= 1,
    and a realistic multiplicity distribution. Returns
    ``(particle_features [B, N, 4], jet_features [B, 1] = num_particles)``.
    """
    # zlib.crc32, NOT hash(): str hashes are salted per process
    # (PYTHONHASHSEED), which made synthetic datasets — and everything
    # downstream, e.g. the multichip dryrun's scanned-epoch loss —
    # nondeterministic across process boundaries
    import zlib

    rng = np.random.default_rng(seed + zlib.crc32(jet_type.encode()) % 1000)
    spread = {"g": 0.22, "q": 0.18, "t": 0.35, "w": 0.28, "z": 0.28}.get(jet_type, 0.25)
    # multiplicity: gluon jets are busier than quark jets; tops in between
    mean_frac = {"g": 0.8, "q": 0.55, "t": 0.85, "w": 0.7, "z": 0.7}.get(jet_type, 0.7)
    counts = np.clip(
        rng.binomial(num_particles, mean_frac, size=num_jets), 1, num_particles
    )

    eta = rng.normal(0, spread, (num_jets, num_particles))
    phi = rng.normal(0, spread, (num_jets, num_particles))
    if jet_type in ("t", "w", "z"):  # multi-prong substructure
        n_prongs = 3 if jet_type == "t" else 2
        prong_centers = rng.normal(0, spread, (num_jets, n_prongs, 2))
        assign = rng.integers(0, n_prongs, (num_jets, num_particles))
        eta = prong_centers[np.arange(num_jets)[:, None], assign, 0] + rng.normal(
            0, spread / 3, (num_jets, num_particles)
        )
        phi = prong_centers[np.arange(num_jets)[:, None], assign, 1] + rng.normal(
            0, spread / 3, (num_jets, num_particles)
        )
    pt = rng.exponential(1.0, (num_jets, num_particles))

    mask = np.arange(num_particles)[None, :] < counts[:, None]
    pt = np.where(mask, pt, 0.0)
    pt = pt / np.sum(pt, axis=1, keepdims=True)
    # sort by descending pT like the real dataset
    order = np.argsort(-pt, axis=1)
    take = lambda a: np.take_along_axis(a, order, axis=1)
    eta, phi, pt = take(eta), take(phi), take(pt)
    mask = np.take_along_axis(mask.astype(np.float32), order, axis=1)

    particles = np.stack(
        [np.where(mask > 0, eta, 0), np.where(mask > 0, phi, 0), pt, mask], axis=-1
    ).astype(np.float32)
    jets = counts[:, None].astype(np.float32)
    return particles, jets


class JetNetDataset:
    """Normalized train/valid view over JetNet-format data.

    Attributes mirror what the training loop consumes from the jetnet
    ``JetNet`` dataset (train.py:63-67, 705-721):

    - ``particle_data``: normalized ``[B, N, 3 or 4]`` (mask feature kept iff
      ``mask_feature``),
    - ``jet_data``: normalized particle-count labels ``[B, 1]`` (or None),
    - ``particle_normalisation``: callable with ``inverse=True`` support.
    """

    def __init__(
        self,
        jet_type: str = "g",
        data_dir: str | None = None,
        num_particles: int = 30,
        split: str = "train",
        split_fraction: tuple[float, float] = (0.7, 0.3),
        mask_feature: bool = True,
        num_particles_label: bool = True,
        real_only: bool = False,
        synthetic: bool | None = None,
        synthetic_num_jets: int = 50000,
        seed: int = 42,
    ):
        self.jet_type = jet_type
        self.num_particles = num_particles

        path = None
        if data_dir is not None:
            suffix = "" if num_particles <= 30 else "150"
            for cand in (f"{jet_type}{suffix}.hdf5", f"{jet_type}.hdf5"):
                p = pathlib.Path(data_dir) / cand
                if p.exists():
                    path = p
                    break
        if synthetic is None:
            synthetic = path is None

        if synthetic:
            particles, jet_counts = synthetic_jets(
                jet_type, synthetic_num_jets, num_particles, seed
            )
        else:
            particles, jet_counts = _load_hdf5(path, num_particles)

        if real_only:
            # keep only jets with all-real particles (--real-only,
            # setup_training.py:169)
            full = jet_counts[:, 0] >= num_particles
            particles, jet_counts = particles[full], jet_counts[full]

        shifts = [0.0, 0.0, -0.5, -0.5] if mask_feature else [0.0, 0.0, -0.5]
        # g/q/t: the per-type tables the shipped checkpoints were trained
        # with (gen.py:10-14); other types (w/z): the fixed fpnd_norm table
        # the reference's train.py applies to every type (train.py:36-44) —
        # never data-derived, so runs can't desync on sample-dependent maxes
        maxes = FPND_FEATURE_MAXES.get(jet_type, FPND_NORM_MAXES)
        norm = FeaturewiseLinearBounded(
            feature_norms=1.0,
            feature_shifts=shifts,
            feature_maxes=maxes[: len(shifts)],
        )
        self.particle_normalisation = norm
        self.jet_normalisation = FeaturewiseLinear(feature_scales=1.0 / num_particles)

        if not mask_feature:
            particles = particles[..., :3]

        n_total = particles.shape[0]
        n_train = int(split_fraction[0] * n_total)
        n_valid = int(split_fraction[1] * n_total)
        if split == "train":
            sl = slice(0, n_train)
        elif split in ("valid", "test"):
            sl = slice(n_train, n_train + n_valid)
        elif split == "all":
            sl = slice(None)
        else:
            raise ValueError(f"unknown split {split!r}")

        self.particle_data = norm(particles[sl]).astype(np.float32)
        self.jet_data = (
            self.jet_normalisation(jet_counts[sl]).astype(np.float32)
            if num_particles_label
            else None
        )

    def __len__(self) -> int:
        return self.particle_data.shape[0]


def _load_hdf5(path: pathlib.Path, num_particles: int) -> tuple[np.ndarray, np.ndarray]:
    import h5py

    with h5py.File(path, "r") as f:
        particles = np.asarray(f["particle_features"], dtype=np.float32)
        jets = np.asarray(f["jet_features"], dtype=np.float32)
    particles = particles[:, :num_particles]
    # recompute the particle count at this truncation from the mask feature
    counts = particles[..., -1].sum(axis=1, keepdims=True)
    return particles, counts.astype(np.float32)


def gen_jet_corrections(
    jets: np.ndarray,
    ret_mask_separate: bool = True,
    zero_mask_particles: bool = True,
    zero_neg_pt: bool = True,
) -> tuple[np.ndarray, np.ndarray | None] | np.ndarray:
    """Post-generation corrections (``jetnet.utils.gen_jet_corrections``, used at
    train.py:705-729): threshold the mask feature at 0.5, optionally zero the
    masked particles and clamp negative pT. Input jets are *unnormalized*, with
    the mask as the last feature when ``ret_mask_separate``."""
    jets = np.array(jets, copy=True)
    mask = None
    if ret_mask_separate:
        mask = jets[:, :, -1] >= 0.5
        jets = jets[:, :, :-1]
        if zero_mask_particles:
            jets *= mask[:, :, None].astype(jets.dtype)
    if zero_neg_pt:
        jets[:, :, 2] = np.maximum(jets[:, :, 2], 0)
    return (jets, mask) if ret_mask_separate else jets
