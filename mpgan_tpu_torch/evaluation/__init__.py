"""Evaluation metrics (``mpgan_tpu/evaluation``): W1 of particle features, jet
mass and EFPs, the Frechet Physics Distance and coverage/MMD."""

from .cov_mmd import cov_mmd
from .efp import efp_multigraphs, efps
from .fpd import fgd_inf, fpd, frechet_distance
from .jet_features import jet_features
from .w1 import w1efp, w1m, w1p, wasserstein1d

__all__ = [
    "jet_features",
    "w1p",
    "w1m",
    "w1efp",
    "wasserstein1d",
    "efps",
    "efp_multigraphs",
    "frechet_distance",
    "fpd",
    "fgd_inf",
    "cov_mmd",
]
