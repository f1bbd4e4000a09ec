"""Jet-level observables from relative particle coordinates (numpy; a copy of
``mpgan_tpu/evaluation/jet_features.py``, the native version of
``jetnet.utils.jet_features`` used at train.py:630-631).

Particles are ``[eta_rel, phi_rel, pt_rel]``; the jet's mass and pt come from
the sum of massless four-vectors::

    px = pt cos(phi), py = pt sin(phi), pz = pt sinh(eta), E = pt cosh(eta)
    m  = sqrt(max(E^2 - |p|^2, 0))
"""

from __future__ import annotations

import numpy as np


def jet_features(jets: np.ndarray) -> dict[str, np.ndarray]:
    """``jets: [B, N, >=3]`` (zero-padded particles contribute nothing).
    Returns ``mass``, ``pt`` and ``eta``."""
    eta, phi, pt = jets[..., 0], jets[..., 1], jets[..., 2]
    px = pt * np.cos(phi)
    py = pt * np.sin(phi)
    pz = pt * np.sinh(eta)
    e = pt * np.cosh(eta)
    jpx, jpy, jpz, je = (a.sum(axis=-1) for a in (px, py, pz, e))
    m2 = je**2 - jpx**2 - jpy**2 - jpz**2
    mass = np.sqrt(np.clip(m2, 0.0, None))
    jet_pt = np.sqrt(jpx**2 + jpy**2)
    with np.errstate(divide="ignore", invalid="ignore"):
        jet_eta = np.arcsinh(np.where(jet_pt > 0, jpz / np.maximum(jet_pt, 1e-12), 0.0))
    return {"mass": mass, "pt": jet_pt, "eta": jet_eta}
