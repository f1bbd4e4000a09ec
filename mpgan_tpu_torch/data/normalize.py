"""Feature normalizations (numpy only; a copy of ``mpgan_tpu/data/normalize.py``),
re-implemented natively from the jetnet library's scheme as configured by the
reference (train.py:37-61, gen.py:10-17).

``FeaturewiseLinearBounded``: per-feature ``x -> x / feature_max * norm +
shift`` — bounds each feature into ``[-norm + shift, norm + shift]`` using
fixed per-jet-type maxima. The maxima are the jetnet ``fpnd_norm`` constants
the reference hardcodes in gen.py:10-14 (eta_rel, phi_rel, pt_rel, mask).

``FeaturewiseLinear``: plain per-feature affine map; the reference uses scale
``1 / num_particles`` on the particle-count jet feature (train.py:46).
"""

from __future__ import annotations

import numpy as np

# per-jet-type particle feature maxima as used for arXiv:2106.11535
# (gen.py:10-14) — the convention the shipped trained_models were
# trained/unnormalized with, so weight-import fidelity uses these
FPND_FEATURE_MAXES: dict[str, list[float]] = {
    "g": [1.4532885551452637, 0.520724892616272, 0.8537549376487732, 1.0],
    "q": [1.6211985349655151, 0.4568111002445221, 0.8896132111549377, 1.0],
    "t": [1.4242753982543945, 0.4949831962585449, 0.8774275183677673, 1.0],
}

# the single fixed table the reference's train.py head applies to EVERY jet
# type (train.py:36-44 uses jetnet's ``JetNet.fpnd_norm.feature_maxes`` with
# no per-type switch) — jet types without a per-type entry above (w, z)
# normalize with these constants rather than data-derived maxes, so the
# normalization never drifts with the sample
FPND_NORM_MAXES: list[float] = [
    1.6211985349655151,
    0.4568111002445221,
    0.8896132111549377,
    1.0,
]


class FeaturewiseLinearBounded:
    def __init__(
        self,
        feature_norms: float | list[float] = 1.0,
        feature_shifts: float | list[float] = 0.0,
        feature_maxes: list[float] | None = None,
    ):
        self.feature_norms = feature_norms
        self.feature_shifts = feature_shifts
        self.feature_maxes = None if feature_maxes is None else list(feature_maxes)

    def _expanded(self, num_features: int):
        def expand(v):
            if np.isscalar(v):
                return [v] * num_features
            return list(v)

        return (
            expand(self.feature_norms),
            expand(self.feature_shifts),
            list(self.feature_maxes),
        )

    def __call__(self, data: np.ndarray, inverse: bool = False) -> np.ndarray:
        nf = data.shape[-1]
        norms, shifts, maxes = self._expanded(nf)
        out = np.array(data, dtype=np.float32, copy=True)
        for i in range(nf):
            if inverse:
                if shifts[i]:
                    out[..., i] -= shifts[i]
                if norms[i]:
                    out[..., i] = out[..., i] / norms[i] * maxes[i]
            else:
                if norms[i]:
                    out[..., i] = out[..., i] / maxes[i] * norms[i]
                if shifts[i]:
                    out[..., i] += shifts[i]
        return out


class FeaturewiseLinear:
    def __init__(self, feature_scales: float | list[float] = 1.0, feature_shifts: float | list[float] = 0.0):
        self.feature_scales = feature_scales
        self.feature_shifts = feature_shifts

    def __call__(self, data: np.ndarray, inverse: bool = False) -> np.ndarray:
        scales = self.feature_scales
        shifts = self.feature_shifts
        if inverse:
            return (data - shifts) / scales
        return data * scales + shifts
