"""Spectral normalization as a pure function (``mpgan_tpu/ops/spectral_norm.py``).

The weight is divided by its spectral norm, estimated by power iteration from
the carried left singular vector ``u`` (reference
mpgan/spectral_normalization.py:12-64). Returns the normalized weight and the
advanced ``u``/``v``; whether the caller keeps the advanced ``u`` is its choice.
"""

from __future__ import annotations

import torch

_EPS = 1e-12


def _l2normalize(v: torch.Tensor) -> torch.Tensor:
    return v / (torch.linalg.vector_norm(v) + _EPS)


def spectral_normalize(
    w: torch.Tensor, u: torch.Tensor, power_iterations: int = 1
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(w / (sigma + eps), u_new, v_new)`` for ``w: [out, in]``, ``u: [out]``."""
    height = w.shape[0]
    w2d = w.reshape(height, -1)
    w_sg = w2d.detach()
    v = None
    for _ in range(power_iterations):
        v = _l2normalize(w_sg.t() @ u)
        u = _l2normalize(w_sg @ v)
    # sigma on the live weight, so gradients flow through w as in the reference
    sigma = u @ (w2d @ v)
    return (w / (sigma + _EPS)).reshape(w.shape), u, v
