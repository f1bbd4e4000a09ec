"""Variable-cardinality masking (``mpgan_tpu/ops/masking.py``).

Masks are 1.0 (real) / 0.0 (padded) of shape ``[B, N, 1]``; generators append
``mask - 0.5`` to the features (mpgan/model.py:752), discriminators recover it
with ``+ 0.5`` (mpgan/model.py:881).
"""

from __future__ import annotations

import torch


def counts_from_labels(labels: torch.Tensor, num_particles: int) -> torch.Tensor:
    """The last jet label (num_particles / N) as an integer count minus one;
    ``.to(int32)`` truncates toward zero like torch's ``.int()`` (mpgan/model.py:692)."""
    return (labels[:, -1] * num_particles).to(torch.int32) - 1


def mask_from_counts(x_sort_feature: torch.Tensor, num_jet_particles: torch.Tensor) -> torch.Tensor:
    """``mask_c`` (mpgan/model.py:695-699): rank particles by ``x_sort_feature``
    ``[B, N]`` with a stable double argsort (ties broken by original index);
    ranks ``<= num_jet_particles[b]`` get mask 1. Returns ``[B, N, 1]``."""
    order = torch.argsort(x_sort_feature, dim=1, stable=True)
    ranks = torch.argsort(order, dim=1, stable=True)
    mask = ranks <= num_jet_particles[:, None]
    return mask[..., None].to(x_sort_feature.dtype)


def split_mask(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Discriminator-side mask recovery: ``(features, last feature + 0.5)``."""
    return x[:, :, :-1], x[:, :, -1:] + 0.5


def mask_manual(gen_data: torch.Tensor, pt_cutoff: float, *, mask_exp: bool = False,
                mask_real_only: bool = False) -> torch.Tensor:
    """Post-generation pT-cutoff mask (mpgan/mask_utils.py:5-24): appends a
    ``mask - 0.5`` feature, binary (pT > cutoff), decaying exponentially below
    the cutoff with ``mask_exp``, or all ones with ``mask_real_only``."""
    if mask_real_only:
        mask = torch.ones(gen_data.shape[:2] + (1,), dtype=gen_data.dtype,
                          device=gen_data.device) - 0.5
    elif mask_exp:
        pts = gen_data[:, :, 2:3]
        upper = (pts > pt_cutoff).to(gen_data.dtype)
        lower = 1.0 - upper
        exp = torch.exp((pts - pt_cutoff) / abs(pt_cutoff))
        mask = upper + lower * exp - 0.5
    else:
        mask = (gen_data[:, :, 2:3] > pt_cutoff).to(gen_data.dtype) - 0.5
    return torch.cat([gen_data, mask], dim=2)
