"""PointNet-Mix discriminator (``mpgan_tpu/models/ext/pointnet.py``;
ext_models/ext_models.py:160-207, the strong-baseline D of arXiv:2102.05743):
a per-particle MLP, max and mean pooling concatenated, an MLP head with a
sigmoid. With ``mask`` the input's pT is un-shifted, masked particles are
zeroed and pT is shifted back (ext_models.py:196-202); the mask feature is
dropped."""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from .rgan import _mlp, two_stacks


@dataclasses.dataclass(frozen=True)
class PointNetMixDConfig:
    pointfc_layers: tuple[int, ...]  # e.g. (64, 128, 1024)
    fc_layers: tuple[int, ...]  # e.g. (512,)
    num_hits: int
    node_feat_size: int
    mask: bool = False
    leaky_relu_alpha: float = 0.2


class PointNetMixDiscriminator(nn.Module):
    def __init__(self, cfg: PointNetMixDConfig, key=None, device: torch.device | str = "cpu"):
        super().__init__()
        self.cfg = cfg
        self.pointfc, self.fc = two_stacks(
            [cfg.node_feat_size, *cfg.pointfc_layers],
            [cfg.pointfc_layers[-1] * 2, *cfg.fc_layers, 1], key, device)
        self.to(device)

    def forward(self, x, labels=None, train: bool = False, rng=None, update_sn: bool = True):
        """``[B, N, node_feat_size (+1 mask feature with mask)]`` -> ``[B, 1]``."""
        cfg = self.cfg
        if cfg.mask:
            keep = x[:, :, 3:4] >= 0
            x = torch.cat([x[:, :, :2], x[:, :, 2:3] + 0.5], dim=2)
            x = torch.where(keep, x, torch.zeros_like(x))
            x = torch.cat([x[:, :, :2], x[:, :, 2:3] - 0.5], dim=2)
        x = _mlp(x, self.pointfc, cfg.leaky_relu_alpha, last_activation=True)
        x = torch.cat([x.amax(dim=1), x.mean(dim=1)], dim=1)
        return torch.sigmoid(_mlp(x, self.fc, cfg.leaky_relu_alpha, last_activation=False))
