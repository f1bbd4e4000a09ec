"""PCGAN stack (``mpgan_tpu/models/ext/pcgan.py``; ext_models/pcgan_model.py,
from arXiv:1810.05795 "Point Cloud GAN").

Real clouds are encoded to a ``z1_dim`` latent by the pre-trained DeepSets
inference network ``G_inv`` (Tanh variant); a small latent GAN
(:class:`LatentGenerator` / :class:`LatentDiscriminator`) trains in that
space (train.py:837-839); at evaluation the latents are decoded back to clouds
by the pre-trained per-point decoder ``G_pc`` on per-point unit-Gaussian noise
``[N, z2_dim]`` (train.py:212-213).

Every module's ``state_dict`` is the reference's layout: the latent nets
``model.{2i}``; ``G_inv_Tanh`` ``phi.{0,2,4}.Gamma`` (and ``Lambda`` for the
``max``/``mean`` pools), ``ro.{0,2}``; ``G_pc`` ``fc``, ``fu`` (no bias),
``main.{1,3,5,7,9}``.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ...ops import init
from ...ops.linear import make_linear
from .rgan import linear_stack


@dataclasses.dataclass(frozen=True)
class PCGANConfig:
    node_feat_size: int = 3
    latent_dim: int = 128  # sampling latent (latent G input)
    z1_dim: int = 256  # object latent
    z2_dim: int = 10  # per-point latent
    d_dim: int = 256
    pool: str = "max1"
    latent_g_layers: tuple[int, ...] = (256, 512)
    latent_d_layers: tuple[int, ...] = (512, 256)


class LatentGenerator(nn.Module):
    """``[B, latent_dim] -> [B, z1_dim]``, LeakyReLU(0.2) between layers."""

    def __init__(self, cfg: PCGANConfig, key=None, device: torch.device | str = "cpu"):
        super().__init__()
        self.cfg = cfg
        self.model = linear_stack([cfg.latent_dim, *cfg.latent_g_layers, cfg.z1_dim],
                                  init.root(key, device), 0.2)
        self.to(device)

    def forward(self, x, labels=None, train: bool = False, rng=None, update_sn: bool = True):
        return self.model(x)


class LatentDiscriminator(nn.Module):
    """``[B, z1_dim] -> [B, 1]``, no sigmoid (trained with the WGAN loss)."""

    def __init__(self, cfg: PCGANConfig, key=None, device: torch.device | str = "cpu"):
        super().__init__()
        self.cfg = cfg
        self.model = linear_stack([cfg.z1_dim, *cfg.latent_d_layers, 1],
                                  init.root(key, device), 0.2)
        self.to(device)

    def forward(self, x, labels=None, train: bool = False, rng=None, update_sn: bool = True):
        return self.model(x)


class PermEqui(nn.Module):
    """``max1``: ``Gamma(x - max x)``; ``max``/``mean``: ``Gamma(x) - Lambda(pool x)``.
    Gamma from ``key``, Lambda from ``fold_in(key, 1)`` (``g_inv_init``)."""

    def __init__(self, in_dim: int, out_dim: int, pool: str, key):
        super().__init__()
        self.pool = pool
        self.Gamma = make_linear(in_dim, out_dim, key)
        if pool in ("max", "mean"):
            self.Lambda = make_linear(in_dim, out_dim, key.fold_in(1), bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.pool == "max1":
            return self.Gamma(x - x.amax(dim=1, keepdim=True))
        pooled = x.amax(dim=1, keepdim=True) if self.pool == "max" else x.mean(dim=1,
                                                                              keepdim=True)
        return self.Gamma(x) - self.Lambda(pooled)


class GInv(nn.Module):
    """The DeepSets encoder ``G_inv_Tanh`` (pcgan_model.py:45-93): three
    PermEqui layers with tanh, a max pool, the ``ro`` head.
    ``[B, N, feat] -> [B, z1_dim]``. Drawn as ``g_inv_init``: ``split(key,
    5)``, the PermEqui layers from the first three, ``ro`` from the last two."""

    def __init__(self, cfg: PCGANConfig, key=None, device: torch.device | str = "cpu"):
        super().__init__()
        self.cfg = cfg
        keys = init.root(key, device).split(5)
        sizes = [cfg.node_feat_size, cfg.d_dim, cfg.d_dim, cfg.d_dim]
        mods: list[nn.Module] = []
        for i in range(3):
            mods += [PermEqui(sizes[i], sizes[i + 1], cfg.pool, keys[i]), nn.Tanh()]
        self.phi = nn.Sequential(*mods)
        self.ro = nn.Sequential(make_linear(cfg.d_dim, cfg.d_dim, keys[3]), nn.Tanh(),
                                make_linear(cfg.d_dim, cfg.z1_dim, keys[4]))
        self.to(device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.ro(self.phi(x).amax(dim=1))


class GPc(nn.Module):
    """The point decoder ``G_pc`` (pcgan_model.py:219-248):
    ``fc(z1) + fu(z2)``, four softplus + Linear layers, softplus, the output
    layer. ``z1 [B, 1 or N, z1_dim]``, ``z2 [B, N, z2_dim]`` -> ``[B, N, feat]``.
    Drawn as ``g_pc_init``: ``split(key, 7)`` for fc, fu, the four hidden
    layers and the output layer."""

    def __init__(self, cfg: PCGANConfig, key=None, device: torch.device | str = "cpu"):
        super().__init__()
        self.cfg = cfg
        keys = init.root(key, device).split(7)
        hid = max(250, 2 * cfg.z1_dim)
        self.fc = make_linear(cfg.z1_dim, hid, keys[0])
        self.fu = make_linear(cfg.z2_dim, hid, keys[1], bias=False)
        mods: list[nn.Module] = []
        for i in range(4):
            mods += [nn.Softplus(), make_linear(hid, hid, keys[2 + i])]
        self.main = nn.Sequential(*mods, nn.Softplus(),
                                  make_linear(hid, cfg.node_feat_size, keys[6]))
        self.to(device)

    def forward(self, z1: torch.Tensor, z2: torch.Tensor) -> torch.Tensor:
        return self.main(self.fc(z1) + self.fu(z2))
