"""rGAN baselines (``mpgan_tpu/models/ext/rgan.py``; ext_models/ext_models.py:14-72,
from arXiv:1707.02392).

Generator: an MLP ``latent -> fc layers -> N * feat`` with LeakyReLU between
layers and tanh at the end, reshaped to a cloud. Its ``state_dict`` is the
reference's ``rGANG`` layout (``model.{2i}.weight``/``bias``). Discriminator: a
per-particle shared MLP (the reference's 1x1 Conv1d stack) with LeakyReLU after
every layer, a max pool over particles, an MLP head and a sigmoid.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ...ops import init
from ...ops.linear import make_linear


def linear_stack(sizes, key, alpha: float) -> nn.Sequential:
    """``Linear`` layers with ``LeakyReLU(alpha)`` between them, as one
    ``nn.Sequential`` (linear layers at even indices); layer ``i`` drawn from
    child ``i`` of ``split(key, len(sizes) - 1)``, as ``rgan_g_init``."""
    keys = init.root(key).split(len(sizes) - 1)
    mods: list[nn.Module] = []
    for i in range(len(sizes) - 1):
        mods.append(make_linear(sizes[i], sizes[i + 1], keys[i]))
        if i < len(sizes) - 2:
            mods.append(nn.LeakyReLU(alpha))
    return nn.Sequential(*mods)


def linear_layers(seq: nn.Sequential) -> list[nn.Linear]:
    return [m for m in seq if isinstance(m, nn.Linear)]


@dataclasses.dataclass(frozen=True)
class RGANGConfig:
    latent_dim: int
    fc_layers: tuple[int, ...]
    num_hits: int
    node_feat_size: int
    leaky_relu_alpha: float = 0.2


class RGANGenerator(nn.Module):
    def __init__(self, cfg: RGANGConfig, key=None, device: torch.device | str = "cpu"):
        super().__init__()
        self.cfg = cfg
        sizes = [cfg.latent_dim, *cfg.fc_layers, cfg.num_hits * cfg.node_feat_size]
        self.model = linear_stack(sizes, init.root(key, device), cfg.leaky_relu_alpha)
        self.to(device)

    def forward(self, x, labels=None, train: bool = False, rng=None, update_sn: bool = True):
        """``[B, latent_dim]`` noise -> ``[B, num_hits, node_feat_size]``."""
        x = torch.tanh(self.model(x))
        return x.reshape(-1, self.cfg.num_hits, self.cfg.node_feat_size)


@dataclasses.dataclass(frozen=True)
class RGANDConfig:
    sfc_layers: tuple[int, ...]
    fc_layers: tuple[int, ...]
    num_hits: int
    node_feat_size: int
    leaky_relu_alpha: float = 0.2


def _mlp(x: torch.Tensor, layers: nn.ModuleList, alpha: float, last_activation: bool):
    for i, layer in enumerate(layers):
        x = layer(x)
        if last_activation or i < len(layers) - 1:
            x = torch.nn.functional.leaky_relu(x, alpha)
    return x


def _linears(sizes, keys) -> nn.ModuleList:
    """Linear layer ``i`` of ``sizes`` drawn from ``keys[i]``."""
    return nn.ModuleList(make_linear(sizes[i], sizes[i + 1], keys[i])
                         for i in range(len(sizes) - 1))


def two_stacks(first, second, key, device) -> tuple[nn.ModuleList, nn.ModuleList]:
    """Two linear stacks drawn as ``rgan_d_init`` and ``pointnet_d_init`` draw
    theirs: ``split(key, len(first) + len(second) - 2)``, the first stack's
    layers, then the second's."""
    keys = init.root(key, device).split(len(first) + len(second) - 2)
    return _linears(first, keys), _linears(second, keys[len(first) - 1:])


class RGANDiscriminator(nn.Module):
    def __init__(self, cfg: RGANDConfig, key=None, device: torch.device | str = "cpu"):
        super().__init__()
        self.cfg = cfg
        self.sfc, self.fc = two_stacks([cfg.node_feat_size, *cfg.sfc_layers],
                                       [cfg.sfc_layers[-1], *cfg.fc_layers, 1], key, device)
        self.to(device)

    def forward(self, x, labels=None, train: bool = False, rng=None, update_sn: bool = True):
        """``[B, N, node_feat_size]`` -> ``[B, 1]``."""
        alpha = self.cfg.leaky_relu_alpha
        x = _mlp(x, self.sfc, alpha, last_activation=True).amax(dim=1)
        return torch.sigmoid(_mlp(x, self.fc, alpha, last_activation=False))
