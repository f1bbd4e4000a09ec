"""TreeGAN generator (``mpgan_tpu/models/ext/treegan.py``;
ext_models/ext_models.py:211-336, from arXiv:1905.06292): a cloud grown from
one root node through per-depth tree graph convolutions with branching
factors ``degrees``.

Each ``TreeGCN`` depth (ext_models.py:254-282) adds

- a root term: for every ancestor depth, its nodes through that depth's
  ``W_root`` map, each node repeated up to the current node count,
- a branch term: each node upsampled by ``degree`` through the learned
  ``W_branch`` tensor, then the two-layer ``W_loop`` MLP without bias,
- a learned per-degree bias and LeakyReLU(0.2), except at the last depth.

Node counts multiply by ``degree`` each depth (1 -> 32 for degrees [2] * 5), so
the run's particle count is rounded up to a power of two
(``training/config.py``). The ``state_dict`` is the reference's layout
(``gcn.TreeGCN_{d}.W_root.{i}.weight``, ``W_branch``, ``W_loop.{0,1}.weight``,
``bias``).
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from ...ops import init
from ...ops.linear import empty_linear


@dataclasses.dataclass(frozen=True)
class TreeGANGConfig:
    features: tuple[int, ...] = (96, 64, 64, 64, 64, 3)
    degrees: tuple[int, ...] = (2, 2, 2, 2, 2)
    support: int = 10

    @property
    def layer_num(self) -> int:
        return len(self.features) - 1


def _linear_no_bias(in_dim: int, out_dim: int, key) -> nn.Linear:
    """A bias-free Linear whose weight is drawn from ``key`` itself, uniform on
    ``+-1/sqrt(in)`` (treegan.py's ``_linear_no_bias``: no split)."""
    lin = empty_linear(in_dim, out_dim, bias=False, device=key.root.device)
    bound = 1.0 / math.sqrt(in_dim)
    with torch.no_grad():
        lin.weight.copy_(init.uniform(key, (out_dim, in_dim), -bound, bound))
    return lin


class TreeGCN(nn.Module):
    def __init__(self, cfg: TreeGANGConfig, depth: int, node: int, key):
        """Drawn as one depth of ``treegan_g_init``: ``keys = split(fold_in(key,
        depth), depth + 5)``, root map ``i`` from ``keys[i]``, ``W_branch``,
        the two loop maps and the bias from ``keys[-4..-1]``."""
        super().__init__()
        in_f, out_f = cfg.features[depth], cfg.features[depth + 1]
        degree = cfg.degrees[depth]
        self.depth, self.node, self.degree = depth, node, degree
        self.last = depth == cfg.layer_num - 1
        keys = key.fold_in(depth).split(depth + 5)
        # one root map per ancestor depth (ext_models.py:224-229)
        self.W_root = nn.ModuleList(
            _linear_no_bias(cfg.features[i], out_f, keys[i]) for i in range(depth + 1))
        # upsampling tensor [node, in, degree * in], xavier-uniform with gain sqrt(2)
        bound = math.sqrt(2.0) * math.sqrt(6.0 / (in_f + degree * in_f))
        self.W_branch = nn.Parameter(
            init.uniform(keys[-4], (node, in_f, degree * in_f), -bound, bound))
        self.W_loop = nn.Sequential(_linear_no_bias(in_f, in_f * cfg.support, keys[-3]),
                                    _linear_no_bias(in_f * cfg.support, out_f, keys[-2]))
        self.bias = nn.Parameter(init.uniform(keys[-1], (1, degree, out_f),
                                              -1.0 / math.sqrt(out_f), 1.0 / math.sqrt(out_f)))

    def forward(self, tree: list[torch.Tensor]) -> torch.Tensor:
        node, degree = self.node, self.degree
        root = 0
        for ancestor, w_root in zip(tree, self.W_root):
            root = root + torch.repeat_interleave(w_root(ancestor), node // ancestor.shape[1],
                                                  dim=1)
        branch = torch.einsum("bnf,nfk->bnk", tree[-1], self.W_branch)
        branch = torch.nn.functional.leaky_relu(branch, 0.2)
        branch = branch.reshape(branch.shape[0], node * degree, -1)
        branch = torch.repeat_interleave(root, degree, dim=1) + self.W_loop(branch)
        if not self.last:
            branch = torch.nn.functional.leaky_relu(branch + self.bias.repeat(1, node, 1), 0.2)
        return branch


class TreeGANGenerator(nn.Module):
    def __init__(self, cfg: TreeGANGConfig, key=None, device: torch.device | str = "cpu"):
        super().__init__()
        self.cfg = cfg
        k = init.root(key, device)
        self.gcn = nn.Sequential()
        node = 1
        for depth in range(cfg.layer_num):
            self.gcn.add_module(f"TreeGCN_{depth}", TreeGCN(cfg, depth, node, k))
            node *= cfg.degrees[depth]
        self.to(device)

    def forward(self, x, labels=None, train: bool = False, rng=None, update_sn: bool = True):
        """Root noise ``[B, 1, features[0]]`` -> ``[B, prod(degrees), features[-1]]``."""
        tree = [x]
        for layer in self.gcn:
            tree.append(layer(tree))
        return tree[-1]
