"""GraphCNN-GAN generator (``mpgan_tpu/models/ext/graphcnn.py``;
ext_models/ext_models.py:75-157, from arXiv:1901.05237): a dense layer maps
the latent to an initial graph, then each layer rebuilds a k-nn graph and runs
an edge-conditioned convolution (PyG ``NNConv`` with mean aggregation and a
root weight) and a batch norm over all nodes (graphcnn.py:78-127 there).

- The neighbours are the ``num_knn`` smallest squared distances in a stable
  sort, the node itself excluded (``+1e10`` on the diagonal) unless
  ``num_knn == num_hits``, gathered with ``torch.gather``-style indexing.
- The convolution is ``out_i = x_i W_root + mean_j h(x_j - x_i) x_j + b``,
  ``h`` a linear map to an ``[in, out]`` matrix per edge. Its mean is
  computed without the per-edge matrices: ``sum_j x_j (e_j W + c)`` is
  ``(sum_j x_j e_j^T) . W + (sum_j x_j) . c``, the same sum in another order
  (``[B, N, in, in]`` instead of ``[B, N, k, in, out]`` in memory).
- The batch norm takes biased batch statistics in train mode and moves the
  running mean and the unbiased running variance by momentum 0.1; eval uses
  the running statistics.

The reference's layout (``layers.{i}.root`` ``[in, out]``, ``layers.{i}.bias``,
``bn_layers.{i}.module.*``) is read and written by ``utils/weights.py``.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ...ops import init
from ...ops.linear import batch_norm, make_linear


@dataclasses.dataclass(frozen=True)
class GraphCNNGANGConfig:
    latent_dim: int
    layers: tuple[int, ...]  # e.g. (32, 24)
    num_hits: int
    node_feat_size: int
    num_knn: int = 20
    final_tanh: bool = False
    leaky_relu_alpha: float = 0.2

    @property
    def all_sizes(self) -> tuple[int, ...]:
        return (*self.layers, self.node_feat_size)


def knn_indices(x: torch.Tensor, k: int, loop: bool) -> torch.Tensor:
    """Indices ``[B, N, k]`` of each node's ``k`` nearest nodes (squared
    euclidean distance, stable sort: ties go to the lower index)."""
    d = ((x[:, :, None, :] - x[:, None, :, :]) ** 2).sum(dim=-1)
    if not loop:
        d = d + torch.eye(x.shape[1], dtype=x.dtype, device=x.device) * 1e10
    return torch.argsort(d, dim=2, stable=True)[:, :, :k]


class NNConv(nn.Module):
    def __init__(self, in_f: int, out_f: int, edge_key, root_key):
        super().__init__()
        self.in_f, self.out_f = in_f, out_f
        # edge network Linear(in, in * out) (ext_models.py:88-93)
        self.nn = make_linear(in_f, in_f * out_f, edge_key)
        self.root = make_linear(in_f, out_f, root_key)

    def forward(self, x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        b = torch.arange(x.shape[0], device=x.device)[:, None, None]
        xj = x[b, idx]  # [B, N, k, in]
        e = xj - x[:, :, None, :]  # edge attribute x_src - x_dst
        s = torch.einsum("bnkf,bnkg->bnfg", xj, e)
        w = self.nn.weight.reshape(self.in_f, self.out_f, self.in_f)
        c = self.nn.bias.reshape(self.in_f, self.out_f)
        msg = torch.einsum("bnfg,fog->bno", s, w) + xj.sum(dim=2) @ c
        return self.root(x) + msg / idx.shape[2]


class GraphCNNGenerator(nn.Module):
    def __init__(self, cfg: GraphCNNGANGConfig, key=None, device: torch.device | str = "cpu"):
        """Drawn as ``graphcnn_g_init``: ``split(key, 3 * len(sizes) + 1)``, the
        dense layer from ``keys[0]``, conv ``i``'s edge and root maps from
        ``keys[3i + 1]`` and ``keys[3i + 2]``."""
        super().__init__()
        if cfg.num_knn > cfg.num_hits:
            raise ValueError(f"graphcnngan: num_knn {cfg.num_knn} > num_hits {cfg.num_hits} "
                             "(the preset searches 20 neighbours)")
        self.cfg = cfg
        sizes = cfg.all_sizes
        keys = init.root(key, device).split(3 * len(sizes) + 1)
        self.dense = make_linear(cfg.latent_dim, cfg.num_hits * sizes[0], keys[0])
        self.layers = nn.ModuleList(
            NNConv(sizes[i], sizes[i + 1], keys[3 * i + 1], keys[3 * i + 2])
            for i in range(len(sizes) - 1))
        self.bn_layers = nn.ModuleList(
            nn.BatchNorm1d(sizes[i + 1], eps=1e-5) for i in range(len(sizes) - 1))
        self.to(device)

    def forward(self, x, labels=None, train: bool = False, rng=None, update_sn: bool = True):
        """``[B, latent_dim]`` -> ``[B, num_hits, node_feat_size]``."""
        cfg = self.cfg
        alpha = cfg.leaky_relu_alpha
        x = torch.nn.functional.leaky_relu(self.dense(x), alpha)
        x = x.reshape(x.shape[0], cfg.num_hits, cfg.all_sizes[0])
        loop = cfg.num_knn == cfg.num_hits
        for i, (conv, bn) in enumerate(zip(self.layers, self.bn_layers)):
            x = batch_norm(conv(x, knn_indices(x, cfg.num_knn, loop)), bn, train)
            if i < len(self.layers) - 1:
                x = torch.nn.functional.leaky_relu(x, alpha)
        return torch.tanh(x) if cfg.final_tanh else x
