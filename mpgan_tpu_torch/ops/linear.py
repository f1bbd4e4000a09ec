"""MLP stack (the reference's ``LinearNet``, mpgan/model.py:11-88), eval mode.

Counterpart of ``mpgan_tpu/ops/linear.py``:

- Linear layers with LeakyReLU(alpha); ``final_linear`` leaves the last layer
  without activation or normalization,
- optional BatchNorm *after* the activation (mpgan/model.py:80-82), evaluated
  with the running statistics and eps 1e-5,
- optional spectral norm on every layer except a final linear one
  (mpgan/model.py:65-68).

Submodule names follow the reference, so its ``state_dict`` keys load as they
are: ``net.{k}.weight``/``bias`` for a plain layer,
``net.{k}.module.{weight_bar,bias,weight_u,weight_v}`` for a spectral-norm
layer (mpgan/spectral_normalization.py:44-60) and ``bn.{j}.*`` for BatchNorm.
Weights are ``[out, in]``, as in the JAX package.

Evaluation does not advance the spectral-norm ``u`` buffer: generation
discards the advanced state in the JAX package too
(``mpgan_tpu/training/sampling.py``). Training mode, including dropout
(``hash_dropout``), comes with the train step (ROADMAP.md Queue 1 item 6).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Sequence

import torch
from torch import nn

from .spectral_norm import spectral_normalize

_BN_EPS = 1e-5
TRAIN_NOT_PORTED = (
    "train mode (dropout, batch-norm batch statistics, spectral-norm updates) "
    "comes with the train step, ROADMAP.md Queue 1 item 6"
)


@dataclasses.dataclass(frozen=True)
class MLPConfig:
    """Static architecture of an MLP stack; ``sizes`` includes input and output."""

    sizes: tuple[int, ...]
    final_linear: bool = False
    leaky_relu_alpha: float = 0.2
    dropout_p: float = 0.0
    batch_norm: bool = False
    spectral_norm: bool = False

    @staticmethod
    def build(
        layers: Sequence[int],
        input_size: int = 0,
        output_size: int = 0,
        final_linear: bool = False,
        **kwargs: Any,
    ) -> "MLPConfig":
        sizes = list(layers)
        if input_size:
            sizes.insert(0, input_size)
        if output_size:
            sizes.append(output_size)
        return MLPConfig(sizes=tuple(sizes), final_linear=final_linear, **kwargs)

    @property
    def num_layers(self) -> int:
        return len(self.sizes) - 1

    def layer_has_activation(self, i: int) -> bool:
        return i != self.num_layers - 1 or not self.final_linear

    def layer_has_sn(self, i: int) -> bool:
        return self.spectral_norm and self.layer_has_activation(i)


def linear_init(
    weight: torch.Tensor, bias: torch.Tensor, generator: torch.Generator | None = None
) -> None:
    """torch ``nn.Linear``'s default init, drawn from ``generator``:
    U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for weight and bias."""
    in_dim = weight.shape[1]
    bound = 1.0 / math.sqrt(in_dim) if in_dim > 0 else 0.0
    with torch.no_grad():
        weight.uniform_(-bound, bound, generator=generator)
        bias.uniform_(-bound, bound, generator=generator)


class _SNParams(nn.Module):
    """Parameters of a spectral-norm wrapped Linear, under the reference's names."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.weight_bar = nn.Parameter(torch.empty(out_dim, in_dim))
        self.bias = nn.Parameter(torch.empty(out_dim))
        self.register_buffer("weight_u", torch.empty(out_dim))
        self.register_buffer("weight_v", torch.empty(in_dim))


class SNLinear(nn.Module):
    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.module = _SNParams(in_dim, out_dim)

    def weight_and_bias(self) -> tuple[torch.Tensor, torch.Tensor]:
        m = self.module
        w, _, _ = spectral_normalize(m.weight_bar, m.weight_u)
        return w, m.bias


def layer_weight_and_bias(layer: nn.Module) -> tuple[torch.Tensor, torch.Tensor]:
    """The effective ``(w [out, in], b)`` of a plain or spectral-norm layer."""
    if isinstance(layer, SNLinear):
        return layer.weight_and_bias()
    return layer.weight, layer.bias


class MLP(nn.Module):
    def __init__(self, cfg: MLPConfig, generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        layers = []
        for i in range(cfg.num_layers):
            d_in, d_out = cfg.sizes[i], cfg.sizes[i + 1]
            if cfg.layer_has_sn(i):
                layer = SNLinear(d_in, d_out)
                p = layer.module
                linear_init(p.weight_bar, p.bias, generator)
                with torch.no_grad():
                    u = torch.randn(d_out, generator=generator)
                    p.weight_u.copy_(u / (torch.linalg.vector_norm(u) + 1e-12))
                    v = p.weight_bar.t() @ p.weight_u
                    p.weight_v.copy_(v / (torch.linalg.vector_norm(v) + 1e-12))
            else:
                layer = nn.Linear(d_in, d_out)
                linear_init(layer.weight, layer.bias, generator)
            layers.append(layer)
        self.net = nn.ModuleList(layers)
        if cfg.batch_norm:
            # BatchNorm1d's own init: scale 1, bias 0, running mean 0, var 1
            self.bn = nn.ModuleList(
                nn.BatchNorm1d(cfg.sizes[i + 1], eps=_BN_EPS)
                for i in range(cfg.num_layers)
                if cfg.layer_has_activation(i)
            )

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if train:
            raise NotImplementedError(TRAIN_NOT_PORTED)
        cfg = self.cfg
        bn_idx = 0
        for i, layer in enumerate(self.net):
            w, b = layer_weight_and_bias(layer)
            x = torch.matmul(x, w.t()) + b
            if cfg.layer_has_activation(i):
                x = torch.where(x >= 0, x, cfg.leaky_relu_alpha * x)
                if cfg.batch_norm:
                    bn = self.bn[bn_idx]
                    x = (x - bn.running_mean) * torch.rsqrt(bn.running_var + _BN_EPS) \
                        * bn.weight + bn.bias
                    bn_idx += 1
        return x
