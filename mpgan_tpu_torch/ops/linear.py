"""MLP stack (the reference's ``LinearNet``, mpgan/model.py:11-88).

Counterpart of ``mpgan_tpu/ops/linear.py``:

- Linear layers with LeakyReLU(alpha); ``final_linear`` leaves the last layer
  without activation or normalization,
- dropout after *every* layer in train mode, a final linear one included
  (mpgan/model.py:83), drawn by ``hash_dropout``,
- optional BatchNorm *after* the activation (mpgan/model.py:80-82): running
  statistics in eval, biased batch statistics in train, which also update the
  running statistics (momentum 0.1, unbiased variance), eps 1e-5,
- optional spectral norm on every layer except a final linear one
  (mpgan/model.py:65-68); its ``u`` advances on every forward with
  ``update_sn`` set, eval included, as in the reference
  (spectral_normalization.py:62-64). Generation passes ``update_sn=False``,
  since the JAX package discards the advanced state there.

Submodule names follow the reference, so its ``state_dict`` keys load as they
are: ``net.{k}.weight``/``bias`` for a plain layer,
``net.{k}.module.{weight_bar,bias,weight_u,weight_v}`` for a spectral-norm
layer (mpgan/spectral_normalization.py:44-60) and ``bn.{j}.*`` for BatchNorm.
Weights are ``[out, in]``, as in the JAX package. Mutable state (BN running
statistics, SN vectors) is updated in place.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Sequence

import torch
from torch import nn

from . import init
from .spectral_norm import spectral_normalize

_BN_EPS = 1e-5
_BN_MOMENTUM = 0.1
_M32 = 0xFFFFFFFF


def _i32(c: int) -> int:
    """A uint32 constant as the int32 with the same bits."""
    c &= _M32
    return c - 2**32 if c >= 2**31 else c


def dropout_threshold_mult(p: float) -> tuple[int, float]:
    """The hash's keep threshold ``min(int(p * 2**32), 2**32 - 1)`` and the
    float32 multiplier ``1/(1-p)``, computed on the host as the JAX code does."""
    mult = float(torch.tensor(1.0 / (1.0 - p), dtype=torch.float32))
    return min(int(p * 2**32), 2**32 - 1), mult


def hash_mult(h: torch.Tensor, p: float, dtype: torch.dtype) -> torch.Tensor:
    """The hash's finisher and keep test on int32 keys ``h`` (uint32 bits):
    xor-shift 16, multiply by 0x85EBCA6B, xor-shift 15, keep iff
    ``h >= threshold`` as uint32. Returns the multiplier ``1/(1-p)`` or 0.

    int32 arithmetic wraps like uint32; the shifts are masked to be logical and
    the keep test compares sign-flipped values."""
    h = h ^ ((h >> 16) & 0xFFFF)
    h = h * _i32(0x85EBCA6B)
    h = h ^ ((h >> 15) & 0x1FFFF)
    threshold, mult = dropout_threshold_mult(p)
    keep = (h ^ _i32(2**31)) >= _i32(threshold ^ 2**31)
    return keep.to(dtype) * mult


@functools.lru_cache(maxsize=64)
def _hash_keys(rows: int, cols: int, device: str) -> tuple[torch.Tensor, torch.Tensor]:
    """``hash_dropout``'s row keys ``row * 0x9E3779B1`` ``[rows, 1]`` and column
    keys ``col * 0x85EBCA77`` ``[1, cols]``, as int32 bit patterns."""
    r = torch.arange(rows, dtype=torch.int32, device=device)[:, None] * _i32(0x9E3779B1)
    c = torch.arange(cols, dtype=torch.int32, device=device)[None, :] * _i32(0x85EBCA77)
    return r, c


def hash_seed(words: tuple[int, int]) -> int:
    """``hash_dropout``'s seed ``w0 * 0xC2B2AE3D + w1 * 0x27D4EB2F`` from the two
    key words, as int32 bits."""
    w0, w1 = (int(w) & _M32 for w in words)
    return _i32(w0 * 0xC2B2AE3D + w1 * 0x27D4EB2F)


def hash_dropout(x: torch.Tensor, p: float, words) -> torch.Tensor:
    """Torch-semantics dropout (keep with probability ``1-p``, scale by
    ``1/(1-p)``) from the outer-sum hash of ``mpgan_tpu.ops.linear.hash_dropout``:
    row key ``row * 0x9E3779B1 + seed`` with ``seed = w0 * 0xC2B2AE3D +
    w1 * 0x27D4EB2F`` from the two key words, column key ``col * 0x85EBCA77``.
    The same two words give the JAX package's mask bit for bit. ``words`` is
    the pair of key words, or a one-element int32 tensor that holds their
    :func:`hash_seed` (a key slot, see :mod:`.keys`).

    It runs on the main train path (every fn and fnd layer of D), so it is
    written for few kernel launches: int32 arithmetic and cached row and
    column keys."""
    seed = words if isinstance(words, torch.Tensor) else hash_seed(words)
    cols = x.shape[-1]
    rkey, ckey = _hash_keys(x.numel() // cols, cols, str(x.device))
    return x * hash_mult((rkey + seed) + ckey, p, x.dtype).reshape(x.shape)


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


def linear_init(weight: torch.Tensor, bias: torch.Tensor | None, key=None) -> None:
    """``mpgan_tpu/ops/linear.py::linear_init`` into ``weight [out, in]`` and
    ``bias``: ``wk, bk = split(key)``, each uniform on ``+-1/sqrt(in)`` (torch
    ``nn.Linear``'s default distribution). ``bias`` None: a layer the JAX
    package draws with ``linear_init`` and then drops the bias of."""
    wk, bk = init.root(key).split(2)
    in_dim = weight.shape[1]
    bound = 1.0 / math.sqrt(in_dim) if in_dim > 0 else 0.0
    with torch.no_grad():
        weight.copy_(init.uniform(wk, weight.shape, -bound, bound))
        if bias is not None:
            bias.copy_(init.uniform(bk, bias.shape, -bound, bound))


def empty_linear(in_dim: int, out_dim: int, bias: bool = True,
                 device: torch.device | str = "cpu") -> nn.Linear:
    """An ``nn.Linear`` with uninitialised parameters on ``device`` (it draws
    nothing from torch's RNG)."""
    return torch.nn.utils.skip_init(nn.Linear, in_dim, out_dim, bias=bias, device=device)


def make_linear(in_dim: int, out_dim: int, key=None, bias: bool = True) -> nn.Linear:
    """An ``nn.Linear`` drawn by :func:`linear_init` from ``key``, on the key's device."""
    k = init.root(key)
    lin = empty_linear(in_dim, out_dim, bias, k.root.device)
    linear_init(lin.weight, lin.bias if bias else None, k)
    return lin


class _SNParams(nn.Module):
    """Parameters of a spectral-norm wrapped Linear, under the reference's names."""

    def __init__(self, in_dim: int, out_dim: int, device: torch.device | str = "cpu"):
        super().__init__()
        self.weight_bar = nn.Parameter(torch.empty(out_dim, in_dim, device=device))
        self.bias = nn.Parameter(torch.empty(out_dim, device=device))
        self.register_buffer("weight_u", torch.empty(out_dim, device=device))
        self.register_buffer("weight_v", torch.empty(in_dim, device=device))


class SNLinear(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, device: torch.device | str = "cpu"):
        super().__init__()
        self.module = _SNParams(in_dim, out_dim, device)

    def weight_and_bias(self, update_sn: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
        """The normalized weight; ``update_sn`` keeps the advanced ``u``/``v``."""
        m = self.module
        w, u, v = spectral_normalize(m.weight_bar, m.weight_u)
        if update_sn:
            with torch.no_grad():
                m.weight_u.copy_(u)
                m.weight_v.copy_(v)
        return w, m.bias


def layer_weight_and_bias(layer: nn.Module, update_sn: bool = True
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """The effective ``(w [out, in], b)`` of a plain or spectral-norm layer."""
    if isinstance(layer, SNLinear):
        return layer.weight_and_bias(update_sn)
    return layer.weight, layer.bias


class MLP(nn.Module):
    def __init__(self, cfg: MLPConfig, key=None):
        """``mlp_init``'s draws from ``key`` (see :mod:`.init`), on the key's
        device: ``split(key, L + 1)``, layer ``i`` from child ``i``; a
        spectral-norm layer's ``u`` is ``normal(split(keys[-1], L)[i])``
        normalised, and ``weight_v`` (no JAX leaf) ``normalize(w^T u)``, as
        ``utils/weights`` derives it."""
        super().__init__()
        self.cfg = cfg
        k = init.root(key)
        dev = k.root.device
        keys = k.split(cfg.num_layers + 1)
        sn_keys = keys[-1].split(cfg.num_layers)
        layers = []
        for i in range(cfg.num_layers):
            d_in, d_out = cfg.sizes[i], cfg.sizes[i + 1]
            if cfg.layer_has_sn(i):
                layer = SNLinear(d_in, d_out, dev)
                p = layer.module
                linear_init(p.weight_bar, p.bias, keys[i])
                with torch.no_grad():
                    u = init.normal(sn_keys[i], (d_out,))
                    p.weight_u.copy_(u / (torch.linalg.vector_norm(u) + 1e-12))
                    v = p.weight_bar.t() @ p.weight_u
                    p.weight_v.copy_(v / (torch.linalg.vector_norm(v) + 1e-12))
            else:
                layer = empty_linear(d_in, d_out, device=dev)
                linear_init(layer.weight, layer.bias, keys[i])
            layers.append(layer)
        self.net = nn.ModuleList(layers)
        if cfg.batch_norm:
            # BatchNorm1d's own init: scale 1, bias 0, running mean 0, var 1
            self.bn = nn.ModuleList(
                nn.BatchNorm1d(cfg.sizes[i + 1], eps=_BN_EPS, device=dev)
                for i in range(cfg.num_layers)
                if cfg.layer_has_activation(i)
            )

    def forward(self, x: torch.Tensor, train: bool = False, rng=None,
                update_sn: bool = True) -> torch.Tensor:
        """``x`` (``[..., sizes[0]]``) through the stack. In train mode with
        dropout, ``rng`` (see :mod:`.keys`) splits into one key per layer, as
        ``mlp_apply`` splits its JAX key."""
        cfg = self.cfg
        dropout = train and cfg.dropout_p > 0
        if dropout and rng is None:
            raise ValueError("dropout in train mode needs an rng")
        drop_keys = rng.split(cfg.num_layers) if dropout else None
        bn_idx = 0
        for i, layer in enumerate(self.net):
            w, b = layer_weight_and_bias(layer, update_sn)
            x = torch.matmul(x, w.t()) + b
            if cfg.layer_has_activation(i):
                x = torch.where(x >= 0, x, cfg.leaky_relu_alpha * x)
                if cfg.batch_norm:
                    x = batch_norm(x, self.bn[bn_idx], train)
                    bn_idx += 1
            if dropout:
                x = hash_dropout(x, cfg.dropout_p, drop_keys[i].words())
        return x


def batch_norm(x: torch.Tensor, bn: nn.BatchNorm1d, train: bool) -> torch.Tensor:
    """BatchNorm over every axis but the last: running statistics in eval;
    in train, biased batch statistics, and the running statistics move by
    momentum 0.1 toward the batch mean and the unbiased batch variance."""
    if not train:
        return (x - bn.running_mean) * torch.rsqrt(bn.running_var + _BN_EPS) * bn.weight + bn.bias
    axes = tuple(range(x.dim() - 1))
    mean = x.mean(dim=axes)
    var = x.var(dim=axes, unbiased=False)
    n = x.numel() // x.shape[-1]
    with torch.no_grad():
        bn.running_mean.mul_(1 - _BN_MOMENTUM).add_(_BN_MOMENTUM * mean)
        bn.running_var.mul_(1 - _BN_MOMENTUM).add_(_BN_MOMENTUM * var * n / max(n - 1, 1))
    return (x - mean) * torch.rsqrt(var + _BN_EPS) * bn.weight + bn.bias
