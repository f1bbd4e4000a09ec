"""Masked multi-head attention and set-transformer blocks
(``mpgan_tpu/ops/attention.py``; the reference GAPT blocks, gapt/model.py:93-202).

- :class:`MHA`: multi-head attention with ``nn.MultiheadAttention``'s parameter
  layout (packed ``in_proj_weight [3E, E]``, ``in_proj_bias``,
  ``out_proj.{weight, bias}``), so the reference's trained GAPT weights load one
  to one. The attention is written out: ``scores / sqrt(head_dim)``, ``-inf``
  where the mask says ignore, softmax, ``weights @ v``.
- :func:`layer_norm`: eps 1e-5, biased variance.
- :class:`MAB`: ``x = x + attn(x, y, y)``; optional LN; dropout; ``x = x + ff(x)``;
  optional LN; dropout (gapt/model.py:124-139).
- :func:`sab_mask`: a JetNet mask as a bool attention mask.

The JAX package packs several (jet, head) attention problems into one
block-diagonal product for the TPU's matrix unit (``_pack_group``,
``packed_attn_bias``). That is a tiling device, not part of the function
(``exp(-inf) = 0`` contributes exact zeros), and is not carried over: each
(jet, head) is its own batched ``[Lq, Lk]`` problem here.

Train-mode dropout is :func:`.linear.hash_dropout`, keyed as the JAX package
keys it: a MAB splits its key (see :mod:`.keys`) in three, the first and the
third go to its two dropouts, the second to the ff MLP.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from . import init
from .linear import MLP, MLPConfig, hash_dropout

_LN_EPS = 1e-5


class _OutProj(nn.Module):
    def __init__(self, weight: torch.Tensor):
        super().__init__()
        self.weight = nn.Parameter(weight)
        self.bias = nn.Parameter(torch.zeros(weight.shape[0], device=weight.device))


class MHA(nn.Module):
    """Multi-head attention; ``nn.MultiheadAttention``'s default init drawn from
    ``key`` as ``mha_init`` draws it: ``k1, k2 = split(key)``, ``in_proj``
    xavier-uniform on ``[3E, E]`` from ``k1``, zero in-proj bias, out-proj
    uniform on ``+-1/sqrt(E)`` from ``k2`` with zero bias."""

    def __init__(self, embed_dim: int, num_heads: int, key=None):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(f"embed_dim {embed_dim} is not divisible by {num_heads} heads")
        self.embed_dim, self.num_heads = embed_dim, num_heads
        k1, k2 = init.root(key).split(2)
        bound = math.sqrt(6.0 / (3 * embed_dim + embed_dim))
        out_bound = 1.0 / math.sqrt(embed_dim)
        self.in_proj_weight = nn.Parameter(
            init.uniform(k1, (3 * embed_dim, embed_dim), -bound, bound))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * embed_dim, device=k1.root.device))
        self.out_proj = _OutProj(init.uniform(k2, (embed_dim, embed_dim), -out_bound, out_bound))

    def forward(self, q: torch.Tensor, kv: torch.Tensor,
                attn_mask: torch.Tensor | None = None) -> torch.Tensor:
        """``q [B, Lq, E]`` attends to ``kv [B, Lk, E]`` (keys and values).
        ``attn_mask``: optional bool ``[B, Lq, Lk]``, True = do not attend."""
        b, lq, e = q.shape
        lk = kv.shape[1]
        h, hd = self.num_heads, e // self.num_heads
        w, bias = self.in_proj_weight, self.in_proj_bias
        if q is kv:
            qp, kp, vp = (torch.matmul(q, w.t()) + bias).split(e, dim=-1)
        else:
            qp = torch.matmul(q, w[:e].t()) + bias[:e]
            kp, vp = (torch.matmul(kv, w[e:].t()) + bias[e:]).split(e, dim=-1)
        qh = qp.reshape(b, lq, h, hd).transpose(1, 2)
        kh = kp.reshape(b, lk, h, hd).transpose(1, 2)
        vh = vp.reshape(b, lk, h, hd).transpose(1, 2)
        scores = torch.matmul(qh, kh.transpose(-1, -2)) / math.sqrt(hd)
        if attn_mask is not None:
            scores = scores.masked_fill(attn_mask[:, None, :, :], float("-inf"))
        out = torch.matmul(torch.softmax(scores, dim=-1), vh)
        out = out.transpose(1, 2).reshape(b, lq, e)
        return torch.matmul(out, self.out_proj.weight.t()) + self.out_proj.bias


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    mean = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, unbiased=False, keepdim=True)
    return (x - mean) * torch.rsqrt(var + _LN_EPS) * scale + bias


@dataclasses.dataclass(frozen=True)
class MABConfig:
    """Multihead Attention Block (gapt/model.py:93-139)."""

    embed_dim: int
    num_heads: int
    ff: MLPConfig
    layer_norm: bool = False
    dropout_p: float = 0.0

    @staticmethod
    def build(
        embed_dim: int,
        num_heads: int,
        ff_layers: list[int] = (),
        layer_norm: bool = False,
        dropout_p: float = 0.0,
        final_linear: bool = True,
        linear_args: dict | None = None,
    ) -> "MABConfig":
        ff = MLPConfig.build(
            list(ff_layers), input_size=embed_dim, output_size=embed_dim,
            final_linear=final_linear, **(linear_args or {}),
        )
        return MABConfig(embed_dim, num_heads, ff, layer_norm, dropout_p)


class _Norm(nn.Module):
    """LayerNorm parameters under ``nn.LayerNorm``'s names."""

    def __init__(self, dim: int, device: torch.device | str = "cpu"):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias)


class MAB(nn.Module):
    """Submodule names follow the reference: ``attention``, ``ff``, ``norm1``,
    ``norm2``; drawn from ``key`` as ``mab_init``: ``k1, k2 = split(key)``
    for the attention and the ff MLP."""

    def __init__(self, cfg: MABConfig, key=None):
        super().__init__()
        self.cfg = cfg
        k1, k2 = init.root(key).split(2)
        self.attention = MHA(cfg.embed_dim, cfg.num_heads, k1)
        self.ff = MLP(cfg.ff, k2)
        if cfg.layer_norm:
            self.norm1 = _Norm(cfg.embed_dim, k1.root.device)
            self.norm2 = _Norm(cfg.embed_dim, k1.root.device)

    def forward(self, x: torch.Tensor, y: torch.Tensor, y_mask: torch.Tensor | None = None,
                train: bool = False, rng=None, update_sn: bool = True) -> torch.Tensor:
        cfg = self.cfg
        keys = rng.split(3) if rng is not None else (None, None, None)
        x = x + self.attention(x, y, y_mask)
        if cfg.layer_norm:
            x = self.norm1(x)
        x = _dropout(x, cfg.dropout_p, train, keys[0])
        x = x + self.ff(x, train=train, rng=keys[1], update_sn=update_sn)
        if cfg.layer_norm:
            x = self.norm2(x)
        return _dropout(x, cfg.dropout_p, train, keys[2])


def _dropout(x: torch.Tensor, p: float, train: bool, rng) -> torch.Tensor:
    if p > 0 and train:
        if rng is None:
            raise ValueError("dropout in train mode needs an rng")
        return hash_dropout(x, p, rng.words())
    return x


def sab_mask(mask: torch.Tensor | None, num_targets: int) -> torch.Tensor | None:
    """JetNet mask ``[B, N, 1]`` (1 = real) -> bool attention mask
    ``[B, num_targets, N]`` (True = ignore), gapt/model.py:148-153, 194-202."""
    if mask is None:
        return None
    ignore = mask[:, :, 0] < 0.5
    return ignore[:, None, :].expand(mask.shape[0], num_targets, mask.shape[1])
