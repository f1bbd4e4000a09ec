"""GAPT, the Generative Adversarial Particle Transformer
(``mpgan_tpu/models/gapt.py``; ``GAPT_G`` / ``GAPT_D``, gapt/model.py:205-344).

Stacks of set-attention blocks (SAB, or ISAB with learned inducing points). The
generator masks with the same conditional-count trick as MPGAN (particles
ranked by their first noise feature, the first ``count`` real) and appends
``mask - 0.5``; the discriminator splits the mask off, embeds the particles,
pools through a PMA with one learned seed and ends in a fully connected head.

Module and parameter names follow the reference's state dict
(``sabs.{i}.mab.attention.in_proj_weight``, ``sabs.{i}.mab.ff.net.0.weight``,
``sabs.{i}.{I, mab0, mab1}`` with ISAB, ``pma.S``, ``pma.mab``,
``input_embedding``, ``final_fc``), so a reference ``.pt`` loads with
``load_state_dict(strict=True)``.

Train-mode dropout keys follow the JAX key paths (see :mod:`..ops.keys`): the
generator splits its key into ``sab_layers + 1`` (one per SAB, the last for the
final FC), the discriminator into ``sab_layers + 3`` (embedding, SABs, PMA,
final FC); an ISAB splits its key in two.

An eligible eval-mode generator forward (:func:`..ops.gapt_kernels.fused_gapt_eligible`)
that needs no gradient runs as one CUDA kernel (K9). ``use_kernels=None`` takes
it for CUDA tensors and the plain path elsewhere; ``True`` on the CPU runs the
kernel's plain version. Training, and the discriminator always, take the plain
path and autograd.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
from torch import nn

from ..ops import init
from ..ops.attention import MAB, MABConfig, sab_mask
from ..ops.gapt_kernels import (
    GaptWeights,
    fused_gapt_eligible,
    gapt_g_fused,
    pack_gapt_weights,
)
from ..ops.linear import MLP, MLPConfig
from ..ops.masking import counts_from_labels, mask_from_counts, split_mask


@dataclasses.dataclass(frozen=True)
class GAPTConfig:
    """Shared config of the GAPT generator and discriminator
    (gapt/model.py:206-249, 278-330)."""

    num_particles: int
    feat_size: int  # output feats for G, input feats for D
    is_generator: bool
    sab_layers: int = 2
    num_heads: int = 4
    embed_dim: int = 32
    sab_fc_layers: tuple[int, ...] = ()
    layer_norm: bool = False
    dropout_p: float = 0.0
    final_fc_layers: tuple[int, ...] = ()
    use_mask: bool = True
    use_isab: bool = False
    num_isab_nodes: int = 10
    linear_args: tuple[tuple[str, Any], ...] = ()
    # None = auto: the fused generator kernel for CUDA tensors, the plain path elsewhere
    use_kernels: bool | None = None

    def _linear_args(self) -> dict:
        return dict(self.linear_args)

    def mab_cfg(self) -> MABConfig:
        return MABConfig.build(
            embed_dim=self.embed_dim,
            num_heads=self.num_heads,
            ff_layers=list(self.sab_fc_layers),
            layer_norm=self.layer_norm,
            dropout_p=self.dropout_p,
            final_linear=False,
            linear_args=self._linear_args(),
        )

    def final_fc_cfg(self) -> MLPConfig:
        return MLPConfig.build(
            list(self.final_fc_layers),
            input_size=self.embed_dim,
            output_size=self.feat_size if self.is_generator else 1,
            final_linear=True,
            **self._linear_args(),
        )

    def embed_cfg(self) -> MLPConfig:
        """D-side input embedding (gapt/model.py:311-313): a one-layer
        LinearNet with activation (not final-linear)."""
        return MLPConfig.build(
            [], input_size=self.feat_size, output_size=self.embed_dim,
            **self._linear_args(),
        )


def _xavier_uniform(shape: tuple[int, ...], key) -> nn.Parameter:
    fan_in, fan_out = shape[-1], shape[-2]
    bound = math.sqrt(6.0 / (fan_in + fan_out))
    return nn.Parameter(init.uniform(key, shape, -bound, bound))


class SAB(nn.Module):
    """One set-attention block: a single MAB (``mab``), or with ``use_isab``
    the inducing points ``I`` and two MABs, ``H = mab0(I, x)``,
    ``out = mab1(x, H)`` (gapt/model.py:142-191). Drawn from ``key`` as
    ``_sab_init``: the MAB from the key itself, or ``k_i, k0, k1 = split(key,
    3)`` for ``I``, ``mab0`` and ``mab1``."""

    def __init__(self, cfg: GAPTConfig, key=None):
        super().__init__()
        self.cfg = cfg
        mab_cfg = cfg.mab_cfg()
        k = init.root(key)
        if not cfg.use_isab:
            self.mab = MAB(mab_cfg, k)
        else:
            k_i, k0, k1 = k.split(3)
            self.I = _xavier_uniform((1, cfg.num_isab_nodes, cfg.embed_dim), k_i)
            self.mab0 = MAB(mab_cfg, k0)
            self.mab1 = MAB(mab_cfg, k1)

    def forward(self, x, mask, train: bool, rng, update_sn: bool) -> torch.Tensor:
        cfg = self.cfg
        if not cfg.use_isab:
            return self.mab(x, x, sab_mask(mask, x.shape[1]), train=train, rng=rng,
                            update_sn=update_sn)
        r0, r1 = rng.split(2) if rng is not None else (None, None)
        inducing = self.I.expand(x.shape[0], -1, -1)
        h = self.mab0(inducing, x, sab_mask(mask, cfg.num_isab_nodes), train=train, rng=r0,
                      update_sn=update_sn)
        return self.mab1(x, h, None, train=train, rng=r1, update_sn=update_sn)


class GAPTGenerator(nn.Module):
    """Generator module. Parameters are drawn on ``device`` from the threefry
    ``key`` as ``gapt_g_init`` draws them (``ops/init.py``): ``split(key, L +
    1)``, SAB ``i`` from child ``i``, final_fc from ``keys[-1]``."""

    def __init__(self, cfg: GAPTConfig, key=None, device: torch.device | str = "cpu"):
        super().__init__()
        self.cfg = cfg
        keys = init.root(key, device).split(cfg.sab_layers + 1)
        self.sabs = nn.ModuleList(SAB(cfg, keys[i]) for i in range(cfg.sab_layers))
        self.final_fc = MLP(cfg.final_fc_cfg(), keys[-1])
        self._packed: tuple[tuple, GaptWeights] | None = None
        self.to(device)

    def fused_weights(self) -> GaptWeights:
        """The weights as K9 reads them. The module's own parameters are packed
        again only after one changed (address or version). Packed on every call
        are tensors that stand in for them (``torch.func.functional_call``, as
        ``bf16_apply``'s bf16 copies: fresh tensors, whose address and version
        may repeat with other values) and the parameters while a CUDA graph is
        captured, so that each replay packs what the parameters then hold (an
        update replayed in a graph changes no version)."""
        layers = []
        for sab in self.sabs:
            att, lin = sab.mab.attention, sab.mab.ff.net[0]
            layers.append((att.in_proj_weight, att.in_proj_bias, att.out_proj.weight,
                           att.out_proj.bias, lin.weight, lin.bias))
        fc = self.final_fc.net[0]
        flat = [t for layer in layers for t in layer] + [fc.weight, fc.bias]
        capturing = flat[0].is_cuda and torch.cuda.is_current_stream_capturing()
        if capturing or not all(isinstance(t, nn.Parameter) for t in flat):
            with torch.no_grad():
                return pack_gapt_weights(layers, fc.weight, fc.bias)
        stamp = tuple((t.data_ptr(), t._version) for t in flat)
        if self._packed is None or self._packed[0] != stamp:
            with torch.no_grad():
                self._packed = (stamp, pack_gapt_weights(layers, fc.weight, fc.bias))
        return self._packed[1]

    def forward(self, x: torch.Tensor, labels: torch.Tensor | None = None,
                train: bool = False, rng=None, update_sn: bool = True) -> torch.Tensor:
        """``x``: ``[B, N, embed_dim]`` noise. Returns ``[B, N, feat_size (+1 if
        masked)]``, the mask feature as ``mask - 0.5``."""
        cfg = self.cfg
        n_rngs = cfg.sab_layers + 1
        rngs = rng.split(n_rngs) if rng is not None else [None] * n_rngs
        mask = None
        if cfg.use_mask:
            mask = mask_from_counts(x[:, :, 0], counts_from_labels(labels, cfg.num_particles))

        use_kernels = x.is_cuda if cfg.use_kernels is None else cfg.use_kernels
        needs_grad = torch.is_grad_enabled() and (
            x.requires_grad or any(p.requires_grad for p in self.parameters()))
        if use_kernels and not needs_grad and fused_gapt_eligible(cfg, train):
            alpha = float(cfg._linear_args().get("leaky_relu_alpha", 0.2))
            return gapt_g_fused(x.contiguous(), None if mask is None else mask.contiguous(),
                                self.fused_weights(), cfg.num_heads, alpha)

        for sab, sab_rng in zip(self.sabs, rngs):
            x = sab(x, mask, train, sab_rng, update_sn)
        x = torch.tanh(self.final_fc(x, train=train, rng=rngs[-1], update_sn=update_sn))
        if mask is not None:
            x = torch.cat([x, mask - 0.5], dim=2)
        return x


class PMA(nn.Module):
    """Pooling by multihead attention with one learned seed ``S``
    (gapt/model.py:158-174, 319-322); ``k_seed, k_mab = split(key)``."""

    def __init__(self, cfg: GAPTConfig, key=None):
        super().__init__()
        k_seed, k_mab = init.root(key).split(2)
        self.S = _xavier_uniform((1, 1, cfg.embed_dim), k_seed)
        self.mab = MAB(cfg.mab_cfg(), k_mab)

    def forward(self, x, mask, train: bool, rng, update_sn: bool) -> torch.Tensor:
        seed = self.S.expand(x.shape[0], -1, -1)
        return self.mab(seed, x, sab_mask(mask, 1), train=train, rng=rng, update_sn=update_sn)


class GAPTDiscriminator(nn.Module):
    """Drawn from ``key`` as ``gapt_d_init``: ``split(key, L + 3)``, the
    embedding from ``keys[0]``, SAB ``i`` from ``keys[i + 1]``, the PMA from
    ``keys[-2]``, final_fc from ``keys[-1]``."""

    def __init__(self, cfg: GAPTConfig, key=None, device: torch.device | str = "cpu"):
        super().__init__()
        self.cfg = cfg
        keys = init.root(key, device).split(cfg.sab_layers + 3)
        self.input_embedding = MLP(cfg.embed_cfg(), keys[0])
        self.sabs = nn.ModuleList(SAB(cfg, keys[i + 1]) for i in range(cfg.sab_layers))
        self.pma = PMA(cfg, keys[-2])
        self.final_fc = MLP(cfg.final_fc_cfg(), keys[-1])
        self.to(device)

    def forward(self, x: torch.Tensor, labels: torch.Tensor | None = None,
                train: bool = False, rng=None, update_sn: bool = True) -> torch.Tensor:
        """``x``: ``[B, N, feat_size (+1 mask feature if masked)]``. Returns the
        sigmoid score ``[B, 1]``."""
        cfg = self.cfg
        n_rngs = cfg.sab_layers + 3
        rngs = rng.split(n_rngs) if rng is not None else [None] * n_rngs
        mask = None
        if cfg.use_mask:
            x, mask = split_mask(x)
        x = self.input_embedding(x, train=train, rng=rngs[0], update_sn=update_sn)
        for sab, sab_rng in zip(self.sabs, rngs[1:]):
            x = sab(x, mask, train, sab_rng, update_sn)
        pooled = self.pma(x, mask, train, rngs[-2], update_sn)
        out = self.final_fc(pooled[:, 0, :], train=train, rng=rngs[-1], update_sn=update_sn)
        return torch.sigmoid(out)
