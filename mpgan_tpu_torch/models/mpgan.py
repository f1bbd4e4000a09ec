"""MPGAN generator, eval mode (``mpgan_tpu/models/mpgan.py``).

A stack of message-passing layers between the generator's hooks
(mpgan/model.py:387-752): the optional latent fully-connected layer ``lfc``,
the masking hook, the final activation and the ``mask - 0.5`` feature.

Masking strategies (mpgan/model.py:608-752):

- ``mask_c``: particles ranked by their first noise feature; the first
  ``count`` (from the conditioning label) get mask 1 (the flagship strategy),
- ``mask_learn``: per-particle mask from the ``fmg`` MLP (sign or sigmoid),
- ``mask_learn_sep``: a jet-level noise "particle" fed to ``fmg`` predicts the
  count (argmax),
- ``mask_feat_bin``: the last output feature becomes a binary mask.

As in the JAX package, ``fmg`` takes the generator's input node size, the
legacy model's choice (the reference's ``MPGenerator._init_mask`` references an
undefined attribute, mpgan/model.py:626). The discriminator comes with the
train step (ROADMAP.md Queue 1 item 6).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch import nn

from ..ops.linear import MLP, MLPConfig, linear_init
from ..ops.masking import counts_from_labels, mask_from_counts
from ..ops.mp import MPLayer, MPLayerConfig


@dataclasses.dataclass(frozen=True)
class MaskConfig:
    mask_learn: bool = False
    mask_learn_bin: bool = True
    mask_learn_sep: bool = False
    mask_c: bool = True
    mask_fne_np: bool = False
    mask_feat_bin: bool = False
    mask_fnd_np: bool = False
    fmg: tuple[int, ...] = (64,)

    @property
    def use_mask_gen(self) -> bool:
        return self.mask_learn or self.mask_c or self.mask_learn_sep


def _build_layers(
    num_particles: int,
    input_node_size: int,
    mp_iters: int,
    fe_layers: list[int],
    fn_layers: list[int],
    fe1_layers: list[int] | None,
    fn1_layers: list[int] | None,
    hidden_node_size: int,
    output_node_size: int,
    mp_args: dict[str, Any],
    mp_args_first_layer: dict[str, Any],
    linear_args: dict[str, Any],
) -> tuple[MPLayerConfig, ...]:
    """Layer-stack assembly mirroring MPNet.__init__ (mpgan/model.py:460-496)."""
    fe1_layers = fe_layers if fe1_layers is None else fe1_layers
    fn1_layers = fn_layers if fn1_layers is None else fn1_layers
    first_args = {**mp_args, **mp_args_first_layer}
    layers = [
        MPLayerConfig.build(
            input_node_size, list(fe1_layers), list(fn1_layers), hidden_node_size,
            linear_args=linear_args, **first_args,
        )
    ]
    for _ in range(mp_iters - 2):
        layers.append(
            MPLayerConfig.build(
                hidden_node_size, list(fe_layers), list(fn_layers), hidden_node_size,
                linear_args=linear_args, **mp_args,
            )
        )
    layers.append(
        MPLayerConfig.build(
            hidden_node_size, list(fe_layers), list(fn_layers), output_node_size,
            linear_args=linear_args, **mp_args,
        )
    )
    return tuple(layers)


@dataclasses.dataclass(frozen=True)
class MPGeneratorConfig:
    num_particles: int
    input_node_size: int
    output_node_size: int
    layers: tuple[MPLayerConfig, ...]
    mask: MaskConfig
    final_activation: str = "tanh"
    lfc: bool = False
    lfc_latent_size: int = 128
    fmg_cfg: MLPConfig | None = None
    # None = auto: the CUDA kernels for CUDA tensors, the plain path elsewhere
    use_kernels: bool | None = None

    @staticmethod
    def build(
        num_particles: int,
        input_node_size: int,
        output_node_size: int = 3,
        mp_iters: int = 2,
        fe_layers: list[int] = (96, 160, 192),
        fn_layers: list[int] = (256, 256),
        fe1_layers: list[int] | None = None,
        fn1_layers: list[int] | None = None,
        hidden_node_size: int = 32,
        final_activation: str = "tanh",
        lfc: bool = False,
        lfc_latent_size: int = 128,
        mask: MaskConfig = MaskConfig(),
        mp_args: dict[str, Any] | None = None,
        mp_args_first_layer: dict[str, Any] | None = None,
        linear_args: dict[str, Any] | None = None,
        use_kernels: bool | None = None,
    ) -> "MPGeneratorConfig":
        layers = _build_layers(
            num_particles, input_node_size, mp_iters, list(fe_layers), list(fn_layers),
            fe1_layers, fn1_layers, hidden_node_size, output_node_size,
            mp_args or {}, mp_args_first_layer or {}, linear_args or {},
        )
        fmg_cfg = None
        if mask.mask_learn or mask.mask_learn_sep:
            fmg_cfg = MLPConfig.build(
                list(mask.fmg),
                input_size=input_node_size,
                output_size=1 if mask.mask_learn else num_particles,
                final_linear=True,
                **(linear_args or {}),
            )
        return MPGeneratorConfig(
            num_particles=num_particles,
            input_node_size=input_node_size,
            output_node_size=output_node_size,
            layers=layers,
            mask=mask,
            final_activation=final_activation,
            lfc=lfc,
            lfc_latent_size=lfc_latent_size,
            fmg_cfg=fmg_cfg,
            use_kernels=use_kernels,
        )


class MPGenerator(nn.Module):
    """Generator module. Parameters are drawn on the CPU from ``generator``
    (the distributions of ``mp_generator_init``) and then moved to ``device``.
    Its ``state_dict`` keys are the reference's (``mp_layers.{i}.fe/fn.*``,
    ``lfc_layer.*``, ``fmg_layer.*``)."""

    def __init__(
        self,
        cfg: MPGeneratorConfig,
        generator: torch.Generator | None = None,
        device: torch.device | str = "cpu",
    ):
        super().__init__()
        self.cfg = cfg
        self.mp_layers = nn.ModuleList(MPLayer(c, generator) for c in cfg.layers)
        if cfg.lfc:
            self.lfc_layer = nn.Linear(cfg.lfc_latent_size, cfg.num_particles * cfg.input_node_size)
            linear_init(self.lfc_layer.weight, self.lfc_layer.bias, generator)
        if cfg.fmg_cfg is not None:
            self.fmg_layer = MLP(cfg.fmg_cfg, generator)
        self.to(device)

    def _get_mask(self, x, labels):
        """Masking hook (mpgan/model.py:632-721). Returns ``(x, mask, num_jet_particles)``."""
        m = self.cfg.mask
        if not m.use_mask_gen:
            return x, None, None
        num_jet_particles = None
        if m.mask_learn:
            raw = self.fmg_layer(x)
            mask = torch.sign(raw) if m.mask_learn_bin else torch.sigmoid(raw)
            if m.mask_fne_np:
                num_jet_particles = mask.mean(dim=1)
        elif m.mask_c:
            num_jet_particles = counts_from_labels(labels, self.cfg.num_particles)
            mask = mask_from_counts(x[:, :, 0], num_jet_particles)
        else:  # mask_learn_sep: the last "particle" is the jet-level noise
            njp_input = x[:, -1, :]
            x = x[:, :-1, :]
            num_jet_particles = torch.argmax(self.fmg_layer(njp_input), dim=1)
            mask = mask_from_counts(x[:, :, 0], num_jet_particles)
        return x, mask, num_jet_particles

    def forward(self, x: torch.Tensor, labels: torch.Tensor | None = None,
                train: bool = False) -> torch.Tensor:
        """``x``: ``[B, lfc_latent_size]`` with lfc, else ``[B, N(+1 if
        mask_learn_sep), input_node_size]`` noise. Returns ``[B, N,
        output_node_size (+1 if masked)]``, the mask feature as ``mask - 0.5``."""
        cfg = self.cfg
        if cfg.lfc:
            x = self.lfc_layer(x).reshape(x.shape[0], cfg.num_particles, cfg.input_node_size)
        x, mask, num_jet_particles = self._get_mask(x, labels)
        for layer in self.mp_layers:
            x = layer(
                x, mask=mask, labels=labels, num_jet_particles=num_jet_particles,
                train=train, use_kernels=cfg.use_kernels,
            )
        if cfg.final_activation == "tanh":
            x = torch.tanh(x)
        elif cfg.final_activation == "sigmoid":
            x = torch.sigmoid(x)
        if cfg.mask.mask_feat_bin:
            mask = torch.sign(x[:, :, -1:])
            x = x[:, :, :-1]
        if mask is not None:
            x = torch.cat([x, mask - 0.5], dim=2)
        return x
