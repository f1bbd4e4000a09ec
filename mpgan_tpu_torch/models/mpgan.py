"""MPGAN generator and discriminator (``mpgan_tpu/models/mpgan.py``).

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
undefined attribute, mpgan/model.py:626).

The discriminator (mpgan/model.py:810-894) splits the mask feature off its
input (``x[..., -1] + 0.5``), runs the message-passing stack with it, pools
the nodes (masked sum, or mean with ``+1e-12``), runs the ``fnd`` head (with
dropout after its final linear layer in train mode) and the final activation.

Train-mode dropout keys follow the JAX key paths: ``rng`` (see
:mod:`..ops.keys`) splits into one key per message-passing layer plus one for
the mask hook (G) or the ``fnd`` head (D).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch import nn

from ..ops import init
from ..ops.linear import MLP, MLPConfig, make_linear
from ..ops.masking import counts_from_labels, mask_from_counts, split_mask
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
    """Generator module. Parameters are drawn on ``device`` from the threefry
    ``key`` as ``mp_generator_init`` draws them (``ops/init.py``):
    ``split(key, len(layers) + 2)``, layer ``i`` from child ``i``, lfc from
    ``keys[-2]``, fmg from ``keys[-1]``. Its ``state_dict`` keys are the
    reference's (``mp_layers.{i}.fe/fn.*``, ``lfc_layer.*``, ``fmg_layer.*``)."""

    def __init__(
        self,
        cfg: MPGeneratorConfig,
        key=None,
        device: torch.device | str = "cpu",
    ):
        super().__init__()
        self.cfg = cfg
        keys = init.root(key, device).split(len(cfg.layers) + 2)
        self.mp_layers = nn.ModuleList(MPLayer(c, k) for c, k in zip(cfg.layers, keys))
        if cfg.lfc:
            self.lfc_layer = make_linear(cfg.lfc_latent_size,
                                         cfg.num_particles * cfg.input_node_size, keys[-2])
        if cfg.fmg_cfg is not None:
            self.fmg_layer = MLP(cfg.fmg_cfg, keys[-1])
        self.to(device)

    def _get_mask(self, x, labels, train, rng, update_sn):
        """Masking hook (mpgan/model.py:632-721). Returns ``(x, mask, num_jet_particles)``."""
        m = self.cfg.mask
        if not m.use_mask_gen:
            return x, None, None
        num_jet_particles = None
        if m.mask_learn:
            raw = self.fmg_layer(x, train=train, rng=rng, update_sn=update_sn)
            mask = torch.sign(raw) if m.mask_learn_bin else torch.sigmoid(raw)
            if m.mask_fne_np:
                num_jet_particles = mask.mean(dim=1)
        elif m.mask_c:
            num_jet_particles = counts_from_labels(labels, self.cfg.num_particles)
            mask = mask_from_counts(x[:, :, 0], num_jet_particles)
        else:  # mask_learn_sep: the last "particle" is the jet-level noise
            njp_input = x[:, -1, :]
            x = x[:, :-1, :]
            logits = self.fmg_layer(njp_input, train=train, rng=rng, update_sn=update_sn)
            num_jet_particles = torch.argmax(logits, dim=1)
            mask = mask_from_counts(x[:, :, 0], num_jet_particles)
        return x, mask, num_jet_particles

    def forward(self, x: torch.Tensor, labels: torch.Tensor | None = None,
                train: bool = False, rng=None, update_sn: bool = True) -> torch.Tensor:
        """``x``: ``[B, lfc_latent_size]`` with lfc, else ``[B, N(+1 if
        mask_learn_sep), input_node_size]`` noise. Returns ``[B, N,
        output_node_size (+1 if masked)]``, the mask feature as ``mask - 0.5``."""
        cfg = self.cfg
        n_rngs = len(self.mp_layers) + 1
        rngs = rng.split(n_rngs) if rng is not None else [None] * n_rngs
        if cfg.lfc:
            x = self.lfc_layer(x).reshape(x.shape[0], cfg.num_particles, cfg.input_node_size)
        x, mask, num_jet_particles = self._get_mask(x, labels, train, rngs[-1], update_sn)
        for layer, layer_rng in zip(self.mp_layers, rngs):
            x = layer(
                x, mask=mask, labels=labels, num_jet_particles=num_jet_particles,
                train=train, rng=layer_rng, update_sn=update_sn, use_kernels=cfg.use_kernels,
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


@dataclasses.dataclass(frozen=True)
class MPDiscriminatorConfig:
    num_particles: int
    input_node_size: int
    layers: tuple[MPLayerConfig, ...]
    mask: MaskConfig
    final_activation: str = "sigmoid"
    dea: bool = True
    dea_sum: bool = True
    fnd_cfg: MLPConfig | None = None
    mask_manual: bool = False
    # None = auto: the CUDA kernels for CUDA tensors, the plain path elsewhere
    use_kernels: bool | None = None

    @property
    def use_mask(self) -> bool:
        return (
            self.mask_manual
            or self.mask.mask_learn
            or self.mask.mask_c
            or self.mask.mask_learn_sep
        )

    @staticmethod
    def build(
        num_particles: int,
        input_node_size: int,
        mp_iters: int = 2,
        fe_layers: list[int] = (96, 160, 192),
        fn_layers: list[int] = (256, 256),
        fe1_layers: list[int] | None = None,
        fn1_layers: list[int] | None = None,
        hidden_node_size: int = 32,
        final_activation: str = "sigmoid",
        dea: bool = True,
        dea_sum: bool = True,
        fnd: list[int] = (),
        mask: MaskConfig = MaskConfig(),
        mask_manual: bool = False,
        mp_args: dict[str, Any] | None = None,
        mp_args_first_layer: dict[str, Any] | None = None,
        linear_args: dict[str, Any] | None = None,
        use_kernels: bool | None = None,
    ) -> "MPDiscriminatorConfig":
        output_node_size = 1 if not dea else hidden_node_size
        layers = _build_layers(
            num_particles, input_node_size, mp_iters, list(fe_layers), list(fn_layers),
            fe1_layers, fn1_layers, hidden_node_size, output_node_size,
            mp_args or {}, mp_args_first_layer or {}, linear_args or {},
        )
        fnd_cfg = None
        if dea:
            fnd_cfg = MLPConfig.build(
                list(fnd),
                input_size=hidden_node_size + int(mask.mask_fnd_np),
                output_size=1,
                final_linear=True,
                **(linear_args or {}),
            )
        return MPDiscriminatorConfig(
            num_particles=num_particles,
            input_node_size=input_node_size,
            layers=layers,
            mask=mask,
            final_activation=final_activation,
            dea=dea,
            dea_sum=dea_sum,
            fnd_cfg=fnd_cfg,
            mask_manual=mask_manual,
            use_kernels=use_kernels,
        )


class MPDiscriminator(nn.Module):
    """Discriminator module, drawn on ``device`` from ``key`` as
    ``mp_discriminator_init`` draws it: ``split(key, len(layers) + 1)``, fnd
    from ``keys[-1]``. ``state_dict`` keys are the reference's
    (``mp_layers.{i}.fe/fn.*``, ``fnd_layer.*``)."""

    def __init__(
        self,
        cfg: MPDiscriminatorConfig,
        key=None,
        device: torch.device | str = "cpu",
    ):
        super().__init__()
        self.cfg = cfg
        keys = init.root(key, device).split(len(cfg.layers) + 1)
        self.mp_layers = nn.ModuleList(MPLayer(c, k) for c, k in zip(cfg.layers, keys))
        if cfg.fnd_cfg is not None:
            self.fnd_layer = MLP(cfg.fnd_cfg, keys[-1])
        self.to(device)

    def forward(self, x: torch.Tensor, labels: torch.Tensor | None = None,
                train: bool = False, rng=None, update_sn: bool = True) -> torch.Tensor:
        """``x``: ``[B, N, input_node_size (+1 mask feature if masked)]``.
        Returns ``[B, 1]``."""
        cfg = self.cfg
        n_rngs = len(self.mp_layers) + 1
        rngs = rng.split(n_rngs) if rng is not None else [None] * n_rngs

        mask = None
        num_jet_particles = None
        if cfg.use_mask or cfg.mask.mask_fnd_np:
            _, mask = split_mask(x)
        if cfg.use_mask:
            x = x[:, :, :-1]
        elif not cfg.mask.mask_fnd_np:
            mask = None
        if cfg.mask.mask_fne_np:
            num_jet_particles = mask.mean(dim=1)

        mp_mask = mask if cfg.use_mask else None
        if mp_mask is not None:
            mp_mask = mp_mask.contiguous()
        for layer, layer_rng in zip(self.mp_layers, rngs):
            x = layer(
                x, mask=mp_mask, labels=labels, num_jet_particles=num_jet_particles,
                train=train, rng=layer_rng, update_sn=update_sn, use_kernels=cfg.use_kernels,
            )

        # pooling (mpgan/model.py:810-822)
        do_mean = not (cfg.dea and cfg.dea_sum)
        if cfg.use_mask:
            x = (x * mp_mask).sum(dim=1)
            if do_mean:
                x = x / (mp_mask.sum(dim=1) + 1e-12)
        else:
            x = x.mean(dim=1) if do_mean else x.sum(dim=1)

        if cfg.dea:
            if cfg.mask.mask_fnd_np:
                x = torch.cat([num_jet_particles, x], dim=1)
            x = self.fnd_layer(x, train=train, rng=rngs[-1], update_sn=update_sn)

        if cfg.final_activation == "sigmoid":
            x = torch.sigmoid(x)
        elif cfg.final_activation == "tanh":
            x = torch.tanh(x)
        return x
