"""Legacy MPGAN (``old_mpgan``, the reference's ``Graph_GAN``,
mpgan/old_model.py:9-575; ``mpgan_tpu/models/old_mpgan.py``).

The ``mpfc`` / ``mplfc`` / ``fcmp`` model families set ``model: 'old_mpgan'``.
It is the MPGAN message-passing stack on the port's :class:`MPLayer` (so its
layers run the same CUDA kernels, K4 in eval and K2/K3 in training, under the
same gate), with these differences from :mod:`.mpgan`:

- every fn (node network) ends at ``hidden_node_size``; the generator's output
  is the slice ``x[..., :node_feat_size]``, tanh on the slice only
  (old_model.py:418-423);
- the discriminator's first layer uses only the physical coordinates for its
  distance features even with ``all_ef`` (old_model.py:481-486);
- ``mask_c`` reads the particle count from ``labels[:, clabels]``, not
  ``labels[:, -1]`` (old_model.py:298);
- the mask network ``fmg`` activates its final layer too (old_model.py:286-294);
- ``mask_feat_bin`` has the inverted sign convention (old_model.py:426-430);
- a non-``dea`` discriminator takes feature 0 and mask-averages it
  (old_model.py:453-462);
- masking waits until the model epoch reaches ``mask_epoch``
  (old_model.py:268-269): the forward takes ``epoch=`` (:attr:`reads_epoch`).

Submodules: ``mp_layers.{i}.fe/fn``, ``lfc``, ``fnd``, ``fmg``; the reference's
own ``fe.{i}.{j}`` / ``fn.{i}.{j}`` / ``fnd.{j}`` / ``fmg.{j}`` keys are read
and written by ``utils/weights.py``. Train-mode keys split as the JAX module
splits them: one per message-passing layer, then ``fnd``, then ``fmg``.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch import nn

from ..ops import init
from ..ops.linear import MLP, MLPConfig, make_linear
from ..ops.masking import mask_from_counts, split_mask
from ..ops.mp import MPLayer, MPLayerConfig
from .mpgan import MaskConfig, _build_layers


@dataclasses.dataclass(frozen=True)
class OldMPGANConfig:
    is_gen: bool
    num_particles: int
    node_feat_size: int
    hidden_node_size: int
    layers: tuple[MPLayerConfig, ...]
    mask: MaskConfig
    clabels: int = 0
    gtanh: bool = True
    lfc: bool = False
    lfc_latent_size: int = 128
    first_layer_node_size: int = 32
    dea: bool = True
    dea_sum: bool = True
    fnd_cfg: MLPConfig | None = None
    fmg_cfg: MLPConfig | None = None
    mask_manual: bool = False
    mask_real_only: bool = False
    mask_epoch: int = 0
    final_sigmoid: bool = True  # D only; off for w/hinge losses
    # None = auto: the CUDA kernels for CUDA tensors, the plain path elsewhere
    use_kernels: bool | None = None

    @staticmethod
    def build(args: Any, gen: bool) -> "OldMPGANConfig":
        """From a processed args object, as Graph_GAN.__init__ (old_model.py:12-197)."""
        first_node = ((args.latent_node_size or args.hidden_node_size) if gen
                      else args.node_feat_size)
        linear_args = {
            "leaky_relu_alpha": args.leaky_relu_alpha,
            "dropout_p": args.gen_dropout if gen else args.disc_dropout,
            "batch_norm": args.batch_norm_gen if gen else args.batch_norm_disc,
            "spectral_norm": args.spectral_norm_gen if gen else args.spectral_norm_disc,
        }
        mp_args = {
            "pos_diffs": args.pos_diffs,
            "all_ef": args.all_ef,
            "coords": args.coords,
            "delta_coords": args.deltacoords,
            "delta_r": args.deltar,
            "clabels": args.clabels if args.clabels_hl else 0,
            "mask_fne_np": args.mask_fne_np,
            "fully_connected": args.fully_connected,
            "num_knn": args.num_knn,
            "self_loops": args.self_loops,
            "sum_agg": args.sum,
        }
        first_args = {"clabels": args.clabels if args.clabels_fl else 0}
        if not gen:
            first_args["all_ef"] = False
        mp_iters = (args.mp_iters_gen if gen else args.mp_iters_disc) or args.mp_iters
        fe1 = args.fe1g if gen else args.fe1d
        layers = _build_layers(
            args.num_hits, first_node, mp_iters, list(args.fe), list(args.fn),
            list(fe1) if fe1 else None, None, args.hidden_node_size,
            args.hidden_node_size,  # every fn ends at the hidden size
            mp_args, first_args, linear_args,
        )
        mask = MaskConfig(
            mask_learn=args.mask_learn,
            mask_learn_bin=args.mask_learn_bin,
            mask_learn_sep=args.mask_learn_sep,
            mask_c=args.mask_c,
            mask_fne_np=args.mask_fne_np,
            mask_feat_bin=args.mask_feat_bin,
            mask_fnd_np=args.mask_fnd_np,
            fmg=tuple(args.fmg),
        )
        fnd_cfg = None
        if not gen and args.dea:
            fnd_cfg = MLPConfig.build(
                list(args.fnd), input_size=args.hidden_node_size + int(args.mask_fnd_np),
                output_size=1, final_linear=True, **linear_args,
            )
        fmg_cfg = None
        if gen and (args.mask_learn or args.mask_learn_sep):
            fmg_cfg = MLPConfig.build(
                list(args.fmg), input_size=first_node,
                output_size=1 if args.mask_learn else args.num_hits,
                final_linear=False, **linear_args,
            )
        use_kernels = args.get("use_pallas")
        if not gen and args.get("gp"):
            # the gradient penalty's double backward: the kernels' backward is
            # once differentiable (as config.build_mpgan_discriminator)
            use_kernels = False
        return OldMPGANConfig(
            is_gen=gen,
            num_particles=args.num_hits,
            node_feat_size=args.node_feat_size,
            hidden_node_size=args.hidden_node_size,
            layers=layers,
            mask=mask,
            clabels=args.clabels,
            gtanh=args.gtanh,
            lfc=args.lfc and gen,
            lfc_latent_size=args.lfc_latent_size,
            first_layer_node_size=first_node,
            dea=args.dea if not gen else False,
            dea_sum=args.sum,
            fnd_cfg=fnd_cfg,
            fmg_cfg=fmg_cfg,
            mask_manual=args.mask_manual,
            mask_real_only=args.mask_real_only,
            mask_epoch=args.mask_epoch,
            final_sigmoid=args.loss not in ("w", "hinge"),
            use_kernels=use_kernels,
        )


class OldMPGAN(nn.Module):
    """The legacy generator (``cfg.is_gen``) or discriminator."""

    reads_epoch = True

    def __init__(self, cfg: OldMPGANConfig, key=None, device: torch.device | str = "cpu"):
        """Drawn on ``device`` from ``key`` as ``old_mpgan_init`` draws it:
        ``split(key, len(layers) + 3)``, lfc, fnd and fmg from ``keys[-3]``,
        ``keys[-2]`` and ``keys[-1]``."""
        super().__init__()
        self.cfg = cfg
        keys = init.root(key, device).split(len(cfg.layers) + 3)
        self.mp_layers = nn.ModuleList(MPLayer(c, k) for c, k in zip(cfg.layers, keys))
        if cfg.lfc:
            self.lfc = make_linear(cfg.lfc_latent_size,
                                   cfg.num_particles * cfg.first_layer_node_size, keys[-3])
        if cfg.fnd_cfg is not None:
            self.fnd = MLP(cfg.fnd_cfg, keys[-2])
        if cfg.fmg_cfg is not None:
            self.fmg = MLP(cfg.fmg_cfg, keys[-1])
        self.to(device)

    def forward(self, x: torch.Tensor, labels: torch.Tensor | None = None,
                train: bool = False, rng=None, update_sn: bool = True,
                epoch: int = 0) -> torch.Tensor:
        """Graph_GAN.forward (old_model.py:243-466). Generator: noise ``[B,
        lfc_latent_size]`` with lfc, else ``[B, N(+1), node]`` -> ``[B, N, feat
        (+1 mask)]``; discriminator: ``[B, N, feat (+1 mask)]`` -> ``[B, 1]``."""
        cfg, m = self.cfg, self.cfg.mask
        n_rngs = len(self.mp_layers) + 2
        rngs = rng.split(n_rngs) if rng is not None else [None] * n_rngs

        if cfg.lfc:
            x = self.lfc(x).reshape(x.shape[0], cfg.num_particles, cfg.first_layer_node_size)

        mask = None
        num_jet_particles = None
        if cfg.is_gen:
            mask_bool = (m.mask_learn or m.mask_c or m.mask_learn_sep) and epoch >= cfg.mask_epoch
            if m.mask_learn:
                raw = self.fmg(x, train=train, rng=rngs[-1], update_sn=update_sn)
                mask = torch.sign(raw) if m.mask_learn_bin else torch.sigmoid(raw)
            elif m.mask_c:
                # the legacy label index (old_model.py:298)
                nump = (labels[:, cfg.clabels] * cfg.num_particles).to(torch.int32) - 1
                mask = mask_from_counts(x[:, :, 0], nump)
            elif m.mask_learn_sep:
                nump_in = x[:, -1, :]
                x = x[:, :-1, :]
                logits = self.fmg(nump_in, train=train, rng=rngs[-1], update_sn=update_sn)
                mask = mask_from_counts(x[:, :, 0], torch.argmax(logits, dim=1))
        else:
            mask_bool = (cfg.mask_manual or cfg.mask_real_only or m.mask_learn or m.mask_c
                         or m.mask_learn_sep) and epoch >= cfg.mask_epoch
            if mask_bool or m.mask_fnd_np:
                _, mask = split_mask(x)
            if cfg.mask_manual or m.mask_learn or m.mask_c or m.mask_learn_sep:
                x = x[:, :, : cfg.node_feat_size]
        if m.mask_fne_np and mask is not None:
            num_jet_particles = mask.mean(dim=1)

        mp_mask = mask.contiguous() if mask_bool else None
        for layer, layer_rng in zip(self.mp_layers, rngs):
            x = layer(x, mask=mp_mask, labels=labels, num_jet_particles=num_jet_particles,
                      train=train, rng=layer_rng, update_sn=update_sn,
                      use_kernels=cfg.use_kernels)

        if cfg.is_gen:
            out = x[:, :, : cfg.node_feat_size]
            if cfg.gtanh:
                out = torch.tanh(out)
            if mask_bool:
                out = torch.cat([out, mask - 0.5], dim=2)
            if m.mask_feat_bin:
                # inverted sign against the modern model (old_model.py:426-430)
                inv = (out[:, :, 3:4] < 0).to(out.dtype) - 0.5
                out = torch.cat([out[:, :, :3], inv], dim=2)
            return out

        if cfg.dea:
            if mask_bool:
                x = (x * mask).sum(dim=1)
                if not cfg.dea_sum:
                    x = x / (mask.sum(dim=1) + 1e-12)
            else:
                x = x.sum(dim=1) if cfg.dea_sum else x.mean(dim=1)
            if m.mask_fnd_np:
                x = torch.cat([mask.mean(dim=1), x], dim=1)
            x = self.fnd(x, train=train, rng=rngs[-2], update_sn=update_sn)
        else:
            x = x[:, :, :1]
            if mask_bool:
                x = (x * mask).sum(dim=1) / (mask.sum(dim=1) + 1e-12)
            else:
                x = x.mean(dim=1)
        return torch.sigmoid(x) if cfg.final_sigmoid else x
