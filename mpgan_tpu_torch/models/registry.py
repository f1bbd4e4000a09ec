"""Model registry: args -> generator, discriminator and noise spec
(``mpgan_tpu/models/registry.py``; the reference's ``setup_training.models`` +
``get_model_args``, setup_training.py:1350-1497).

Every generator and discriminator module is called as ``module(x, labels,
train=..., rng=..., update_sn=...)`` (a module with ``reads_epoch`` also takes
``epoch=``), so the train step, sampling and the entry points name no model
family. Generators: ``mpgan``, ``old_mpgan``, ``gapt``, ``rgan``,
``graphcnngan``, ``treegan``, ``pcgan``; discriminators: ``mpgan``,
``old_mpgan``, ``gapt``, ``rgan``, ``pointnet``, ``pcgan``; any pair.
"""

from __future__ import annotations

import dataclasses
import pathlib
from typing import Any, Callable

import torch

from ..ops.masking import mask_manual
from ..training import config as cfg_mod
from ..training.sampling import NoiseSpec, noise_spec
from . import ext
from .gapt import GAPTDiscriminator, GAPTGenerator
from .mpgan import MPDiscriminator, MPGenerator
from .old_mpgan import OldMPGAN, OldMPGANConfig


@dataclasses.dataclass
class ModelSuite:
    model: str
    model_d: str
    g_cfg: Any
    d_cfg: Any
    g_cls: type
    d_cls: type
    noise: NoiseSpec
    # maps real clouds into the training representation (PCGAN's G_inv latents)
    encode_real: Callable[[torch.Tensor], torch.Tensor] | None = None
    # decodes generated latents into clouds at evaluation, ``(out, point_noise)``
    # (PCGAN's G_pc)
    decode_eval: Callable[[torch.Tensor, torch.Tensor], torch.Tensor] | None = None
    # applied to G's output in the D and G steps, the evaluation and sampling
    # (``--mask-manual``: the pT-cutoff mask column)
    post_gen: Callable[[torch.Tensor], torch.Tensor] | None = None

    def generator(self, key: torch.Tensor | None = None,
                  device: torch.device | str = "cpu") -> torch.nn.Module:
        """G drawn on ``device`` from the threefry ``key`` (``PRNGKey(0)`` when
        None), as the JAX family's init draws it from the same key."""
        return self.g_cls(self.g_cfg, key, device=device)

    def discriminator(self, key: torch.Tensor | None = None,
                      device: torch.device | str = "cpu") -> torch.nn.Module:
        """D drawn on ``device`` from ``key``, as :meth:`generator`."""
        return self.d_cls(self.d_cfg, key, device=device)


def _model_args(args: cfg_mod.Args) -> dict[str, Any]:
    """Noise-shape args per get_model_args (setup_training.py:1459-1497).
    ``sample_points``: PCGAN's per-point decoder noise is drawn (train.py:212-213;
    the JAX registry leaves it off, and its PCGAN evaluation then cannot decode)."""
    return {
        "lfc": args.lfc,
        "lfc_latent_size": args.lfc_latent_size,
        "mask_learn_sep": args.mask_learn_sep,
        "latent_node_size": args.latent_node_size or args.hidden_node_size,
        "embed_dim": args.gapt_embed_dim,
        "latent_dim": args.latent_dim,
        "treegang_features": list(args.treegang_features),
        "pcgan_latent_dim": args.pcgan_latent_dim,
        "pcgan_z2_dim": args.pcgan_z2_dim,
        "sample_points": True,
    }


def build_suite(args: cfg_mod.Args, pcgan_weights_dir: str | None = None) -> ModelSuite:
    model = args.model
    model_d = args.get("model_D") or {"mpgan": "mpgan", "pcgan": "pcgan",
                                      "gapt": "gapt"}.get(model, "rgan")
    spec = noise_spec(model, _model_args(args), args.num_hits, args.sd)

    if model == "mpgan":
        g_cfg, g_cls = cfg_mod.build_mpgan_generator(args), MPGenerator
    elif model == "old_mpgan":
        g_cfg, g_cls = OldMPGANConfig.build(args, gen=True), OldMPGAN
    elif model == "gapt":
        g_cfg, g_cls = cfg_mod.build_gapt(args, gen=True), GAPTGenerator
    elif model in ("rgan", "graphcnngan", "treegan", "pcgan"):
        g_cfg, g_cls = ext.build_generator(args)
    else:
        raise ValueError(f"unknown model {model!r}")

    if model_d == "mpgan":
        d_cfg, d_cls = cfg_mod.build_mpgan_discriminator(args), MPDiscriminator
    elif model_d == "old_mpgan":
        d_cfg, d_cls = OldMPGANConfig.build(args, gen=False), OldMPGAN
    elif model_d == "gapt":
        d_cfg, d_cls = cfg_mod.build_gapt(args, gen=False), GAPTDiscriminator
    elif model_d in ("rgan", "pointnet", "pcgan"):
        d_cfg, d_cls = ext.build_discriminator(args, model_d)
    else:
        raise ValueError(f"unknown model_D {model_d!r}")

    encode_real = decode_eval = None
    if model == "pcgan":
        encode_real, decode_eval = _pcgan_hooks(args, pcgan_weights_dir)

    post_gen = None
    if args.get("mask_manual"):
        def post_gen(gen_data):
            # pT cutoff 0 (the reference's placeholder, setup_training.py:1495)
            return mask_manual(gen_data, 0.0, mask_exp=args.mask_exp,
                               mask_real_only=args.mask_real_only)
    return ModelSuite(model, model_d, g_cfg, d_cfg, g_cls, d_cls, spec, encode_real,
                      decode_eval, post_gen)


def pcgan_weight_path(args: cfg_mod.Args, weights_dir: str | None, net: str) -> pathlib.Path:
    """``<weights_dir>/pcgan_G_<net>_<jet>.pt`` (setup_training.py:1429-1456)."""
    return pathlib.Path(weights_dir or ".") / f"pcgan_G_{net}_{args.jets}.pt"


def _run_on(module: torch.nn.Module, *xs: torch.Tensor) -> torch.Tensor:
    """``module(*xs)`` without gradients, the module moved to the inputs' device."""
    if next(module.parameters()).device != xs[0].device:
        with torch.inference_mode(False), torch.no_grad():
            module.to(xs[0].device)
    with torch.no_grad():
        return module(*xs)


def _pcgan_hooks(args: cfg_mod.Args, weights_dir: str | None):
    """PCGAN's pre-trained inference net encodes real clouds to latents for
    training (train.py:837-839), and its point decoder turns generated latents
    back into clouds at evaluation (train.py:212-213). Their reference state
    dicts ``pcgan_G_inv_<jet>.pt`` / ``pcgan_G_pc_<jet>.pt`` load from
    ``weights_dir`` (``torch.load(weights_only=True)``); a missing file leaves
    its hook ``None``, and the trainer refuses to train (no G_inv) or to
    evaluate (no G_pc)."""
    from ..utils.weights import load_reference_state_dict
    from .ext.pcgan import GInv, GPc

    if weights_dir is None:
        return None, None
    cfg = ext.pcgan_config(args)
    encode_real = decode_eval = None
    inv_path = pcgan_weight_path(args, weights_dir, "inv")
    if inv_path.exists():
        g_inv = GInv(cfg)
        g_inv.load_state_dict(load_reference_state_dict(str(inv_path)), strict=True)

        def encode_real(x):
            return _run_on(g_inv, x)

    pc_path = pcgan_weight_path(args, weights_dir, "pc")
    if pc_path.exists():
        g_pc = GPc(cfg)
        g_pc.load_state_dict(load_reference_state_dict(str(pc_path)), strict=True)

        def decode_eval(latents, point_noise):
            return _run_on(g_pc, latents[:, None, :], point_noise)

    return encode_real, decode_eval
