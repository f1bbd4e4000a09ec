"""Model registry: args -> generator, discriminator and noise spec
(``mpgan_tpu/models/registry.py``, its ``mpgan`` and ``gapt`` branches; the
reference's ``setup_training.models`` + ``get_model_args``,
setup_training.py:1350-1497).

Every generator and discriminator module is called as ``module(x, labels,
train=..., rng=..., update_sn=...)``, so the train step, sampling and the entry
points name no model family.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from ..ops.masking import mask_manual
from ..training import config as cfg_mod
from ..training.sampling import NoiseSpec, noise_spec
from .gapt import GAPTDiscriminator, GAPTGenerator
from .mpgan import MPDiscriminator, MPGenerator

PORTED = ("mpgan", "gapt")


@dataclasses.dataclass
class ModelSuite:
    model: str
    model_d: str
    g_cfg: Any
    d_cfg: Any
    g_cls: type
    d_cls: type
    noise: NoiseSpec
    # applied to G's output in the D and G steps, the evaluation and sampling
    # (``--mask-manual``: the pT-cutoff mask column)
    post_gen: Callable[[torch.Tensor], torch.Tensor] | None = None

    def generator(self, rng: torch.Generator | None = None,
                  device: torch.device | str = "cpu") -> torch.nn.Module:
        return self.g_cls(self.g_cfg, rng, device=device)

    def discriminator(self, rng: torch.Generator | None = None,
                      device: torch.device | str = "cpu") -> torch.nn.Module:
        return self.d_cls(self.d_cfg, rng, device=device)


def _model_args(args: cfg_mod.Args) -> dict[str, Any]:
    """Noise-shape args per get_model_args (setup_training.py:1459-1497)."""
    return {
        "lfc": args.lfc,
        "lfc_latent_size": args.lfc_latent_size,
        "mask_learn_sep": args.mask_learn_sep,
        "latent_node_size": args.latent_node_size or args.hidden_node_size,
        "embed_dim": args.gapt_embed_dim,
    }


def check_ported(model: str, model_d: str) -> None:
    """Raise ``NotImplementedError`` for a generator/discriminator pair the port
    does not build: a family that is not ported, or a mixed pair."""
    if model not in PORTED or model_d not in PORTED:
        raise NotImplementedError(
            f"model {model!r} / discriminator {model_d!r}: only MPGAN and GAPT are ported, "
            "the other models come later (ROADMAP.md Queue 1, the other models)"
        )
    if model != model_d:
        raise NotImplementedError(
            f"model {model!r} with discriminator {model_d!r}: mixed generator/discriminator "
            "pairs are not ported yet (ROADMAP.md Queue 1, train-step leftovers)"
        )


def build_suite(args: cfg_mod.Args) -> ModelSuite:
    model = args.model
    model_d = args.get("model_D") or model
    check_ported(model, model_d)
    spec = noise_spec(model, _model_args(args), args.num_hits, args.sd)
    if model == "mpgan":
        g_cfg, g_cls = cfg_mod.build_mpgan_generator(args), MPGenerator
        d_cfg, d_cls = cfg_mod.build_mpgan_discriminator(args), MPDiscriminator
    else:
        g_cfg, g_cls = cfg_mod.build_gapt(args, gen=True), GAPTGenerator
        d_cfg, d_cls = cfg_mod.build_gapt(args, gen=False), GAPTDiscriminator
    post_gen = None
    if args.get("mask_manual"):
        def post_gen(gen_data):
            # pT cutoff 0 (the reference's placeholder, setup_training.py:1495)
            return mask_manual(gen_data, 0.0, mask_exp=args.mask_exp,
                               mask_real_only=args.mask_real_only)
    return ModelSuite(model, model_d, g_cfg, d_cfg, g_cls, d_cls, spec, post_gen)
