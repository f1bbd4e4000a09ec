"""Run configuration: reference-compatible args and the generator builder
(``mpgan_tpu/training/config.py``; plain-Python dict logic).

The reference drives everything from a ~130-flag argparse namespace persisted
as an eval-able dict string (``<name>_args.txt``, setup_training.py:1159-1163)
that doubles as the model-card format for the shipped ``trained_models``. This
module defines the same defaults (setup_training.py:76-715), applies the same
defaulting cascade (process_args, setup_training.py:747-1040) and builds the
generator and discriminator configs the way ``setup_mpgan`` does
(setup_training.py:1195-1347), and GAPT's (``build_gapt``). The card's
``use_pallas`` key selects the MPGAN kernel path (``use_kernels``); as in the
JAX package it is not wired into the GAPT config, whose ``use_kernels`` stays
at its default (the fused generator kernel for CUDA tensors).
"""

from __future__ import annotations

import ast
import math
from typing import Any

from ..models.gapt import GAPTConfig
from ..models.mpgan import MaskConfig, MPDiscriminatorConfig, MPGeneratorConfig


class Args:
    """Attribute-access dict (the reference's ``objectview``,
    setup_training.py:69-73)."""

    def __init__(self, d: dict[str, Any]):
        self.__dict__ = dict(d)

    def __getitem__(self, k):
        return self.__dict__[k]

    def __contains__(self, k):
        return k in self.__dict__

    def get(self, k, default=None):
        return self.__dict__.get(k, default)

    def to_dict(self) -> dict[str, Any]:
        return dict(self.__dict__)


def defaults() -> dict[str, Any]:
    """Reference argparse defaults (setup_training.py:76-715)."""
    return dict(
        # meta
        name="test", dataset="jets", ttsplit=0.7, model="mpgan", model_D="",
        num_epochs=2000, jets="g", seed=4, batch_size=0,
        num_samples=50000, real_only=False, debug=False, debug_nans=False,
        break_zero=False, eval_shuffle=False, epoch_scan=True,
        low_samples=False, const_ylim=False, save_zero=False, save_epochs=0,
        save_model_epochs=0, bottleneck=False, log="INFO", log_file="",
        dir_path="", datasets_path="", start_epoch=-1, load_model=True,
        override_load_check=False, override_args=False, multi_gpu=False, n=False, lx=False,
        no_save_zero_or=False,
        # optimization
        optimizer="rmsprop", loss="ls", lr_disc=0.0, lr_gen=0.0, lr_x=1.0,
        beta1=0.9, beta2=0.999, num_critic=1, num_gen=1,
        # regularization
        batch_norm_disc=False, batch_norm_gen=False, spectral_norm=False,
        spectral_norm_disc=False, spectral_norm_gen=False,
        disc_dropout=0.5, gen_dropout=0.0, label_smoothing=False,
        label_noise=0.0, gp=0.0,
        # evaluation
        fpnd=False, fpd=False, efp=False, cov_mmd=False, fpnd_batch_size=256, efp_jobs=0,
        gpu_batch=50, eval=True, eval_tot_samples=50000, w1_num_samples=[50000],
        cov_mmd_num_samples=100, cov_mmd_num_batches=10, jf=["mass", "pt"],
        # masking
        mask_feat=False, mask_feat_bin=False, mask_weights=False,
        mask_manual=False, mask_exp=False, mask_real_only=False,
        mask_learn=False, mask_learn_bin=True, mask_learn_sep=False,
        mask_disc_sep=False, mask_fnd_np=False, mask_c=True, mask_fne_np=False,
        mask_epoch=0, noise_padding=False,
        # augmentation
        aug_t=False, aug_f=False, aug_r90=False, aug_s=False,
        translate_ratio=0.125, scale_sd=0.125, translate_pn_ratio=0.05,
        adaptive_prob=False, aug_prob=1.0,
        # mnist
        mnist_num=-1, fid_eval_samples=8192, mnist_eval_resources="",
        # mpgan arch
        num_hits=30, coords="polarrel", norm=1.0, sd=0.2, node_feat_size=3,
        hidden_node_size=32, latent_node_size=0, clabels=0, clabels_fl=True,
        clabels_hl=True, fn=[256, 256], fe1g=0, fe1d=0, fe=[96, 160, 192],
        fmg=[64], mp_iters_gen=0, mp_iters_disc=0, mp_iters=2, sum=True,
        int_diffs=False, pos_diffs=False, all_ef=False, deltar=False,
        deltacoords=False, leaky_relu_alpha=0.2, dea=True, fnd=[], lfc=False,
        lfc_latent_size=128, fully_connected=True, num_knn=10, self_loops=True,
        glorot=0.0, gtanh=True,
        # gapt arch
        sab_layers_gen=4, sab_layers_disc=2, num_heads=4, gapt_embed_dim=64,
        sab_fc_layers=[], final_fc_layers_gen=[], final_fc_layers_disc=[],
        num_isab_nodes=10, gapt_mask=True, use_isab=False, layer_norm=False,
        layer_norm_disc=False, layer_norm_gen=False,
        # ext models
        latent_dim=128, rgang_fc=[64, 128], rgand_sfc=0, rgand_fc=0,
        pointnetd_pointfc=[64, 128, 1024], pointnetd_fc=[512],
        graphcnng_layers=[32, 24], graphcnng_tanh=False,
        treegang_degrees=[2, 2, 2, 2, 2], treegang_features=[96, 64, 64, 64, 64, 3],
        treegang_support=10, pcgan_latent_dim=128, pcgan_z1_dim=256,
        pcgan_z2_dim=10, pcgan_d_dim=256, pcgan_pool="max1", pcgan_weights_dir="",
        # framework-specific (no reference counterpart)
        compute_dtype="float32", use_pallas=None, mesh_shape=None, profile=False,
    )


class ArgsError(ValueError):
    """A config the reference refuses to run (setup_training.py:717-744).

    The reference ``logging.error(...); sys.exit()``s; we raise so library
    callers can catch, and the CLI converts to a loud exit."""


def check_args_errors(args: Args) -> None:
    """Mirror of the reference's ``check_args_errors``
    (setup_training.py:717-744): reject the configs it refuses to run
    instead of silently ignoring the flags."""
    if args.real_only and (args.jets != "t" or args.num_hits != 30):
        raise ArgsError("real only arg works only with 30p t jets")
    if args.int_diffs:
        raise ArgsError("int_diffs not supported yet")
    if args.optimizer == "acgd" and (args.num_critic != 1 or args.num_gen != 1):
        raise ArgsError("acgd can't have num critic or num gen > 1")
    if args.n and args.lx:
        raise ArgsError("can't be on nautilus and lxplus both")
    if args.latent_node_size and args.latent_node_size < 3:
        raise ArgsError("latent node size can't be less than 2")
    if args.all_ef and args.deltacoords:
        raise ArgsError("all ef + delta coords not supported yet")
    if args.multi_gpu and args.loss != "ls":
        # the reference only warns here and clears the flag
        import logging

        logging.warning("multi gpu not implemented for non-mse loss")
        args.multi_gpu = False


def from_args_dict(d: dict[str, Any], apply_processing: bool = True) -> Args:
    merged = defaults()
    merged.update(d)
    args = Args(merged)
    if args.model != "gapt" and "gapt_mask" not in d:
        # pre-GAPT model cards lack the flag; the default True would poison
        # mask gating (see _process_masking)
        args.gapt_mask = False
    if apply_processing:
        process_args(args)
    return args


def from_args_txt(path: str, apply_processing: bool = False) -> Args:
    """Parse a reference ``args.txt`` model card (an eval-able dict string,
    setup_training.py:1159-1163 / gen.py:91-94). Cards already contain
    processed values, so processing defaults to off."""
    with open(path) as f:
        d = ast.literal_eval(f.read())
    return from_args_dict(d, apply_processing=apply_processing)


def process_args(args: Args) -> Args:
    """The reference defaulting cascade (setup_training.py:747-1040),
    minus filesystem/cluster concerns."""
    check_args_errors(args)
    if args.save_epochs == 0:
        args.save_epochs = 5 if (args.num_hits <= 30 or args.model == "gapt") else 1
    if args.save_model_epochs == 0:
        args.save_model_epochs = 5 if args.num_hits <= 30 else 1
    if args.low_samples:
        args.eval_tot_samples = 1000
        args.w1_num_samples = [100]
        args.num_samples = 1000
    if args.fpnd and (args.num_hits != 30 or args.jets not in ("g", "t", "q")) and args.dataset != "mnist":
        args.fpnd = False

    _process_optimization(args)
    if args.spectral_norm:
        args.spectral_norm_disc = args.spectral_norm_gen = True
    if args.layer_norm:
        args.layer_norm_disc = args.layer_norm_gen = True
    _process_mpgan(args)
    if args.gapt_mask and args.model == "gapt":
        args.mask = True
    _process_masking(args)
    if args.noise_padding and not args.mask:
        # reference: loud exit after mask resolution (setup_training.py:934-936)
        raise ArgsError("noise padding only works with masking")
    _process_ext_models(args)
    return args


def _process_optimization(args: Args) -> None:
    # batch-size heuristics (setup_training.py:811-846)
    if args.batch_size == 0:
        if args.model == "mpgan" or args.model_D == "mpgan":
            if args.fully_connected:
                args.batch_size = 256 if args.num_hits <= 30 else 32
            else:
                if args.num_hits <= 30 or args.num_knn <= 10:
                    args.batch_size = 320
                elif args.num_knn <= 20:
                    args.batch_size = 160
                elif args.num_knn <= 30:
                    args.batch_size = 100
                else:
                    args.batch_size = 32
        elif args.model == "gapt" or args.model_D == "gapt":
            if args.dataset == "jets":
                args.batch_size = 512
            else:
                if args.gapt_embed_dim < 64:
                    args.batch_size = 128
                elif args.gapt_embed_dim < 128:
                    args.batch_size = 64
                else:
                    args.batch_size = 32
        else:
            args.batch_size = 256

    # per-jet-type default LRs (setup_training.py:848-872)
    if args.lr_disc == 0:
        if args.model == "mpgan":
            args.lr_disc = {"g": 3e-5, "t": 6e-5, "q": 1.5e-5}.get(args.jets, 3e-5)
        elif args.model == "gapt":
            args.lr_disc = 1.5e-4
        args.lr_disc *= args.lr_x
    if args.lr_gen == 0:
        if args.model == "mpgan":
            args.lr_gen = {"g": 1e-5, "t": 2e-5, "q": 0.5e-5}.get(args.jets, 1e-5)
        elif args.model == "gapt":
            args.lr_gen = 0.5e-4
        args.lr_gen *= args.lr_x

    args.augment = bool(args.aug_t or args.aug_f or args.aug_r90 or args.aug_s)


def _process_mpgan(args: Args) -> None:
    if not args.mp_iters_gen:
        args.mp_iters_gen = args.mp_iters
    if not args.mp_iters_disc:
        args.mp_iters_disc = args.mp_iters
    args.clabels_first_layer = args.clabels if args.clabels_fl else 0
    args.clabels_hidden_layers = args.clabels if args.clabels_hl else 0
    if args.latent_node_size == 0:
        args.latent_node_size = args.hidden_node_size


def _process_masking(args: Args) -> None:
    if args.model == "mpgan" and (
        args.mask_feat or args.mask_manual or args.mask_learn
        or args.mask_real_only or args.mask_c or args.mask_learn_sep
    ):
        args.mask = True
    elif args.model == "gapt" and args.gapt_mask:
        args.mask = True
        args.mask_c = True
    else:
        args.mask = False
        args.mask_c = False
    if args.model != "gapt":
        # the reference leaves the default gapt_mask=True set for non-GAPT
        # models, which poisons its label/mask gating expressions
        # (train.py:703, 832) for the ext-model families; clear it
        args.gapt_mask = False
    if args.mask_fnd_np:
        args.dea = True
    if args.mask_feat:
        args.node_feat_size += 1
    if args.mask_learn and args.fmg == [0]:
        args.fmg = []


def _process_ext_models(args: Args) -> None:
    if args.model_D == "":
        args.model_D = {"mpgan": "mpgan", "pcgan": "pcgan", "gapt": "gapt"}.get(
            args.model, "rgan"
        )
    if args.model == "rgan":
        args.optimizer, args.beta1 = "adam", 0.5
        args.lr_disc = args.lr_gen = 1e-4
        if args.model_D == "rgan":
            args.batch_size, args.num_epochs = 50, 2000
        args.loss, args.gp, args.num_critic = "w", 10, 5
        if args.rgand_sfc == 0:
            args.rgand_sfc = [64, 128, 256, 256, 512]
        if args.rgand_fc == 0:
            args.rgand_fc = [128, 64]
    if args.model == "graphcnngan":
        args.optimizer = "rmsprop"
        args.lr_disc = args.lr_gen = 1e-4
        if args.model_D == "rgan":
            args.batch_size, args.num_epochs = 50, 1000
            if args.rgand_sfc == 0:
                args.rgand_sfc = [64, 128, 256, 512]
            if args.rgand_fc == 0:
                args.rgand_fc = [128, 64]
        args.loss, args.gp, args.num_critic = "w", 10, 5
        args.num_knn = 20
    args.pad_hits = 0
    if args.model == "treegan":
        next_pow2 = 2 ** math.ceil(math.log2(args.num_hits))
        args.pad_hits = next_pow2 - args.num_hits
        args.num_hits = next_pow2
        args.optimizer, args.beta1, args.beta2 = "adam", 0.0, 0.99
        args.lr_disc = args.lr_gen = 1e-4
        if args.model_D == "rgan":
            args.batch_size, args.num_epochs = 50, 1000
            if args.rgand_sfc == 0:
                args.rgand_sfc = [64, 128, 256, 512]
            if args.rgand_fc == 0:
                args.rgand_fc = [128, 64]
        args.loss, args.gp, args.num_critic = "w", 10, 5
    if args.model == "pcgan":
        args.optimizer = "adam"
        args.lr_disc = args.lr_gen = 1e-4
        args.batch_size = 256
        args.loss, args.gp, args.num_critic = "w", 10, 5
    if args.model_D == "rgan" and args.model == "mpgan":
        if args.rgand_sfc == 0:
            args.rgand_sfc = [64, 128, 256, 512]
        if args.rgand_fc == 0:
            args.rgand_fc = [128, 64]


# ---------------------------------------------------------------------------
# model-config builders (setup_training.py:1195-1347)
# ---------------------------------------------------------------------------


def _linear_args(args: Args, gen: bool) -> dict[str, Any]:
    return {
        "leaky_relu_alpha": args.leaky_relu_alpha,
        "dropout_p": args.gen_dropout if gen else args.disc_dropout,
        "batch_norm": args.batch_norm_gen if gen else args.batch_norm_disc,
        "spectral_norm": args.spectral_norm_gen if gen else args.spectral_norm_disc,
    }


def _mp_args(args: Args) -> dict[str, Any]:
    return {
        "pos_diffs": args.pos_diffs,
        "all_ef": args.all_ef,
        "coords": args.coords,
        "delta_coords": args.deltacoords,
        "delta_r": args.deltar,
        "clabels": args.clabels,
        "mask_fne_np": args.mask_fne_np,
        "fully_connected": args.fully_connected,
        "num_knn": args.num_knn,
        "self_loops": args.self_loops,
        "sum_agg": args.sum,
    }


def _mask_config(args: Args) -> MaskConfig:
    return MaskConfig(
        mask_learn=args.mask_learn,
        mask_learn_bin=args.mask_learn_bin,
        mask_learn_sep=args.mask_learn_sep,
        mask_c=args.mask_c,
        mask_fne_np=args.mask_fne_np,
        mask_feat_bin=args.mask_feat_bin,
        mask_fnd_np=args.mask_fnd_np,
        fmg=tuple(args.fmg),
    )


def build_mpgan_generator(args: Args) -> MPGeneratorConfig:
    clabels_fl = args.get("clabels_first_layer", args.clabels if args.clabels_fl else 0)
    latent_node_size = args.latent_node_size if args.latent_node_size else args.hidden_node_size
    return MPGeneratorConfig.build(
        num_particles=args.num_hits,
        input_node_size=latent_node_size,
        output_node_size=args.node_feat_size,
        mp_iters=args.mp_iters_gen or args.mp_iters,
        fe_layers=list(args.fe),
        fn_layers=list(args.fn),
        fe1_layers=list(args.fe1g) if args.fe1g else None,
        hidden_node_size=args.hidden_node_size,
        final_activation="tanh" if args.gtanh else "",
        lfc=args.lfc,
        lfc_latent_size=args.lfc_latent_size,
        mask=_mask_config(args) if args.get("mask", True) else MaskConfig(mask_c=False),
        mp_args=_mp_args(args),
        mp_args_first_layer={"clabels": clabels_fl},
        linear_args=_linear_args(args, gen=True),
        use_kernels=args.get("use_pallas"),
    )


def build_mpgan_discriminator(args: Args) -> MPDiscriminatorConfig:
    clabels_fl = args.get("clabels_first_layer", args.clabels if args.clabels_fl else 0)
    use_kernels = args.get("use_pallas")
    if args.get("gp"):
        # the gradient penalty differentiates D's input gradient (a double
        # backward); the kernels' backward is once differentiable, so GP
        # configs pin D to the plain path, as the JAX package does
        use_kernels = False
    return MPDiscriminatorConfig.build(
        num_particles=args.num_hits,
        input_node_size=args.node_feat_size,
        mp_iters=args.mp_iters_disc or args.mp_iters,
        fe_layers=list(args.fe),
        fn_layers=list(args.fn),
        fe1_layers=list(args.fe1d) if args.fe1d else None,
        hidden_node_size=args.hidden_node_size,
        final_activation="" if args.loss in ("w", "hinge") else "sigmoid",
        dea=args.dea,
        dea_sum=args.sum,
        fnd=list(args.fnd),
        mask=_mask_config(args) if args.get("mask", True) else MaskConfig(mask_c=False),
        mask_manual=args.mask_manual,
        mp_args=_mp_args(args),
        mp_args_first_layer={"clabels": clabels_fl, "all_ef": False},
        linear_args=_linear_args(args, gen=False),
        use_kernels=use_kernels,
    )


def build_gapt(args: Args, gen: bool) -> GAPTConfig:
    return GAPTConfig(
        num_particles=args.num_hits,
        feat_size=args.node_feat_size,
        is_generator=gen,
        sab_layers=args.sab_layers_gen if gen else args.sab_layers_disc,
        num_heads=args.num_heads,
        embed_dim=args.gapt_embed_dim,
        sab_fc_layers=tuple(args.sab_fc_layers),
        layer_norm=args.layer_norm_gen if gen else args.layer_norm_disc,
        dropout_p=args.gen_dropout if gen else args.disc_dropout,
        final_fc_layers=tuple(args.final_fc_layers_gen if gen else args.final_fc_layers_disc),
        use_mask=args.gapt_mask,
        use_isab=args.use_isab,
        num_isab_nodes=args.num_isab_nodes,
        linear_args=tuple(_linear_args(args, gen).items()),
    )
