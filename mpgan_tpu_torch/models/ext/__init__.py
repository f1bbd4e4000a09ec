"""External baseline model families (``mpgan_tpu/models/ext``; the reference's
ext_models/): rGAN, PointNet-Mix D, TreeGAN, GraphCNN-GAN and PCGAN.

They are dense layers, a neighbour gather and batch norm in plain PyTorch: the
JAX package's counterparts reach no Pallas kernel. Each module follows the
port's contract ``module(x, labels, train=..., rng=..., update_sn=...)``.
"""

from __future__ import annotations

from typing import Any

from .graphcnn import GraphCNNGANGConfig, GraphCNNGenerator
from .pcgan import LatentDiscriminator, LatentGenerator, PCGANConfig
from .pointnet import PointNetMixDConfig, PointNetMixDiscriminator
from .rgan import RGANDConfig, RGANDiscriminator, RGANGConfig, RGANGenerator
from .treegan import TreeGANGConfig, TreeGANGenerator

__all__ = [
    "build_generator",
    "build_discriminator",
    "pcgan_config",
]


def pcgan_config(args: Any) -> PCGANConfig:
    return PCGANConfig(
        node_feat_size=args.node_feat_size,
        latent_dim=args.pcgan_latent_dim,
        z1_dim=args.pcgan_z1_dim,
        z2_dim=args.pcgan_z2_dim,
        d_dim=args.pcgan_d_dim,
        pool=args.pcgan_pool,
    )


def build_generator(args: Any) -> tuple[Any, type]:
    """``(config, module class)`` of the ext generator ``args.model``
    (``mpgan_tpu/models/ext/__init__.py:40-81``)."""
    if args.model == "rgan":
        return RGANGConfig(
            latent_dim=args.latent_dim,
            fc_layers=tuple(args.rgang_fc),
            num_hits=args.num_hits,
            node_feat_size=args.node_feat_size,
            leaky_relu_alpha=args.leaky_relu_alpha,
        ), RGANGenerator
    if args.model == "graphcnngan":
        return GraphCNNGANGConfig(
            latent_dim=args.latent_dim,
            layers=tuple(args.graphcnng_layers),
            num_hits=args.num_hits,
            node_feat_size=args.node_feat_size,
            num_knn=args.num_knn,
            final_tanh=args.graphcnng_tanh,
            leaky_relu_alpha=args.leaky_relu_alpha,
        ), GraphCNNGenerator
    if args.model == "treegan":
        return TreeGANGConfig(
            features=tuple(args.treegang_features),
            degrees=tuple(args.treegang_degrees),
            support=args.treegang_support,
        ), TreeGANGenerator
    if args.model == "pcgan":
        return pcgan_config(args), LatentGenerator
    raise ValueError(f"unknown ext generator {args.model!r}")


def build_discriminator(args: Any, model_d: str) -> tuple[Any, type]:
    """``(config, module class)`` of the ext discriminator ``model_d``
    (``mpgan_tpu/models/ext/__init__.py:84-111``)."""
    if model_d == "rgan":
        return RGANDConfig(
            sfc_layers=tuple(args.rgand_sfc if args.rgand_sfc else [64, 128, 256, 512]),
            fc_layers=tuple(args.rgand_fc if args.rgand_fc else [128, 64]),
            num_hits=args.num_hits,
            node_feat_size=args.node_feat_size,
            leaky_relu_alpha=args.leaky_relu_alpha,
        ), RGANDiscriminator
    if model_d == "pointnet":
        return PointNetMixDConfig(
            pointfc_layers=tuple(args.pointnetd_pointfc),
            fc_layers=tuple(args.pointnetd_fc),
            num_hits=args.num_hits,
            node_feat_size=args.node_feat_size,
            mask=args.get("mask", False),
            leaky_relu_alpha=args.leaky_relu_alpha,
        ), PointNetMixDiscriminator
    if model_d == "pcgan":
        return pcgan_config(args), LatentDiscriminator
    raise ValueError(f"unknown ext discriminator {model_d!r}")
