"""Dense message passing over particle clouds, eval mode (``mpgan_tpu/ops/mp.py``).

One message-passing iteration (reference ``MPLayer``, mpgan/model.py:91-384)
builds ``A[b, i, j] = [x_i, x_j (, edge features)]``, runs the edge MLP ``fe``,
masks padded senders, aggregates over senders (sum or mean), concatenates the
aggregate with the node features and runs the node MLP ``fn``.

Two paths compute it:

- the plain path materializes the pairwise tensor, as the JAX jnp path does;
- the kernel path decomposes fe's first layer into receiver and sender
  embeddings and hands the N^2 edge chain to the CUDA kernels of
  :mod:`.mp_kernels` (on the CPU their plain versions). It takes the kernel
  that also runs fn (K4) for eval at N <= 64 without BN/SN in fn, clabels or
  ``mask_fne_np``, and the edge-only kernel (K2) followed by fn in torch
  otherwise — the JAX package's default gate (``ops/mp.py:347-355``).

Conditioning labels are broadcast per batch element, fixing the reference's
``Tensor.repeat`` label scramble (mpgan/model.py:249-253) as the JAX package does.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch import nn

from .linear import MLP, MLPConfig, TRAIN_NOT_PORTED, layer_weight_and_bias
from .mp_kernels import edge_aggregate, edge_aggregate_fn

KNN_NOT_PORTED = (
    "the knn (fully_connected=False) message-passing layer comes with the "
    "150-particle knn slice, ROADMAP.md Queue 1 item 9"
)


@dataclasses.dataclass(frozen=True)
class MPLayerConfig:
    """Static config for one message-passing iteration (mpgan/model.py:129-204)."""

    input_node_size: int
    output_node_size: int
    fe: MLPConfig
    fn: MLPConfig
    pos_diffs: bool = False
    all_ef: bool = True
    coords: str = "polarrel"
    delta_coords: bool = False
    delta_r: bool = True
    clabels: int = 0
    mask_fne_np: bool = False
    fully_connected: bool = True
    num_knn: int = 20
    self_loops: bool = True
    sum_agg: bool = True

    @property
    def num_coords(self) -> int:
        return 3 if self.coords == "cartesian" else 2

    @property
    def num_ef(self) -> int:
        n = 0
        if self.pos_diffs:
            if self.delta_coords:
                n += self.num_coords
            if self.delta_r or self.all_ef:
                n += 1
        return n

    @staticmethod
    def build(
        input_node_size: int,
        fe_layers: list[int],
        fn_layers: list[int],
        output_node_size: int,
        linear_args: dict[str, Any] | None = None,
        **mp_args: Any,
    ) -> "MPLayerConfig":
        """fe input is ``2 * node + num_ef + clabels + mask_fne_np``; fn input is
        ``fe_out + node + clabels + mask_fne_np`` with a linear final layer
        (mpgan/model.py:183-204)."""
        linear_args = dict(linear_args or {})
        cfg = MPLayerConfig(
            input_node_size=input_node_size,
            output_node_size=output_node_size,
            fe=MLPConfig(sizes=()),
            fn=MLPConfig(sizes=()),
            **mp_args,
        )
        fe_in = 2 * input_node_size + cfg.num_ef + cfg.clabels + int(cfg.mask_fne_np)
        fe = MLPConfig.build(fe_layers, input_size=fe_in, final_linear=False, **linear_args)
        fn_in = fe_layers[-1] + input_node_size + cfg.clabels + int(cfg.mask_fne_np)
        fn = MLPConfig.build(
            fn_layers, input_size=fn_in, output_size=output_node_size,
            final_linear=True, **linear_args,
        )
        return dataclasses.replace(cfg, fe=fe, fn=fn)


class MPLayer(nn.Module):
    def __init__(self, cfg: MPLayerConfig, generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        self.fe = MLP(cfg.fe, generator)
        self.fn = MLP(cfg.fn, generator)

    def forward(self, x, *, mask=None, labels=None, num_jet_particles=None,
                train: bool = False, use_kernels: bool | None = None):
        return mp_layer_apply(
            self, x, mask=mask, labels=labels, num_jet_particles=num_jet_particles,
            train=train, use_kernels=use_kernels,
        )


def _pairwise_fully_connected(cfg: MPLayerConfig, x: torch.Tensor) -> torch.Tensor:
    """``A[b, i, j] = [x_i, x_j (, dist features)]`` (mpgan/model.py:284-317)."""
    b, n, f = x.shape
    x1 = x[:, :, None, :].expand(b, n, n, f)
    x2 = x[:, None, :, :].expand(b, n, n, f)
    parts = [x1, x2]
    if cfg.pos_diffs:
        diffs = x2 - x1 if cfg.all_ef else x2[..., : cfg.num_coords] - x1[..., : cfg.num_coords]
        # the reference adds 1e-12 to each diff component before the norm (model.py:304)
        dists = torch.linalg.vector_norm(diffs + 1e-12, dim=-1, keepdim=True)
        if cfg.delta_r and cfg.delta_coords:
            parts = [x1, x2, diffs, dists]
        elif cfg.delta_r or cfg.all_ef:
            parts = [x1, x2, dists]
        elif cfg.delta_coords:
            parts = [x1, x2, diffs]
    return torch.cat(parts, dim=-1)


def _append_cond(cfg: MPLayerConfig, t: torch.Tensor, labels, num_jet_particles) -> torch.Tensor:
    """Broadcast conditioning labels / particle counts onto the trailing axis."""
    parts = [t]
    extra_dims = t.dim() - 2
    if cfg.clabels:
        lab = labels[:, : cfg.clabels].to(t.dtype)
        lab = lab.reshape(lab.shape[:1] + (1,) * extra_dims + lab.shape[1:])
        parts.append(lab.expand(*t.shape[:-1], cfg.clabels))
    if cfg.mask_fne_np:
        njp = num_jet_particles.to(t.dtype).reshape((-1,) + (1,) * (t.dim() - 1))
        parts.append(njp.expand(*t.shape[:-1], 1))
    return torch.cat(parts, dim=-1) if len(parts) > 1 else t


def fused_eligible(cfg: MPLayerConfig, train: bool) -> bool:
    """The kernel path covers the dense layer without pairwise-distance edge
    features; fe batch-norm reduces over the whole batch and needs the plain path."""
    if cfg.fe.batch_norm:
        return False
    if cfg.fully_connected:
        return not cfg.pos_diffs
    return True


def _fe_weights_sn(layer: MPLayer) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """fe-layer weights ``(w [out, in], b)`` with spectral norm applied."""
    return [layer_weight_and_bias(lin) for lin in layer.fe.net]


def _decompose_first_layer(cfg: MPLayerConfig, weights, x, labels, num_jet_particles):
    """Split fe layer 1 into receiver/sender embeddings ``(u1, u2)``, each
    ``[B, N, H1]``; W1 columns follow ``[x_recv | x_send | clabels | njp]`` and
    the bias plus every per-jet conditioning term fold into ``u2``."""
    f = cfg.input_node_size
    w1, b1 = weights[0]
    u1 = torch.matmul(x, w1[:, :f].t())
    bias = b1.expand(x.shape[0], b1.shape[0])
    col = 2 * f
    if cfg.clabels:
        bias = bias + labels[:, : cfg.clabels].to(x.dtype) @ w1[:, col : col + cfg.clabels].t()
        col += cfg.clabels
    if cfg.mask_fne_np:
        njp = num_jet_particles.to(x.dtype).reshape(-1, 1)
        bias = bias + njp @ w1[:, col : col + 1].t()
    u2 = torch.matmul(x, w1[:, f : 2 * f].t()) + bias[:, None, :]
    return u1, u2


def _mp_layer_apply_fused(layer: MPLayer, x, mask, labels, num_jet_particles):
    """Kernel path: decomposed fe layer 1, then K4 (fe chain + aggregate + fn) or
    K2 (fe chain + aggregate) followed by fn in torch."""
    cfg = layer.cfg
    weights = _fe_weights_sn(layer)
    u1, u2 = _decompose_first_layer(cfg, weights, x, labels, num_jet_particles)
    hidden_flat = tuple(p for w, b in weights[1:] for p in (w.t().contiguous(), b))
    m = mask if mask is not None else torch.ones(x.shape[:2] + (1,), dtype=x.dtype, device=x.device)
    m = m.contiguous()

    if (
        x.shape[1] <= 64
        and not cfg.fn.batch_norm
        and not cfg.fn.spectral_norm
        and cfg.clabels == 0
        and not cfg.mask_fne_np
    ):
        fe_out = cfg.fe.sizes[-1]
        fn_lin = layer.fn.net
        w1t = fn_lin[0].weight.t()  # [fn_in, out]; rows = [agg | x]
        fn_flat = [w1t[:fe_out].contiguous(), w1t[fe_out:].contiguous(), fn_lin[0].bias]
        for lin in fn_lin[1:]:
            fn_flat.extend([lin.weight.t().contiguous(), lin.bias])
        return edge_aggregate_fn(
            u1.contiguous(), u2.contiguous(), m, hidden_flat, x.contiguous(), tuple(fn_flat),
            cfg.fe.leaky_relu_alpha, cfg.sum_agg, cfg.fn.leaky_relu_alpha, cfg.fn.final_linear,
        )

    agg = edge_aggregate(
        u1.contiguous(), u2.contiguous(), m, hidden_flat, cfg.fe.leaky_relu_alpha, cfg.sum_agg
    )
    h = torch.cat([agg, x], dim=-1)
    h = _append_cond(cfg, h, labels, num_jet_particles)
    return layer.fn(h)


def _check_edge_features(cfg: MPLayerConfig) -> None:
    """The JAX package's two up-front configuration checks (ops/mp.py:575-619)."""
    if not cfg.fully_connected and cfg.pos_diffs and cfg.num_ef != 1:
        raise ValueError(
            f"knn MP layers with pos_diffs carry exactly the [dists] edge "
            f"feature (num_ef == 1); got num_ef={cfg.num_ef} "
            f"(delta_r={cfg.delta_r}, all_ef={cfg.all_ef}, "
            f"delta_coords={cfg.delta_coords})"
        )
    if cfg.fully_connected and cfg.pos_diffs:
        diff_w = cfg.input_node_size if cfg.all_ef else cfg.num_coords
        if cfg.delta_r and cfg.delta_coords:
            built = diff_w + 1
        elif cfg.delta_r or cfg.all_ef:
            built = 1
        elif cfg.delta_coords:
            built = diff_w
        else:
            built = 0
        if built != cfg.num_ef:
            raise ValueError(
                f"inconsistent dense MP edge-feature combination: pairwise "
                f"rows carry {built} edge columns but num_ef declares "
                f"{cfg.num_ef} (all_ef={cfg.all_ef}, delta_r={cfg.delta_r}, "
                f"delta_coords={cfg.delta_coords}, coords={cfg.coords!r}, "
                f"input_node_size={cfg.input_node_size}); the reference "
                f"crashes on these combinations too (mpgan/model.py:309)"
            )


def mp_layer_apply(
    layer: MPLayer,
    x: torch.Tensor,
    *,
    mask: torch.Tensor | None = None,
    labels: torch.Tensor | None = None,
    num_jet_particles: torch.Tensor | None = None,
    train: bool = False,
    use_kernels: bool | None = None,
) -> torch.Tensor:
    """One message-passing iteration: ``[B, N, input_node_size] -> [B, N, output_node_size]``.

    ``use_kernels=None`` takes the kernel path for CUDA tensors and the plain
    path elsewhere; ``True`` on the CPU runs the kernel path through the
    kernels' plain versions.
    """
    cfg = layer.cfg
    _check_edge_features(cfg)
    if not cfg.fully_connected:
        raise NotImplementedError(KNN_NOT_PORTED)
    if train:
        raise NotImplementedError(TRAIN_NOT_PORTED)
    if use_kernels is None:
        use_kernels = x.is_cuda
    if use_kernels and fused_eligible(cfg, train):
        return _mp_layer_apply_fused(layer, x, mask, labels, num_jet_particles)

    a = _pairwise_fully_connected(cfg, x)  # [B, N, N, fe_in]
    a = _append_cond(cfg, a, labels, num_jet_particles)
    a = layer.fe(a)
    if mask is not None:
        a = a * mask[:, None, :, :]  # mask senders (mpgan/model.py:262)
    agg = a.sum(dim=2) if cfg.sum_agg else a.mean(dim=2)
    h = torch.cat([agg, x], dim=-1)
    h = _append_cond(cfg, h, labels, num_jet_particles)
    return layer.fn(h)
