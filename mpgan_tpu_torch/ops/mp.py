"""Message passing over particle clouds, dense and k-nearest-neighbour
(``mpgan_tpu/ops/mp.py``).

One message-passing iteration (reference ``MPLayer``, mpgan/model.py:91-384)
builds ``A[b, i, j] = [x_i, x_j (, edge features)]`` over every sender ``j``
(``fully_connected``) or over the ``num_knn`` nearest ones, runs the edge MLP
``fe``, masks padded senders, aggregates over senders (sum or mean),
concatenates the aggregate with the node features and runs the node MLP ``fn``.

Two paths compute it:

- the plain path materializes the pairwise tensor, as the JAX jnp path does;
  for knn it searches with a full distance matrix and a stable sort and
  gathers the neighbours' rows;
- the kernel path decomposes fe's first layer into receiver and sender
  embeddings and hands the edge chain to hand-written CUDA kernels (on the CPU
  their plain versions). Dense (:mod:`.mp_kernels`): the kernel that also runs
  fn (K4) for eval at N <= 64 without BN/SN in fn, clabels or ``mask_fne_np``,
  and the edge-only kernel (K2, backward K3) followed by fn in torch otherwise,
  train mode always — the JAX package's default gate (``ops/mp.py:347-355``).
  knn (:mod:`.knn_kernels`): one kernel searches, gathers, runs the chain and
  aggregates (K5, backward K6), then fn in torch — the JAX package's fully
  fused kernel generation (``ops/mp.py:453-477``) and the default. Its older
  split generations (``ops/mp.py:479-545``) are the split route here: a search
  kernel (K7) and an aggregate kernel fed with ``idx`` (K8, backward K6),
  chosen as in the JAX package by ``MPGAN_TPU_KNN_KERNEL`` (``4``, the
  default, or ``3``, ``2``, ``1``: on this card the three older generations are
  one kernel pair) and ``MPGAN_TPU_KNN_SELECT=0`` (the plain torch search
  feeds K8). Both variables are read at call time.

Train-mode dropout keys follow the JAX key paths (see :mod:`.keys`): the plain
path splits ``rng`` into fe and fn keys, each MLP into one key per layer; the
kernel path takes the second of two splits, draws the in-kernel seed from it
and hands it to fn. The two paths therefore draw different masks, as in the
JAX package.

The plain knn search and the kernel's differ as in the JAX package: the plain
one ranks exact distances ``|x_far_j - x_i + 1e-12|`` (and differentiates
through them under ``pos_diffs``), the kernel ranks truncated squared distances
with ties broken by index, so the two may pick different neighbours at
near-ties.

Conditioning labels are broadcast per batch element, fixing the reference's
``Tensor.repeat`` label scramble (mpgan/model.py:249-253) as the JAX package does.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any

import torch
from torch import nn

from . import init
from .knn_kernels import knn_aggregate, knn_aggregate_split
from .linear import MLP, MLPConfig, layer_weight_and_bias
from .mp_kernels import EdgeAggregate, EdgeAggregateFn

_MASK_PUSH = 1e4  # masked particles move this far out, so no search selects them


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
    def __init__(self, cfg: MPLayerConfig, key=None):
        """``mp_layer_init``'s draws: ``fe_key, fn_key = split(key)``."""
        super().__init__()
        self.cfg = cfg
        fe_key, fn_key = init.root(key).split(2)
        self.fe = MLP(cfg.fe, fe_key)
        self.fn = MLP(cfg.fn, fn_key)

    def forward(self, x, *, mask=None, labels=None, num_jet_particles=None,
                train: bool = False, rng=None, update_sn: bool = True,
                use_kernels: bool | None = None):
        return mp_layer_apply(
            self, x, mask=mask, labels=labels, num_jet_particles=num_jet_particles,
            train=train, rng=rng, update_sn=update_sn, use_kernels=use_kernels,
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


def _push_masked(x: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
    """The reference's ``mul = 1e4`` trick (mpgan/model.py:332-334)."""
    return x if mask is None else ((1 - _MASK_PUSH) * mask + _MASK_PUSH) * x


def _select_columns(cfg: MPLayerConfig, x: torch.Tensor) -> torch.Tensor:
    """The features the knn search measures distances on."""
    return x if (cfg.all_ef or not cfg.pos_diffs) else x[..., : cfg.num_coords]


def _check_knn_fits(cfg: MPLayerConfig, n: int) -> None:
    extra = 0 if cfg.self_loops else 1
    if cfg.num_knn + extra > n:
        raise ValueError(
            f"knn MP layer: num_knn={cfg.num_knn} (+{extra} dropped self) exceeds the {n} "
            "available senders"
        )


def _knn_search(cfg: MPLayerConfig, x: torch.Tensor, mask: torch.Tensor | None):
    """Neighbour indices ``[B, N, k]`` and distances ``[B, N, k, 1]``
    (mpgan/model.py:339-359): the ``k`` smallest ``|x_far_j - x_i + 1e-12|``,
    the first dropped without self loops. A stable sort stands where the JAX
    package has ``approx_max_k`` at recall 1: equal distances (masked particles
    pushed onto one point) come out in index order, as they do there, and the
    rank decides which dropout mask an edge draws."""
    x1 = _select_columns(cfg, x)[:, :, None, :]
    x2 = _select_columns(cfg, _push_masked(x, mask))[:, None, :, :]
    dists = torch.linalg.vector_norm(x2 - x1 + 1e-12, dim=-1)  # [B, N, N]
    start = 0 if cfg.self_loops else 1
    top, order = torch.sort(dists, dim=-1, stable=True)
    keep = slice(start, start + cfg.num_knn)
    return order[:, :, keep], top[:, :, keep, None]


def _pairwise_knn(cfg: MPLayerConfig, x: torch.Tensor, mask: torch.Tensor | None):
    """``A[b, i, s] = [x_i, x_nbr(i, s) (, dist)]`` ``[B, N, k, fe_in]`` and the
    neighbours' masks ``[B, N, k, 1]`` (None without ``mask``), mpgan/model.py:319-381.
    The neighbours' rows are an indexed read (the JAX package's one-hot matmul
    is a TPU device)."""
    b, n, f = x.shape
    idx, knn_dists = _knn_search(cfg, x, mask)
    # an indexed read, whose gradient (an accumulating index_put_) sums in a fixed order
    jets = torch.arange(b, device=x.device)[:, None, None]
    x2 = x[jets, idx]
    a_mask = None if mask is None else mask[jets, idx]
    parts = [x[:, :, None, :].expand(b, n, cfg.num_knn, f), x2]
    if cfg.pos_diffs:
        parts.append(knn_dists)
    return torch.cat(parts, dim=-1), a_mask


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
    features and every knn layer; fe batch-norm reduces over the whole batch and
    needs the plain path."""
    if cfg.fe.batch_norm:
        return False
    if cfg.fully_connected:
        return not cfg.pos_diffs
    return True


def _fe_weights_sn(layer: MPLayer, update_sn: bool) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """fe-layer weights ``(w [out, in], b)`` with spectral norm applied (and advanced)."""
    return [layer_weight_and_bias(lin, update_sn) for lin in layer.fe.net]


def _decompose_first_layer(cfg: MPLayerConfig, weights, x, labels, num_jet_particles,
                           extract_wd: bool = False):
    """Split fe layer 1 into receiver/sender embeddings ``(u1, u2)``, each
    ``[B, N, H1]``, and the dists weight column ``w_d [H1]`` (None unless
    ``extract_wd``); W1 columns follow ``[x_recv | x_send | dists? | clabels |
    njp]`` and the bias plus every per-jet conditioning term fold into ``u2``."""
    f = cfg.input_node_size
    w1, b1 = weights[0]
    u1 = torch.matmul(x, w1[:, :f].t())
    bias = b1.expand(x.shape[0], b1.shape[0])
    col = 2 * f
    w_d = None
    if extract_wd:
        w_d = w1[:, col]
        col += 1
    if cfg.clabels:
        bias = bias + labels[:, : cfg.clabels].to(x.dtype) @ w1[:, col : col + cfg.clabels].t()
        col += cfg.clabels
    if cfg.mask_fne_np:
        njp = num_jet_particles.to(x.dtype).reshape(-1, 1)
        bias = bias + njp @ w1[:, col : col + 1].t()
    u2 = torch.matmul(x, w1[:, f : 2 * f].t()) + bias[:, None, :]
    return u1, u2, w_d


def _mp_layer_apply_fused(layer: MPLayer, x, mask, labels, num_jet_particles, train, rng,
                          update_sn):
    """Kernel path: decomposed fe layer 1, then K4 (fe chain + aggregate + fn) or
    K2 (fe chain + aggregate, K3 backward) followed by fn in torch."""
    cfg = layer.cfg
    weights = _fe_weights_sn(layer, update_sn)
    u1, u2, _ = _decompose_first_layer(cfg, weights, x, labels, num_jet_particles)
    hidden_flat = tuple(p for w, b in weights[1:] for p in (w.t().contiguous(), b))
    m = mask if mask is not None else torch.ones(x.shape[:2] + (1,), dtype=x.dtype, device=x.device)
    m = m.contiguous()

    if (
        not train
        and x.shape[1] <= 64
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
        return EdgeAggregateFn.apply(
            u1.contiguous(), u2.contiguous(), m, x.contiguous(), cfg.fe.leaky_relu_alpha,
            cfg.sum_agg, cfg.fn.leaky_relu_alpha, cfg.fn.final_linear, len(hidden_flat),
            *hidden_flat, *fn_flat,
        )

    dropout_p, seed = _edge_dropout(cfg, train, rng)
    agg = EdgeAggregate.apply(
        u1.contiguous(), u2.contiguous(), m, cfg.fe.leaky_relu_alpha, cfg.sum_agg, dropout_p,
        seed, *hidden_flat,
    )
    h = torch.cat([agg, x], dim=-1)
    h = _append_cond(cfg, h, labels, num_jet_particles)
    return layer.fn(h, train=train, rng=rng, update_sn=update_sn)


def _edge_dropout(cfg: MPLayerConfig, train: bool, rng) -> tuple[float, Any]:
    """The in-kernel dropout rate and seed of a kernel-path layer: an int, or a
    key slot's one-element int32 tensor (see :mod:`.keys`)."""
    dropout_p = cfg.fe.dropout_p if train else 0.0
    if dropout_p <= 0:
        return 0.0, 0
    if rng is None:
        raise ValueError("fe dropout in train mode needs an rng")
    return dropout_p, rng.edge_seed()


def knn_route() -> tuple[str, bool]:
    """The knn kernel generation and whether a kernel searches, from
    ``MPGAN_TPU_KNN_KERNEL`` (default ``4``) and ``MPGAN_TPU_KNN_SELECT``
    (``0``: the plain torch search), as ``mpgan_tpu/ops/mp.py:439-442`` reads
    them: without the search kernel the fused generation gives way to ``3``."""
    version = os.environ.get("MPGAN_TPU_KNN_KERNEL", "4")
    if version not in ("4", "3", "2", "1"):
        raise ValueError(f"MPGAN_TPU_KNN_KERNEL={version!r}: expected 4, 3, 2 or 1")
    select_kernel = os.environ.get("MPGAN_TPU_KNN_SELECT", "1") != "0"
    if not select_kernel and version == "4":
        version = "3"
    return version, select_kernel


def _mp_layer_apply_fused_knn(layer: MPLayer, x, mask, labels, num_jet_particles, train, rng,
                              update_sn):
    """Kernel path of the knn layer: decomposed fe layer 1, then K5 (search +
    gather + fe chain + aggregate over the neighbours, K6 backward) or, on the
    split route, K7 (search) and K8 (the rest, K6 backward), followed by fn in
    torch. The JAX package's generation ``1`` runs fe's first layer inside its
    kernel on raw pair rows; here it is the same decomposition in torch, and
    autograd carries its gradient to ``x``. bf16 ``x`` and weights (under
    ``train_step.bf16_apply``) make bf16 ``xs``, ``xf``, ``u1``, ``u2m`` and
    ``w_d``, as the JAX layer makes them, and select the kernels' bf16 modes."""
    cfg = layer.cfg
    version, select_kernel = knn_route()
    weights = _fe_weights_sn(layer, update_sn)
    dropout_p, seed = _edge_dropout(cfg, train, rng)
    m = mask if mask is not None else torch.ones(x.shape[:2] + (1,), dtype=x.dtype, device=x.device)
    u1, u2, w_d = _decompose_first_layer(cfg, weights, x, labels, num_jet_particles,
                                         extract_wd=cfg.pos_diffs)
    u2m = torch.cat([u2, m.to(x.dtype)], dim=-1)
    hidden_flat = tuple(p for w, b in weights[1:] for p in (w.t().contiguous(), b))
    search = {}
    if not select_kernel:
        # K8 reads float32 distances; in bf16 the JAX kernel widens them itself
        idx, knn_dists = _knn_search(cfg, x, mask)
        search = {"idx": idx.to(torch.int32).contiguous(),
                  "dists": knn_dists[..., 0].float().contiguous() if cfg.pos_diffs else None}
    aggregate = knn_aggregate if version == "4" else knn_aggregate_split
    agg = aggregate(
        _select_columns(cfg, x).contiguous(),
        _select_columns(cfg, _push_masked(x, mask)).contiguous(),
        u1.contiguous(), u2m, None if w_d is None else w_d.contiguous(), hidden_flat,
        cfg.num_knn, cfg.self_loops, cfg.pos_diffs, cfg.fe.leaky_relu_alpha, cfg.sum_agg,
        dropout_p, seed, **search,
    )
    h = torch.cat([agg, x], dim=-1)
    h = _append_cond(cfg, h, labels, num_jet_particles)
    return layer.fn(h, train=train, rng=rng, update_sn=update_sn)


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
    rng=None,
    update_sn: bool = True,
    use_kernels: bool | None = None,
) -> torch.Tensor:
    """One message-passing iteration: ``[B, N, input_node_size] -> [B, N, output_node_size]``.

    ``use_kernels=None`` takes the kernel path for CUDA tensors and the plain
    path elsewhere; ``True`` on the CPU runs the kernel path through the
    kernels' plain versions. ``rng`` (see :mod:`.keys`) feeds train-mode dropout.
    """
    cfg = layer.cfg
    _check_edge_features(cfg)
    if not cfg.fully_connected:
        _check_knn_fits(cfg, x.shape[1])
    if use_kernels is None:
        use_kernels = x.is_cuda
    if use_kernels and fused_eligible(cfg, train):
        fn_rng = rng.split(2)[1] if rng is not None else None
        fused = _mp_layer_apply_fused if cfg.fully_connected else _mp_layer_apply_fused_knn
        return fused(layer, x, mask, labels, num_jet_particles, train, fn_rng, update_sn)
    fe_rng = fn_rng = None
    if rng is not None:
        fe_rng, fn_rng = rng.split(2)

    if cfg.fully_connected:
        a = _pairwise_fully_connected(cfg, x)  # [B, N, N, fe_in]
        a_mask = None if mask is None else mask[:, None, :, :]  # senders (mpgan/model.py:262)
    else:
        a, a_mask = _pairwise_knn(cfg, x, mask)  # [B, N, k, fe_in]
    a = _append_cond(cfg, a, labels, num_jet_particles)
    a = layer.fe(a, train=train, rng=fe_rng, update_sn=update_sn)
    if a_mask is not None:
        a = a * a_mask
    agg = a.sum(dim=2) if cfg.sum_agg else a.mean(dim=2)
    h = torch.cat([agg, x], dim=-1)
    h = _append_cond(cfg, h, labels, num_jet_particles)
    return layer.fn(h, train=train, rng=fn_rng, update_sn=update_sn)
