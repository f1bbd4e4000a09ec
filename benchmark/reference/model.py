"""MPGAN's generator and discriminator in plain PyTorch, float32.

Written from the model's published description (arXiv:2106.11535, the
reference implementation's ``MPNet``): a message-passing layer builds the edge
rows ``[x_i | x_j]`` over every sender (fully connected) or over the ``k``
nearest ones, runs the edge MLP ``fe`` on them (LeakyReLU after every layer),
sums the messages of the real senders, and runs the node MLP ``fn`` on
``[aggregate | x_i]`` (LeakyReLU after every layer but the last). The
generator ranks its particles by the first noise feature and keeps as many as
the jet's label says (``mask_c``), ends in ``tanh`` and appends ``mask - 0.5``;
the discriminator splits that mask off, sums its last layer's nodes over the
real particles, and ends in one linear layer and a sigmoid. In train mode
every layer's output is dropped out by the hash of :mod:`.rng`, keyed as the
configuration keys it (see :func:`layer`).

The k nearest senders are those of the smallest keys ``bits(d) & ~(2^b - 1) |
j``, ``d`` the squared distance summed term by term in column order and ``b``
the low bits that hold a sender index, so that ties within a truncation bucket
break by index; masked senders are pushed 1e4 times farther out first.

``mm`` is the product every layer uses: :func:`matmul` (float32, TF32 off) or
:func:`matmul_tf32` (both operands rounded to TF32, the control's precision).
"""

from __future__ import annotations

import dataclasses

import torch

from . import rng

MASK_PUSH = 1e4


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(a, b)


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32 (10 mantissa bits, to nearest, ties to even), in float32."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0xFFF + ((bits >> 13) & 1)) & ~0x1FFF
    return bits.view(torch.float32)


class _TF32MatMul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.matmul(round_tf32(a), round_tf32(b))

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = round_tf32(g)
        ga = torch.matmul(g, round_tf32(b).transpose(-1, -2))
        gb = torch.matmul(round_tf32(a).transpose(-1, -2), g)
        # a broadcast operand's gradient sums over the broadcast dimensions
        while gb.dim() > b.dim():
            gb = gb.sum(0)
        return ga, gb


def matmul_tf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _TF32MatMul.apply(a, b)


@dataclasses.dataclass(frozen=True)
class Spec:
    """What the reference reads of a configuration's training arguments."""

    num_particles: int
    fully_connected: bool
    num_knn: int
    latent: int
    hidden: int
    node_feat: int
    fe: tuple
    fn: tuple
    mp_iters_gen: int
    mp_iters_disc: int
    alpha: float
    gen_dropout: float
    disc_dropout: float
    noise_std: float
    lr_gen: float
    lr_disc: float
    batch_size: int

    @staticmethod
    def of(config: dict) -> "Spec":
        a = config["args"]
        unsupported = {"loss": "ls", "optimizer": "rmsprop", "mask_c": True, "dea": True,
                       "sum": True, "fnd": [], "model": "mpgan", "compute_dtype": "float32",
                       "num_critic": 1, "num_gen": 1}
        for k, v in unsupported.items():
            if a.get(k) != v:
                raise ValueError(f"the reference runs {k}={v!r}, the configuration has "
                                 f"{a.get(k)!r}")
        return Spec(
            num_particles=a["num_hits"], fully_connected=a["fully_connected"],
            num_knn=a["num_knn"], latent=a["latent_node_size"], hidden=a["hidden_node_size"],
            node_feat=a["node_feat_size"], fe=tuple(a["fe"]), fn=tuple(a["fn"]),
            mp_iters_gen=a["mp_iters_gen"], mp_iters_disc=a["mp_iters_disc"],
            alpha=a["leaky_relu_alpha"], gen_dropout=a["gen_dropout"],
            disc_dropout=a["disc_dropout"], noise_std=config["noise_std"],
            lr_gen=a["lr_gen"], lr_disc=a["lr_disc"], batch_size=a["batch_size"])


def _leaky(x, alpha):
    return torch.where(x >= 0, x, alpha * x)


def _linear(x, w, b, mm):
    return mm(x, w.t()) + b


def key_bits(n: int) -> int:
    return max(8, (n - 1).bit_length())


def knn_select(xs: torch.Tensor, xf: torch.Tensor, k: int) -> torch.Tensor:
    """The ``k`` nearest senders of each receiver, ``[B, N, k]`` int64 in rank order."""
    n, c = xs.shape[1], xs.shape[2]
    a = -2.0 * xs
    d = a[:, :, None, 0] * xf[:, None, :, 0]
    for col in range(1, c):
        d = d + a[:, :, None, col] * xf[:, None, :, col]
    sq_f = xf[..., 0] * xf[..., 0]
    sq_s = xs[..., 0] * xs[..., 0]
    for col in range(1, c):
        sq_f = sq_f + xf[..., col] * xf[..., col]
        sq_s = sq_s + xs[..., col] * xs[..., col]
    d = d + sq_f[:, None, :]
    d = d + sq_s[:, :, None]
    d = torch.where(d > 0, d, torch.zeros_like(d))
    low = (1 << key_bits(n)) - 1
    keys = (d.contiguous().view(torch.int32) & ~low) | torch.arange(n, dtype=torch.int32,
                                                                     device=xs.device)
    smallest = torch.topk(keys, k, dim=-1, largest=False, sorted=True).values
    return (smallest & low).long()


def knn_keys_margin(xs: torch.Tensor, xf: torch.Tensor, k: int) -> torch.Tensor:
    """Per receiver ``[B, N]`` bool: the k-th and the (k+1)-th smallest keys lie
    within two truncation buckets of each other, so that a rounding of the
    inputs could change which senders are selected."""
    n = xs.shape[1]
    d = ((xf[:, None, :, :] - xs[:, :, None, :]) ** 2).sum(-1)
    bucket = d.contiguous().view(torch.int32) >> key_bits(n)
    two = torch.topk(bucket, k + 1, dim=-1, largest=False, sorted=True).values
    return (two[..., k] - two[..., k - 1]) <= 2


def layer(params: dict, x: torch.Tensor, mask: torch.Tensor, spec: Spec, train: bool,
          p_drop: float, key, mm) -> torch.Tensor:
    """One message-passing layer. ``params``: ``fe`` and ``fn``, lists of
    ``(w [out, in], b)``. With ``train`` and ``p_drop`` the edge chain's
    outputs take the edge hash seeded by :func:`.rng.edge_seed` of ``child(key,
    1)`` (layer ``l`` of the chain: ``l``), and fn's layer ``m`` the node hash
    of ``child(child(key, 1), m)``."""
    b, n, f = x.shape
    drop = train and p_drop > 0
    fn_key = rng.child(key, 1) if drop else None
    if spec.fully_connected:
        pairs = torch.cat([x[:, :, None, :].expand(b, n, n, f),
                           x[:, None, :, :].expand(b, n, n, f)], dim=-1)
        smask = mask[:, None, :, :]
        ids = rng.dense_edge_ids(b, n, x.device) if drop else None
    else:
        push = (1 - MASK_PUSH) * mask + MASK_PUSH
        idx = knn_select(x.detach(), (push * x).detach(), spec.num_knn)
        jets = torch.arange(b, device=x.device)[:, None, None]
        pairs = torch.cat([x[:, :, None, :].expand(b, n, spec.num_knn, f), x[jets, idx]], dim=-1)
        smask = mask[jets, idx]
        ids = rng.knn_edge_ids(b, n, spec.num_knn, x.device) if drop else None
    a = pairs
    seed = rng.edge_seed(fn_key) if drop else 0
    for i, (w, bias) in enumerate(params["fe"]):
        a = _leaky(_linear(a, w, bias, mm), spec.alpha)
        if drop:
            a = a * rng.edge_dropout_multiplier(ids, a.shape[-1], p_drop, seed, i)
    agg = (a * smask).sum(dim=2)
    h = torch.cat([agg, x], dim=-1)
    last = len(params["fn"]) - 1
    for i, (w, bias) in enumerate(params["fn"]):
        h = _linear(h, w, bias, mm)
        if i != last:
            h = _leaky(h, spec.alpha)
        if drop:
            h = rng.node_dropout(h, p_drop, rng.child(fn_key, i))
    return h


def generator(params: dict, noise: torch.Tensor, labels: torch.Tensor, spec: Spec,
              mm=matmul) -> torch.Tensor:
    """G(noise, labels) ``[B, N, node_feat + 1]`` (G has no dropout in these
    configurations, so train and eval agree)."""
    if spec.gen_dropout:
        raise ValueError("the reference's generator runs without dropout")
    n = spec.num_particles
    counts = (labels[:, -1] * n).to(torch.int32) - 1
    order = torch.argsort(noise[:, :, 0], dim=1, stable=True)
    ranks = torch.argsort(order, dim=1, stable=True)
    mask = (ranks <= counts[:, None]).to(noise.dtype)[..., None]
    x = noise
    for p in params["layers"]:
        x = layer(p, x, mask, spec, False, 0.0, None, mm)
    return torch.cat([torch.tanh(x), mask - 0.5], dim=2)


def gen_risky_rows(params: dict, noise: torch.Tensor, labels: torch.Tensor,
                   spec: Spec) -> torch.Tensor:
    """``[B, N]`` bool: output rows whose last knn selection is near a tie (see
    :func:`knn_keys_margin`), all False for a fully connected G. The first
    layer's inputs are the noise itself, the same bits on every side, so only
    the later layers' selections can differ by rounding."""
    b, n = noise.shape[:2]
    risky = torch.zeros(b, n, dtype=torch.bool, device=noise.device)
    if spec.fully_connected:
        return risky
    counts = (labels[:, -1] * n).to(torch.int32) - 1
    order = torch.argsort(noise[:, :, 0], dim=1, stable=True)
    ranks = torch.argsort(order, dim=1, stable=True)
    mask = (ranks <= counts[:, None]).to(noise.dtype)[..., None]
    x = noise
    for i, p in enumerate(params["layers"]):
        if i:
            push = (1 - MASK_PUSH) * mask + MASK_PUSH
            risky |= knn_keys_margin(x, push * x, spec.num_knn)
        x = layer(p, x, mask, spec, False, 0.0, None, matmul)
    return risky


def discriminator(params: dict, x: torch.Tensor, spec: Spec, train: bool, key,
                  mm=matmul) -> torch.Tensor:
    """D(x) ``[B, 1]``; in train mode layer ``l`` keys its dropout from
    ``child(key, l)`` and the last linear layer from ``child(child(key, L), 0)``."""
    mask = x[:, :, -1:] + 0.5
    h = x[:, :, :-1]
    layers = params["layers"]
    for i, p in enumerate(layers):
        h = layer(p, h, mask, spec, train, spec.disc_dropout,
                  rng.child(key, i) if train else None, mm)
    pooled = (h * mask).sum(dim=1)
    w, b = params["out"]
    z = _linear(pooled, w, b, mm)
    if train and spec.disc_dropout:
        z = rng.node_dropout(z, spec.disc_dropout, rng.child(rng.child(key, len(layers)), 0))
    return torch.sigmoid(z)


def params_of(state: dict, model: str) -> dict:
    """The nested parameters of ``state`` (name to tensor, the names MPGAN's
    modules give them: ``mp_layers.{i}.fe.net.{l}.weight`` ..., D's last layer
    ``fnd_layer.net.0``) for :func:`generator` (``model`` "g") or
    :func:`discriminator` ("d")."""
    layers, i = [], 0
    while f"mp_layers.{i}.fe.net.0.weight" in state:
        layer_p = {}
        for part in ("fe", "fn"):
            pairs, l = [], 0
            while f"mp_layers.{i}.{part}.net.{l}.weight" in state:
                pre = f"mp_layers.{i}.{part}.net.{l}"
                pairs.append((state[pre + ".weight"], state[pre + ".bias"]))
                l += 1
            layer_p[part] = pairs
        layers.append(layer_p)
        i += 1
    out = {"layers": layers}
    if model == "d":
        out["out"] = (state["fnd_layer.net.0.weight"], state["fnd_layer.net.0.bias"])
    return out
