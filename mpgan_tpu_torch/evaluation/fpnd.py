"""FPND, the Frechet ParticleNet Distance (``mpgan_tpu/evaluation/fpnd.py``;
the reference's ``jetnet.evaluation.fpnd``, train.py:595-601).

FPND compares generated jets with real jets in the activation space of a
ParticleNet classifier (arXiv:1902.08570). The trunk here is plain PyTorch:

- an input batch norm from running statistics;
- three EdgeConv blocks: the k = 16 nearest neighbours (in (eta, phi) for the
  first block, in the learned features for the others), an edge MLP on
  ``[x_i, x_j - x_i]`` of widths (64, 64, 64) / (128, 128, 128) /
  (256, 256, 256), each layer a 1x1 product, batch norm and ReLU, the mean
  over the neighbours, and a 1x1 shortcut with batch norm;
- masked global average pooling to a 256-d activation vector.

Padded particles are pushed 1e3 away, where they tie exactly with each other;
the search sorts stably (``torch.argsort(stable=True)``, as ``jnp.argsort``),
so a jet with fewer than 17 particles takes its padded neighbours in index
order in both packages. The gather is by index (the JAX package's one-hot
gather is a TPU device).

:func:`fpnd` computes the activations on ``device`` (the card by default) and
the moments and the Frechet distance on the host. The published weights are
jetnet's ``pnet_state_dict.pt`` (``utils.weights.load_particlenet``); without
them the trunk is random, drawn on the evaluating device from the threefry key
``PRNGKey(42)`` as the JAX package draws its random trunk, so the two
packages give the same random-trunk FPND; it is not comparable to published
FPND values.
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch

from ..ops import init, prng
from .fpd import frechet_distance

_BN_EPS = 1e-5
# the published trunk (the JAX package's ParticleNetConfig defaults)
INPUT_DIMS = 3
K = 16
CONV_WIDTHS = ((64, 64, 64), (128, 128, 128), (256, 256, 256))
RANDOM_TRUNK_SEED = 42  # the random trunk's key is PRNGKey(RANDOM_TRUNK_SEED)

Params = dict[str, Any]  # the JAX package's tree, with tensors for leaves


def _bn_params(width: int, prefix: str = "", device: torch.device | str = "cpu"
               ) -> dict[str, torch.Tensor]:
    one, zero = torch.ones(width, device=device), torch.zeros(width, device=device)
    return {prefix + "scale": one, prefix + "bias": zero, prefix + "mean": zero.clone(),
            prefix + "var": one.clone()}


def particlenet_init(key: torch.Tensor | None = None,
                     device: torch.device | str = "cpu") -> Params:
    """A random trunk on ``device``, drawn from the threefry ``key``
    (``PRNGKey(RANDOM_TRUNK_SEED)`` when None) as the JAX package's
    ``particlenet_init`` draws it: weight ``wi`` of block ``bi`` is
    ``normal(fold_in(key, 10 bi + wi), (w, cin)) * (1 / sqrt(cin))``, the
    shortcut's from ``fold_in(key, 10 bi + 9)``; batch norms the identity."""
    k = init.root(prng.PRNGKey(RANDOM_TRUNK_SEED) if key is None else key, device)

    def weight(child: int, out: int, cin: int) -> torch.Tensor:
        return init.normal(k.fold_in(child), (out, cin), 1.0 / math.sqrt(cin))

    params: Params = {"input_bn": _bn_params(INPUT_DIMS, device=device), "edge_convs": []}
    in_feat = INPUT_DIMS
    for bi, widths in enumerate(CONV_WIDTHS):
        convs, cin = [], 2 * in_feat
        for wi, w in enumerate(widths):
            convs.append({"w": weight(10 * bi + wi, w, cin), **_bn_params(w, "bn_", device)})
            cin = w
        shortcut = {"w": weight(10 * bi + 9, widths[-1], in_feat),
                    **_bn_params(widths[-1], "bn_", device)}
        params["edge_convs"].append({"convs": convs, "shortcut": shortcut})
        in_feat = widths[-1]
    return params


def params_to(params: Params, device: torch.device | str) -> Params:
    """The trunk's tensors moved to ``device`` (float32)."""
    if isinstance(params, dict):
        return {k: params_to(v, device) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [params_to(v, device) for v in params]
    if not isinstance(params, torch.Tensor):
        params = np.array(params, np.float32)  # a writable copy of a read-only array
    return torch.as_tensor(params, dtype=torch.float32, device=device)


def _bn(x: torch.Tensor, p: dict, prefix: str = "") -> torch.Tensor:
    return (x - p[prefix + "mean"]) * torch.rsqrt(p[prefix + "var"] + _BN_EPS) \
        * p[prefix + "scale"] + p[prefix + "bias"]


def knn_indices(points: torch.Tensor, k: int) -> torch.Tensor:
    """``[B, N, k]`` nearest neighbours (not itself) of each point: squared
    distances, the self distance +1e9, a stable sort (ties by index)."""
    d = ((points[:, :, None, :] - points[:, None, :, :]) ** 2).sum(-1)
    n = points.shape[1]
    d = d + torch.eye(n, dtype=d.dtype, device=d.device) * 1e9
    return torch.argsort(d, dim=2, stable=True)[:, :, :k]


def particlenet_activations(params: Params, jets: torch.Tensor) -> torch.Tensor:
    """``jets [B, N, 3]`` (``[eta_rel, phi_rel, pt_rel]``, zero-padded) ->
    activations ``[B, CONV_WIDTHS[-1][-1]]``, on the jets' device."""
    mask = (jets.abs().sum(-1, keepdim=True) > 0).to(jets.dtype)
    coords = jets[..., :2]
    fts = _bn(jets, params["input_bn"])
    batch = torch.arange(jets.shape[0], device=jets.device)[:, None, None]
    for bi, block in enumerate(params["edge_convs"]):
        space = (coords if bi == 0 else fts) + (1 - mask) * 1e3  # padded: never neighbours
        nbr = fts[batch, knn_indices(space, K)]  # [B, N, k, F]
        ctr = fts[:, :, None, :].expand_as(nbr)
        h = torch.cat([ctr, nbr - ctr], dim=-1)
        for conv in block["convs"]:
            h = torch.relu(_bn(h @ conv["w"].T, conv, "bn_"))
        sc = _bn(fts @ block["shortcut"]["w"].T, block["shortcut"], "bn_")
        fts = torch.relu(h.mean(dim=2) + sc) * mask
    return fts.sum(dim=1) / mask.sum(dim=1).clamp_min(1.0)


def activations(params: Params, jets: np.ndarray, batch_size: int = 256,
                device: torch.device | str = "cuda") -> np.ndarray:
    """The trunk's activations of ``jets [n, N, >=3]`` in batches on ``device``,
    returned on the host (float32)."""
    device = torch.device(device)
    p = params_to(params, device)
    jets = np.asarray(jets[..., :3], np.float32)
    out = []
    with torch.inference_mode():
        for i in range(0, len(jets), batch_size):
            out.append(particlenet_activations(
                p, torch.as_tensor(jets[i:i + batch_size], device=device)))
        return torch.cat(out).cpu().numpy()


def fpnd(real_jets: np.ndarray, gen_jets: np.ndarray, params: Params | None = None,
         batch_size: int = 256, num_samples: int = 50000,
         device: torch.device | str = "cuda") -> float:
    """The Frechet distance between real and generated activations (protocol:
    50,000 jets each, train.py:549-555); activations on ``device``, moments and
    distance on the host."""
    if params is None:
        params = particlenet_init(device=device)
    a_real = activations(params, real_jets[:num_samples], batch_size, device)
    a_gen = activations(params, gen_jets[:num_samples], batch_size, device)
    return frechet_from_activations(a_real, a_gen)


def frechet_from_activations(a_real: np.ndarray, a_gen: np.ndarray) -> float:
    """The Frechet distance between two activation sets' Gaussian moments."""
    mu1, s1 = a_real.mean(axis=0), np.cov(a_real, rowvar=False)
    mu2, s2 = a_gen.mean(axis=0), np.cov(a_gen, rowvar=False)
    return frechet_distance(mu1, s1, mu2, s2)


def make_fpnd_fn(params: Params | None = None, device: torch.device | str = "cuda"):
    """The trainer's hook ``fpnd_fn(gen_jets, jet_type, real_jets)`` on
    ``device``: the trunk ``params`` (``utils.weights.load_particlenet`` of a
    jetnet ``pnet_state_dict.pt``), else the random trunk of ``PRNGKey(42)``."""
    params = params_to(params if params is not None else particlenet_init(device=device),
                       device)

    def _fn(gen_jets, jet_type, real_jets=None):
        if real_jets is None:
            raise ValueError("fpnd needs real jets for the reference moments")
        return fpnd(real_jets, gen_jets, params, device=device)

    return _fn
