"""Coverage and MMD between jet sets (``mpgan_tpu/evaluation/cov_mmd.py``, the
native version of ``jetnet.evaluation.cov_mmd``; protocol flags at
setup_training.py:320-331, 100 samples x 10 batches).

The jet-to-jet distance is the Energy Mover's Distance (arXiv:1902.02346)
with R = 1: optimal transport of pT between the two jets' (eta, phi) points,
the total-pT difference charged at R through a ghost particle. All pairs of a
batch are solved together by Sinkhorn iterations with regularizer 5e-3, in
float64 on the given device: ``exp(-cost / 5e-3)`` is below FP32's smallest
normal number for a cost above about 0.44.

- Coverage: the share of real jets that are the nearest real jet of at least
  one generated jet.
- MMD: the mean over real jets of the distance to the closest generated jet.
"""

from __future__ import annotations

import numpy as np
import torch


def _pairwise_emd(
    gen: np.ndarray,
    real: np.ndarray,
    r: float = 1.0,
    epsilon: float = 5e-3,
    num_iters: int = 200,
    device: torch.device | str = "cuda",
) -> np.ndarray:
    """All-pairs EMD between ``[A, N1, 3]`` and ``[B, N2, 3]`` jets: ``[A, B]``
    float64, by batched Sinkhorn on the ghost-balanced problem."""
    gen_t = torch.as_tensor(np.ascontiguousarray(gen)).to(device)
    real_t = torch.as_tensor(np.ascontiguousarray(real)).to(device)
    a, b = len(gen_t), len(real_t)
    n1, n2 = gen_t.shape[1], real_t.shape[1]
    f64 = torch.float64

    # angular cost [A, B, N1+1, N2+1], in the inputs' dtype as the JAX package
    # computes it, then float64; the last row and column are the ghost at r
    d2 = (gen_t[:, None, :, None, 0] - real_t[None, :, None, :, 0]).square_()
    d2.add_((gen_t[:, None, :, None, 1] - real_t[None, :, None, :, 1]).square_())
    cost = torch.full((a, b, n1 + 1, n2 + 1), r, dtype=f64, device=device)
    # the inputs' dtype's sqrt, correctly rounded through float64 (torch's
    # vectorised float32 sqrt on the CPU is not)
    cost[:, :, :n1, :n2] = d2.to(f64).sqrt_().to(d2.dtype)
    cost[:, :, -1, -1] = 0.0
    del d2

    pt1 = gen_t[:, :, 2].clamp(min=0).to(f64)
    pt2 = real_t[:, :, 2].clamp(min=0).to(f64)
    s1, s2 = pt1.sum(dim=1), pt2.sum(dim=1)
    total = torch.clamp(torch.maximum(s1[:, None], s2[None, :]), min=1e-30)  # [A, B]
    mu = torch.cat([pt1[:, None, :].expand(a, b, n1), (total - s1[:, None])[..., None]], dim=2)
    mu = mu / total[..., None]
    nu = torch.cat([pt2[None, :, :].expand(a, b, n2), (total - s2[None, :])[..., None]], dim=2)
    nu = nu / total[..., None]

    k_mat = torch.exp(cost / -epsilon)
    u = torch.ones_like(mu)
    for _ in range(num_iters):
        v = nu / torch.clamp(torch.einsum("abij,abi->abj", k_mat, u), min=1e-300)
        u = mu / torch.clamp(torch.einsum("abij,abj->abi", k_mat, v), min=1e-300)
    # sum_ij u_i K_ij C_ij v_j, the plan never formed
    k_mat.mul_(cost)
    return (torch.einsum("abij,abj->abi", k_mat, v) * u).sum(-1).mul_(total).cpu().numpy()


def cov_mmd(
    real_jets: np.ndarray,
    gen_jets: np.ndarray,
    num_eval_samples: int = 100,
    num_batches: int = 10,
    seed: int = 42,
    device: torch.device | str = "cuda",
) -> tuple[float, float]:
    """``(coverage, mmd)`` averaged over ``num_batches`` batches of
    ``num_eval_samples`` jets each, drawn as the JAX package draws them."""
    rng = np.random.default_rng(seed)
    covs, mmds = [], []
    for _ in range(num_batches):
        ri = rng.choice(len(real_jets), size=num_eval_samples, replace=False)
        gi = rng.choice(len(gen_jets), size=num_eval_samples, replace=False)
        dists = _pairwise_emd(gen_jets[gi][:, :, :3], real_jets[ri][:, :, :3], device=device)
        covs.append(len(np.unique(dists.argmin(axis=1))) / num_eval_samples)
        mmds.append(dists.min(axis=0).mean())
    return float(np.mean(covs)), float(np.mean(mmds))
