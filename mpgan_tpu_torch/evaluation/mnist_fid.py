"""MNIST point-cloud FID via a MoNet graph classifier (``mpgan_tpu/evaluation/
mnist_fid.py``; mnist/evaluation.py).

Pipeline per cloud (mnist/evaluation.py:31-111): build a radius graph
(cutoff 0.32178 on the [-0.5, 0.5) grid coordinates), run three GMMConv
("MoNet", arXiv:1611.08402) layers with ELU activations and two
graclus-clustering max-pool coarsenings, global-mean-pool, and a final FC to
the 128-d activation space; FID is the Frechet distance between generated
activations and the shipped real-data moments.

Everything runs in numpy on the host, as in the JAX package: the clouds have
at most 100 nodes and the graphs are ragged. The generated clouds come from
the card; their FID is the host's work, and graclus's Python loop makes it
the larger part of an MNIST evaluation (PERF.md). The
shipped reference resources (``C_sm_nh_{75,100}_state_dict.pt`` classifier
weights in the *old* torch-geometric GMMConv layout ``g [in, K*out]``, and
per-digit ``*_mu2/sigma2.txt`` moments) load through ``load_resources``,
which reads tensors only (``torch.load(weights_only=True)``).

graclus note: torch_cluster's graclus matches vertices in arbitrary
(implementation-defined) order, so even reference runs are not bitwise
deterministic; here vertices are visited in index order, matching each with
its maximum-normalized-cut-weight unmatched neighbour.
"""

from __future__ import annotations

import pathlib

import numpy as np

from .fpd import frechet_distance

CUTOFF = 0.32178
FID_EVAL_SIZE = 8192
_EPS = 1e-14


# -- graph construction (mnist/evaluation.py:31-65) --------------------------


def build_graph(cloud: np.ndarray):
    """cloud [N, 3] = (x, y, intensity) -> (x_feats [N,1], pos [N,2],
    edges [E,2] (row=target, col=source convention matches the reference's
    (i, j) index pairs))."""
    coords = cloud[:, :2]
    d = np.linalg.norm(coords[:, None, :] - coords[None, :, :] + 1e-12, axis=2)
    row, col = np.nonzero(d < CUTOFF)
    keep = row != col  # remove self-loops (mnist/evaluation.py:48)
    row, col = row[keep], col[keep]
    x = cloud[:, 2:3] + 0.5
    pos = 28 * coords + 14
    return x, pos, np.stack([row, col], axis=1)


def _edge_attr(pos, edges):
    row, col = edges[:, 0], edges[:, 1]
    return (pos[col] - pos[row]) / (2 * 28 * CUTOFF) + 0.5


# -- GMMConv (old torch-geometric layout) ------------------------------------


def gmm_conv(x, edges, pseudo, g, mu, sigma, root, bias):
    """out_i = mean_{j in N(i)} sum_k w_k(e_ij) (x_j g_k) + x_i root + bias,
    w_k(e) = exp(-0.5 sum_d (e_d - mu_kd)^2 / sigma_kd^2)."""
    n, in_f = x.shape
    k, dim = mu.shape
    out_f = g.shape[1] // k
    row, col = edges[:, 0], edges[:, 1]

    gauss = np.exp(
        -0.5 * np.sum((pseudo[:, None, :] - mu[None]) ** 2 / (sigma[None] ** 2 + _EPS), axis=2)
    )  # [E, K]
    xj = (x[col] @ g).reshape(-1, k, out_f)  # [E, K, out]
    msg = np.einsum("ek,eko->eo", gauss, xj)

    out = np.zeros((n, out_f))
    np.add.at(out, row, msg)
    deg = np.bincount(row, minlength=n)[:, None]
    out = out / np.maximum(deg, 1)
    return out + x @ root + bias


# -- graclus coarsening + max pool (mnist/evaluation.py:68-99) ---------------


def normalized_cut_weights(edges, pos, n):
    row, col = edges[:, 0], edges[:, 1]
    dist = np.linalg.norm(pos[row] - pos[col], axis=1)
    deg = np.bincount(row, minlength=n).astype(np.float64)
    inv_deg = np.where(deg > 0, 1.0 / np.maximum(deg, 1), 0.0)
    return dist * (inv_deg[row] + inv_deg[col])


def graclus(edges, weights, n):
    """Greedy heavy-edge matching: cluster assignment [N]."""
    cluster = -np.ones(n, dtype=np.int64)
    order = np.arange(n)
    # neighbour lists sorted by descending weight
    nbrs: list[list[tuple[float, int]]] = [[] for _ in range(n)]
    for (r, c), w in zip(edges, weights):
        nbrs[r].append((w, c))
    next_id = 0
    for v in order:
        if cluster[v] >= 0:
            continue
        best, best_w = -1, -np.inf
        for w, u in nbrs[v]:
            if cluster[u] < 0 and u != v and w > best_w:
                best, best_w = u, w
        cluster[v] = next_id
        if best >= 0:
            cluster[best] = next_id
        next_id += 1
    return cluster


def max_pool(cluster, x, pos, edges):
    """Coarsen: features max, positions mean, edges relabelled + dedup."""
    num_clusters = cluster.max() + 1
    new_x = np.full((num_clusters, x.shape[1]), -np.inf)
    np.maximum.at(new_x, cluster, x)
    new_pos = np.zeros((num_clusters, 2))
    counts = np.bincount(cluster, minlength=num_clusters)[:, None]
    np.add.at(new_pos, cluster, pos)
    new_pos = new_pos / np.maximum(counts, 1)
    if len(edges):
        e = cluster[edges]
        e = e[e[:, 0] != e[:, 1]]
        e = np.unique(e, axis=0) if len(e) else e
    else:
        e = edges
    return new_x, new_pos, e


# -- MoNet forward (mnist/evaluation.py:74-107) ------------------------------


def _elu(x):
    return np.where(x > 0, x, np.expm1(x))


def monet_activations(params: dict, cloud: np.ndarray) -> np.ndarray:
    """128-d activation vector for one cloud."""
    x, pos, edges = build_graph(cloud)
    for li, name in enumerate(("conv1", "conv2", "conv3")):
        p = params[name]
        pseudo = _edge_attr(pos, edges) if len(edges) else np.zeros((0, 2))
        x = _elu(gmm_conv(x, edges, pseudo, p["g"], p["mu"], p["sigma"], p["root"], p["bias"]))
        if li < 2:
            w = normalized_cut_weights(edges, pos, len(x))
            cluster = graclus(edges, w, len(x))
            x, pos, edges = max_pool(cluster, x, pos, edges)
    pooled = x.mean(axis=0)
    return pooled @ params["fc1"]["w"].T + params["fc1"]["b"]


# -- resources + FID ---------------------------------------------------------


def load_resources(resources_path: str, num_hits: int, num: int):
    """Load the shipped classifier weights + per-digit real moments
    (mnist/evaluation.py:147-175)."""
    from ..utils.weights import load_reference_state_dict

    res = pathlib.Path(resources_path)
    sd = {k: v.numpy() for k, v in
          load_reference_state_dict(str(res / f"C_sm_nh_{num_hits}_state_dict.pt")).items()}
    params = {}
    for conv in ("conv1", "conv2", "conv3"):
        params[conv] = {
            "g": sd[f"{conv}.g"],
            "mu": sd[f"{conv}.mu"],
            "sigma": sd[f"{conv}.sigma"],
            "root": sd[f"{conv}.root"],
            "bias": sd[f"{conv}.bias"],
        }
    params["fc1"] = {"w": sd["fc1.weight"], "b": sd["fc1.bias"]}

    numstr = str(num) if num != -1 else "all_nums"
    stem = f"{numstr}_sm_2_nh_{num_hits}_"
    mu2 = np.loadtxt(res / f"{stem}mu2.txt")
    sigma2 = np.loadtxt(res / f"{stem}sigma2.txt")
    return params, mu2, sigma2


def get_fid(
    clouds: np.ndarray,
    num_hits: int,
    num: int,
    resources_path: str,
    eval_size: int = FID_EVAL_SIZE,
) -> float:
    """FID of generated clouds vs the shipped real-data moments
    (mnist/evaluation.py:232-259)."""
    params, mu2, sigma2 = load_resources(resources_path, num_hits, num)
    acts = np.stack(
        [monet_activations(params, np.asarray(c, np.float64)) for c in clouds[:eval_size]]
    )
    mu1 = acts.mean(axis=0)
    sigma1 = np.cov(acts, rowvar=False)
    return frechet_distance(mu1, sigma1, mu2, sigma2)
