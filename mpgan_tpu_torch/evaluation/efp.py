"""Energy Flow Polynomials (``mpgan_tpu/evaluation/efp.py``; the jetnet
library's ``efps`` / ``w1efp`` / ``fpd`` configuration, train.py:583-593,
744-757).

EFPs (Komiske-Metodiev-Thaler, arXiv:1712.07124) index jets by connected
multigraphs: for a multigraph G with edges E,

    EFP_G = sum_{i_1..i_V} prod_v z_{i_v} prod_{(a,b) in E} theta_{i_a i_b}

with ``z_i = pT_i / sum pT`` (normed) and ``theta_ij = (d_eta^2 +
d_phi^2)^(beta/2)``, beta = 1. The basis (the multigraphs, the composites,
the selections) is a copy of the JAX package's.

Each graph is evaluated by a plan of pairwise contractions built once
(:func:`contraction_plan`): vertex weights first go into an incident edge
factor, an index is summed out as soon as no other factor holds it, and each
step takes the pair whose result has the fewest indices. With at most 4 edges
no intermediate is larger than ``[chunk, N, N]``, and every ``torch.einsum``
call has two operands, so the cost does not depend on ``opt_einsum`` (without
it ``torch.einsum`` contracts many operands left to right, through
``[chunk, N, N, N]`` intermediates).
"""

from __future__ import annotations

from functools import lru_cache
from itertools import combinations_with_replacement, permutations

import numpy as np
import torch

Edge = tuple[int, int]
Graph = tuple[Edge, ...]
# a plan step: (left factor, right factor, einsum spec); operands are popped
# and the result appended to the factor list
Step = tuple[int, int, str]

# B * N^2 above which the FP32 device path runs (the JAX package's rule, with a
# CUDA device in the TPU's place); below it, the reference's float64 on the CPU
DEVICE_THRESHOLD = {"cuda": 2e6, "cpu": 4e7}


def _canonical(edges: Graph) -> Graph:
    verts = sorted({v for e in edges for v in e})
    relabel = {v: i for i, v in enumerate(verts)}
    edges = [(relabel[a], relabel[b]) for a, b in edges]
    n = len(verts)
    best = None
    for perm in permutations(range(n)):
        mapped = tuple(sorted(tuple(sorted((perm[a], perm[b]))) for a, b in edges))
        if best is None or mapped < best:
            best = mapped
    return best


def _connected(edges: Graph) -> bool:
    verts = {v for e in edges for v in e}
    adj: dict[int, set[int]] = {v: set() for v in verts}
    for a, b in edges:
        adj[a].add(b)
        adj[b].add(a)
    seen = {next(iter(verts))}
    stack = list(seen)
    while stack:
        for nb in adj[stack.pop()]:
            if nb not in seen:
                seen.add(nb)
                stack.append(nb)
    return seen == verts


@lru_cache(maxsize=None)
def efp_multigraphs(max_d: int = 4) -> tuple[Graph, ...]:
    """All connected multigraphs (no self-loops) with 1..max_d edges, i.e.
    the prime EFPs of degree <= max_d, in (degree, canonical) order."""
    graphs: list[Graph] = []
    for d in range(1, max_d + 1):
        pairs = [(a, b) for a in range(d + 1) for b in range(a + 1, d + 1)]
        seen: set[Graph] = set()
        for combo in combinations_with_replacement(pairs, d):
            if not _connected(combo):
                continue
            canon = _canonical(combo)
            if canon not in seen:
                seen.add(canon)
        graphs.extend(sorted(seen))
    return tuple(graphs)


@lru_cache(maxsize=None)
def efp_composites(max_d: int = 4) -> tuple[tuple[int, ...], ...]:
    """Composite EFPs with total degree <= max_d: multisets (sorted index
    tuples into ``efp_multigraphs(max_d)``) of >= 2 primes, valued as the
    product of their primes. 15 at max_d=4: primes + composites = 35, the
    energyflow ``("d<=", 4)`` basis without its constant."""
    primes = efp_multigraphs(max_d)
    out: list[tuple[int, ...]] = []

    def rec(start: int, remaining: int, current: list[int]) -> None:
        if len(current) >= 2:
            out.append(tuple(current))
        for i in range(start, len(primes)):
            d = len(primes[i])
            if d <= remaining:
                rec(i, remaining - d, current + [i])

    rec(0, max_d, [])
    return tuple(sorted(out, key=lambda c: (sum(len(primes[i]) for i in c), c)))


def _select_graphs(select: str) -> tuple[Graph, ...]:
    """``"d<=4"``: the 20 prime EFPs of degree <= 4 (``"d<=4-all"`` adds the
    15 composites in :func:`efps`). ``"n4d4"``: the 5 with 4 vertices and 4
    edges (jetnet's w1efp set). Columns are in (degree, canonical) order; the
    metrics built on them do not depend on a consistent column order."""
    if select in ("d<=4", "d<=4-all"):
        return efp_multigraphs(4)
    if select == "n4d4":
        return tuple(
            g
            for g in efp_multigraphs(4)
            if len(g) == 4 and len({v for e in g for v in e}) == 4
        )
    raise ValueError(f"unknown EFP selection {select!r}")


def _einsum_spec(graph: Graph) -> str:
    letters = "abcdefghij"
    verts = sorted({v for e in graph for v in e})
    ops = ["z" + letters[a] + letters[b] for a, b in graph]
    ops += ["z" + letters[v] for v in verts]
    return ",".join(ops) + "->z"


@lru_cache(maxsize=None)
def contraction_plan(graph: Graph) -> tuple[Step, ...]:
    """The pairwise contractions that evaluate ``graph``. Factors start as the
    edges (theta) then the vertex weights (z), as in :func:`_einsum_spec`;
    each step's result keeps only the indices another factor still holds."""
    letters = "abcdefghij"
    factors = [frozenset(e) for e in graph]
    verts = sorted({v for e in graph for v in e})
    factors += [frozenset((v,)) for v in verts]

    def spec(i: int, j: int) -> tuple[str, frozenset]:
        others = set().union(*(f for k, f in enumerate(factors) if k not in (i, j)))
        out = (factors[i] | factors[j]) & others
        term = lambda f: "z" + "".join(letters[v] for v in sorted(f))  # noqa: E731
        return f"{term(factors[i])},{term(factors[j])}->{term(out)}", frozenset(out)

    def apply(i: int, j: int) -> Step:
        s, out = spec(i, j)
        for k in sorted((i, j), reverse=True):
            factors.pop(k)
        factors.append(out)
        return (i, j, s)

    steps: list[Step] = []
    # each vertex weight into its first incident edge factor
    for v in verts:
        w = factors.index(frozenset((v,)))
        e = next(k for k, f in enumerate(factors) if v in f and k != w)
        steps.append(apply(e, w))
    while len(factors) > 1:
        pairs = [(i, j) for i in range(len(factors)) for j in range(i + 1, len(factors))]
        i, j = min(pairs, key=lambda p: (len(spec(*p)[1]), len(factors[p[0]] | factors[p[1]])))
        steps.append(apply(i, j))
    return tuple(steps)


def _run_plan(plan: tuple[Step, ...], theta: torch.Tensor, z: torch.Tensor,
              n_edges: int, n_verts: int) -> torch.Tensor:
    factors = [theta] * n_edges + [z] * n_verts
    for i, j, spec in plan:
        a, b = factors[i], factors[j]
        for k in sorted((i, j), reverse=True):
            factors.pop(k)
        factors.append(torch.einsum(spec, a, b))
    return factors[0]


def _chunk_efps(chunk: torch.Tensor, graphs: tuple[Graph, ...], beta: float,
                normed: bool) -> torch.Tensor:
    eta, phi, pt = chunk[..., 0], chunk[..., 1], chunk[..., 2]
    z = pt / torch.clamp(pt.sum(dim=1, keepdim=True), min=1e-30) if normed else pt
    theta = (eta[:, :, None] - eta[:, None, :]).square_()
    theta.add_((phi[:, :, None] - phi[:, None, :]).square_()).pow_(beta / 2.0)
    outs = [_run_plan(contraction_plan(g), theta, z, len(g), len({v for e in g for v in e}))
            for g in graphs]
    return torch.stack(outs, dim=1)


def efps(
    jets: np.ndarray,
    select: str = "d<=4",
    beta: float = 1.0,
    normed: bool = True,
    batch_size: int = 4096,
    device: torch.device | str = "cuda",
    use_device: bool | None = None,
) -> np.ndarray:
    """EFPs of ``jets [B, N, >=3]`` ([eta_rel, phi_rel, pt_rel], zero-padded):
    ``[B, num_efps]`` float64.

    The FP32 path runs on ``device`` when ``use_device`` is true, or when it is
    None and ``B * N^2`` exceeds ``DEVICE_THRESHOLD`` of the device's type (the
    JAX package's size rule); otherwise the float64 path runs on the CPU."""
    graphs = _select_graphs(select)
    device = torch.device(device)
    if use_device is None:
        use_device = jets.shape[0] * jets.shape[1] ** 2 > DEVICE_THRESHOLD[device.type]
    if not use_device:
        device = torch.device("cpu")
    dtype = torch.float32 if use_device else torch.float64
    jets = np.asarray(jets)
    chunks = []
    # a ragged last chunk runs at its own size: the JAX package padded it to
    # spare XLA a recompile, which eager torch does not pay
    with torch.inference_mode():
        for i in range(0, jets.shape[0], batch_size):
            chunk = torch.as_tensor(jets[i : i + batch_size, :, :3]).to(device, dtype)
            chunks.append(_chunk_efps(chunk, graphs, beta, normed))
        vals = torch.cat(chunks).cpu().numpy().astype(np.float64)
    if select == "d<=4-all":
        comps = [np.prod(vals[:, list(c)], axis=1) for c in efp_composites(4)]
        vals = np.concatenate([vals, np.stack(comps, axis=1)], axis=1)
    return vals
