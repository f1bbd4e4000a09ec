#!/usr/bin/env python
"""Read the split-TF32 check's shares: how many of the bf16 backward's gradients
differ from the plain version's, for the kernel and for its controls.

    python scripts/torch_split_tf32_shares.py [--seeds N] [--out FILE]

For a machine with a CUDA card. The bf16 modes of K3 and K6 take the backward's
float32 products as split-TF32 on the tensor cores. For each job of
``chip_smoke.py``'s phases 28 (K3 at B=256 N=30 and B=32 N=150, with weight
gradients and dropout 0.5, without them and without dropout) and 29 (K6 at
B=160 N=150 k=20 and N=13 k=5, the four layer settings, with and without weight
gradients), at LeakyReLU's slope 0.2 and at 1 (no kink), it prints one JSON
object a line: the share of the elements of du1
and du2 ("dx") and of the weight gradients ("dw") that differ from the plain
version's, for the kernel and for the plain version with its products taken as
one TF32 product, with one lo term of the split left out, and as the whole
split (``chip_smoke.split_tf32_shares``). Seed 0 gives the phases' own inputs,
each further seed other draws at the same shapes. ``chip_smoke.py``'s limit,
``SPLIT_MAX_DIFFERING``, sits between the kernel's readings and the held
controls'.
"""

from __future__ import annotations

import argparse
import itertools
import json
import pathlib
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from mpgan_tpu_torch.ops import knn_kernels as kk  # noqa: E402
from mpgan_tpu_torch.ops import mp_kernels as mk  # noqa: E402

# the phases' LeakyReLU slope, and 1, at which chip_smoke.py holds the check
SLOPES = (0.2, 1.0)


def k3_lines(dev, seed):
    for b, n in ((256, 30), (32, 150)):
        u1, u2, mask, hidden, _, _ = cs.kernel_inputs(dev, b, n, 3, seed=28 + n + 1000 * seed)
        g = torch.randn(b, n, 192, generator=torch.Generator(device=dev).manual_seed(
            n + 1000 * seed), device=dev)
        u1, u2, mask, g = cs.to_bf16(u1, u2, mask, g)
        hidden = cs.to_bf16(*hidden)
        for job, a in (("k3", (u1, u2, mask, hidden, g, 0.2, True, 0.5, 2828, True)),
                       ("k3_no_wgrads", (u1, u2, mask, hidden, g, 0.2, False, 0.0, 0, False))):
            for alpha in SLOPES:
                a = (*a[:5], alpha, *a[6:])
                yield dict(kernel="edge_aggregate_bwd", job=job, b=b, n=n, seed=seed,
                           alpha=alpha, shares=cs.split_tf32_shares(
                               mk.edge_aggregate_bwd(*a), mk.edge_aggregate_bwd_reference, a,
                               lambda t, w=a[-1]: {"dx": t[:2], **({"dw": t[3]} if w else {})}))


def k6_lines(dev, seed):
    for b, n, c, widths, k in ((160, 150, 32, cs.FE, 20), (3, 13, 8, [24, 16, 12], 5)):
        d = cs.knn_bf16(cs.knn_inputs(dev, b, n, c, widths, k, seed=290 + n + 1000 * seed))
        for self_loops, sum_agg, dists_on, p in ((True, True, False, 0.0),
                                                 (False, False, True, 0.5),
                                                 (True, False, True, 0.0),
                                                 (False, True, False, 0.5)):
            w_d = d["w_d"] if dists_on else None
            fwd = (d["xs"], d["xf"], d["u1"], d["u2m"], w_d, d["hidden"], k, self_loops,
                   dists_on, 0.2, sum_agg, p, 292929)
            _, idx_ref, dists_ref = kk.knn_fused_layer_reference(*fwd, True)
            for need in (True, False):
                for alpha in SLOPES:
                    bwd = (d["u1"], d["u2m"], idx_ref, dists_ref, w_d, d["hidden"], d["g"],
                           alpha, sum_agg, p, 292929, need)
                    yield dict(kernel="knn_edge_aggregate_bwd", b=b, n=n, k=k, dropout=p,
                               dists=dists_on, sum_agg=sum_agg, wgrads=need, seed=seed,
                               alpha=alpha, shares=cs.split_tf32_shares(
                                   kk.knn_edge_aggregate_bwd(*bwd),
                                   kk.knn_edge_aggregate_bwd_reference, bwd,
                                   lambda t: {"dx": t[:2], **({"dw": t[5]} if need else {})}))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, default=1, help="seed 0 is chip_smoke.py's inputs")
    ap.add_argument("--out", type=pathlib.Path, help="also append every line to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_split_tf32_shares: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    sink = args.out.open("a") if args.out else None
    for seed in range(args.seeds):
        for line in itertools.chain(k3_lines(dev, seed), k6_lines(dev, seed)):
            text = json.dumps(line)
            print(text, flush=True)
            if sink:
                sink.write(text + "\n")
    if sink:
        sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
