#!/usr/bin/env python
"""Repeat the K5 bf16 card test's case many times and count which comparison diverges.

    python scripts/torch_k5_bf16_repeat.py [--root CHECKOUT] [--reps N] [--label NAME]

For a machine with a CUDA card. It repeats the body of
``tests/test_torch_cuda_kernels.py::test_knn_fused_layer_bf16_matches_plain_twice``
at its case ``[8-150-32-widths0-20-False-False-True-0.0]`` (B=8, N=150, C=32, fe
[96, 160, 192], k=20, mean, no self loops, distances, no dropout) on the test's own
inputs, ``--reps`` times (default 200). Every other repetition first fills freed
blocks of PyTorch's allocator with NaN, so that scratch a kernel reads before it
writes it shows up as a changed result. Each repetition runs K5 twice with ``idx``
and once without, K8 on the first ``idx``, and the plain version, and records
which of these differ: ``idx`` against the plain search, the first output against
the eval launch's, against the second launch's (output, ``idx``, distances),
K8 against K5, the plain search against its first repetition, K5's output against
its first repetition, and the output against the plain version beyond the bf16
tolerance. Prints one JSON line with the counts, and the first repetition of
each kind of divergence with its details; exits 1 if any comparison diverged.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import pathlib
import sys

import torch


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(pathlib.Path(__file__).resolve().parents[1]))
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--label", default="tree")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("torch_k5_bf16_repeat: no CUDA device available")
    root = pathlib.Path(args.root).resolve()
    sys.path.insert(0, str(root))
    spec = importlib.util.spec_from_file_location(
        "card_tests", root / "tests" / "test_torch_cuda_kernels.py")
    t = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(t)
    kk = t.kk

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    b, n, c, widths, k = t.KNN_SHAPES[0]
    sum_agg, self_loops, want_dists, dropout_p = False, False, True, 0.0
    d = t._knn_bf16(t._knn_inputs(dev, b, n, c, widths, k, seed=n + 40))
    args5 = (d["xs"], d["xf"], d["u1"], d["u2m"], d["w_d"], d["hidden"], k, self_loops,
             want_dists, 0.2, sum_agg, dropout_p, 4242)
    checks = ("idx_vs_plain", "out_vs_eval", "out_vs_again", "idx_vs_again", "dists_vs_again",
              "k8_vs_k5", "plain_idx_vs_first", "out_vs_first", "out_beyond_bf16_tol")
    counts = dict.fromkeys(checks, 0)
    first_seen, first = {}, None
    for rep in range(args.reps):
        if rep % 2:
            # freed blocks of both of the allocator's pools filled with NaN
            junk = [torch.full((s,), float("nan"), device=dev) for s in [1 << 15] * 48
                    + [1 << 22] * 4]
            del junk
        out, idx, dists = kk.knn_fused_layer(*args5, True)
        again = kk.knn_fused_layer(*args5, True)
        out_eval = kk.knn_fused_layer(*args5)[0]
        out8 = kk.knn_edge_aggregate(d["u1"], d["u2m"], idx, dists, d["w_d"], d["hidden"], 0.2,
                                     sum_agg, dropout_p, 4242)
        ref, idx_ref, _ = kk.knn_fused_layer_reference(*args5, True)
        torch.cuda.synchronize()
        if first is None:
            first = (out.clone(), idx_ref.clone())
        o, r = out.float(), ref.float()
        beyond = int((((o - r).abs() > t.BF16_TOL["atol"] + t.BF16_TOL["rtol"] * r.abs()))
                     .sum().item())
        diverged = {
            "idx_vs_plain": (idx, idx_ref), "out_vs_eval": (out, out_eval),
            "out_vs_again": (out, again[0]), "idx_vs_again": (idx, again[1]),
            "dists_vs_again": (dists, again[2]), "k8_vs_k5": (out8, out),
            "plain_idx_vs_first": (idx_ref, first[1]), "out_vs_first": (out, first[0]),
        }
        for name, (x, y) in diverged.items():
            if not torch.equal(x, y):
                counts[name] += 1
                if name not in first_seen:
                    ne = x != y
                    rows = ne.reshape(b, n, -1).any(-1).nonzero().tolist()
                    first_seen[name] = {
                        "rep": rep, "poisoned": bool(rep % 2), "elements": int(ne.sum().item()),
                        "max_abs": (x.float() - y.float()).abs().max().item(),
                        "jet_receiver_rows": rows[:12]}
        if beyond:
            counts["out_beyond_bf16_tol"] += 1
            first_seen.setdefault("out_beyond_bf16_tol", {"rep": rep, "elements": beyond})
    print(json.dumps({"label": args.label, "case": "8-150-32-widths0-20-False-False-True-0.0",
                      "reps": args.reps, "poisoned_reps": args.reps // 2,
                      "diverged": counts, "first": first_seen}), flush=True)
    if any(counts.values()):
        raise SystemExit(1)


if __name__ == "__main__":
    main()
