#!/usr/bin/env python
"""Time the port's backward kernels (K3 dense, K6 knn) alone at the main paths' shapes.

    python scripts/torch_bwd_bench.py [--root CHECKOUT] [--label NAME] [--phases] [--reps N]
                                      [--bf16]

For a machine with a CUDA card. It times K3 at B=256 N=30 and B=32 N=150 and K6
at B=160 N=150 k=20 (published widths, dropout 0.5), each with and without
weight gradients, on the inputs and with the timer of ``chip_smoke.py`` (CUDA
events, one launch a timing, best of ``--reps`` after a warm-up; K6's ``idx`` is
what the forward kernel selects). Each kernel is first held against its plain
version and launched twice for equal bits. One JSON object a line.

``--bf16`` times the bf16 modes instead, on the same inputs rounded to bf16,
each output held as a whole to its plain version (``chip_smoke.bf16_whole``:
relative L2 3e-2, 0.1 of the largest; the card tests' rule), the largest
error over max(1, max|ref|) reported beside it.

``--root`` names the checkout whose ``chip_smoke.py`` and ``mpgan_tpu_torch``
are used (default: the one that holds this script), and ``--label`` goes into
every line, so that two checkouts run in turns on one card can be told apart.

With ``--phases`` the kernels are built with ``-DMPGAN_PHASE_CLOCKS`` (a build of
its own) and every shape is followed by the share of a pass's clocks that each
phase took, summed over the CTAs' first threads. The stamps cost time: read the
shares from such a run and the milliseconds from a run without the flag.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import sys

import torch

TOL = 1e-4
PHASES = ("rows_a0", "fwd_hidden", "fwd_last", "wgrad", "da", "rebuild_a0", "tail",
          "in_products_wait", "in_products_loop", "in_products_epilogue", "search")
CLOCK_SLOTS = 25  # edge_products.cuh: kPhaseCount; slots 11-14 split the knn search, 15-24
# the bf16 forward's warp tiles


def flat(res):
    out = []
    for t in res:
        if isinstance(t, (tuple, list)):
            out += list(t)
        elif t is not None:
            out.append(t)
    return out


def worst(res, ref):
    """Largest error over the outputs, each relative to max(1, max|ref|)."""
    return max(((o - r).abs().max() / r.abs().max().clamp_min(1.0)).item()
               for o, r in zip(flat(res), flat(ref)) if o.numel())


def phase_shares(build, fn_name):
    """The share of a pass's clocks per phase since the last call; None where
    the checkout's library has no such reader (an older tree's bf16 sources)."""
    fn = getattr(build.library(), fn_name, None)
    if fn is None:
        return None
    fn.argtypes = [ctypes.POINTER(ctypes.c_ulonglong), ctypes.c_int]
    fn.restype = ctypes.c_int
    buf = (ctypes.c_ulonglong * CLOCK_SLOTS)()  # edge_products.cuh: kPhaseCount
    torch.cuda.synchronize()
    build.check(fn(buf, 1), fn_name)
    total = max(sum(buf[:7]) + buf[10], 1)  # 7-9 split the products' time again
    return {name: round(v / total, 4) for name, v in zip(PHASES, buf)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(pathlib.Path(__file__).resolve().parents[1]))
    ap.add_argument("--label", default="tree")
    ap.add_argument("--phases", action="store_true")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--bf16", action="store_true", help="time the bf16 modes of K3 and K6")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("torch_bwd_bench: no CUDA device available")
    sys.path.insert(0, str(pathlib.Path(args.root).resolve()))
    import chip_smoke as cs
    from mpgan_tpu_torch.ops import _build
    from mpgan_tpu_torch.ops import knn_kernels as kk
    from mpgan_tpu_torch.ops import mp_kernels as mk

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = cs.card_line()
    _build.library(defines=("MPGAN_PHASE_CLOCKS",)) if args.phases else _build.library()
    lines = _build.build_info.get("log", "").splitlines()
    regs = [" ".join(x.strip() for x in lines[i + 1:i + 3]) for i, line in enumerate(lines)
            if "Function properties" in line and "bwd_kernel" in line]
    print(json.dumps({"label": args.label, "card": card, "phases": args.phases,
                      "bf16": args.bf16, "build_s": _build.build_info.get("seconds"),
                      "ptxas": regs}), flush=True)
    mode = "_bf16" if args.bf16 else ""

    def report(kernel, shape, call, reference, need):
        res, again, ref = call(), call(), reference()
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(flat(res), flat(again)))
        err = worst(res, ref)
        if args.bf16:
            ok = all(cs.bf16_whole(o, r)[2] for o, r in zip(flat(res), flat(ref)))
        else:
            ok = err <= 100 * TOL  # the strict bounds are chip_smoke.py's: a broken build
        del res, again, ref
        clocks_fn = f"mpgan_{kernel}{mode}_phase_clocks"
        if args.phases:
            phase_shares(_build, clocks_fn)  # drop the clocks of the launches above
        row = {"label": args.label, "kernel": kernel + mode, "shape": shape, "wgrads": need,
               "ms": cs.best_ms(call, reps=args.reps, inner=1), "worst_err_over_bound": err,
               "within_tol": err <= (cs.BF16_TOL if args.bf16 else TOL),
               "within_rule": ok, "two_runs_bit_identical": same}
        if args.phases:
            row["phase_shares"] = phase_shares(_build, clocks_fn)
        print(json.dumps(row), flush=True)
        if not ok or not same:
            raise SystemExit(f"torch_bwd_bench: {kernel}{mode} at {shape} wgrads={need}: "
                             f"error {err}, bit-identical {same}")

    cast = cs.to_bf16 if args.bf16 else (lambda *ts: ts)
    for b, n in ((256, 30), (32, 150)):
        u1, u2, mask, hidden, _, _ = cs.kernel_inputs(dev, b, n, 3, seed=b)
        g = torch.randn(b, n, cs.FE[-1], device=dev,
                        generator=torch.Generator(device=dev).manual_seed(n))
        u1, u2, mask, g = cast(u1, u2, mask, g)
        hidden = cast(*hidden)
        for need in (True, False):
            a = (u1, u2, mask, hidden, g, 0.2, True, 0.5, 5, need)
            report("edge_aggregate_bwd", f"B={b} N={n} p=0.5",
                   lambda: mk.edge_aggregate_bwd(*a),
                   lambda: mk.edge_aggregate_bwd_reference(*a), need)
        del u1, u2, mask, hidden, g
        torch.cuda.empty_cache()
    d = cs.knn_inputs(dev, 160, 150, 32, cs.FE, 20, seed=9)
    if args.bf16:
        d = cs.knn_bf16(d)
    idx = kk.knn_fused_layer(d["xs"], d["xf"], d["u1"], d["u2m"], None, d["hidden"], 20, True,
                             False, 0.2, True, 0.5, 5, True)[1]
    for need in (True, False):
        a = (d["u1"], d["u2m"], idx, None, None, d["hidden"], d["g"], 0.2, True, 0.5, 5, need)
        report("knn_edge_aggregate_bwd", "B=160 N=150 k=20 p=0.5",
               lambda: kk.knn_edge_aggregate_bwd(*a),
               lambda: kk.knn_edge_aggregate_bwd_reference(*a), need)


if __name__ == "__main__":
    main()
