#!/usr/bin/env python
"""Time the port's knn forward kernels (K5, K8, K7) and the knn-20 generation they carry.

    python scripts/torch_knn_bench.py [--root CHECKOUT] [--label NAME] [--phases] [--reps N]
                                      [--plain] [--bf16]

For a machine with a CUDA card. It times, at the main paths' shapes and the
published widths (fe [96, 160, 192], N=150, k=20, C=32):

- K5 eval at B=512 (knn-20 generation), with dropout 0.5 writing ``idx`` at
  B=160 (D and G in a step of the train CLI) and eval without ``idx`` at B=160
  (the D step's fake batch);
- K8 eval at B=512 and with dropout 0.5 at B=160, from K5's ``idx``;
- K7 at B=512 (generation on route 3) and at B=160, with and without the
  distances (the train CLI's batch);
- the knn-20 generator forward at B=512 in jets/s, on route 4 (K5) and route 3
  (``MPGAN_TPU_KNN_KERNEL=3``: K7 then K8),

on inputs drawn as ``chip_smoke.py`` draws them and with its timer (CUDA
events, one call a timing, best of ``--reps`` after a warm-up). Each kernel is
first held against its plain version (K5: neighbours under the near-tie rule of
``compare_neighbours``, the outputs of the agreeing rows within rtol = atol =
1e-4; K8 bit for bit against K5 on K5's ``idx``; K7's ``idx`` equal to K5's) and
launched twice for equal bits. One JSON object a line, with the bound (FLOPs
over 67 TFLOP/s or bytes over 3.35 TB/s) and the share of the bound's rate.

``--bf16`` times the bf16 modes of K5 and K8 instead, at the same shapes
(K5 eval at B=512, with dropout 0.5 writing ``idx`` and eval at B=160; K8 at
B=512 eval and B=160 with dropout 0.5, from K5's ``idx``), on the inputs
rounded to bf16: K5's neighbours under the near-tie rule, its agreeing rows
within ``chip_smoke.BF16_TOL`` (rtol = atol), K8 bit for bit against K5; no K7
or generation rows (K7's bf16 entry is timed by ``chip_smoke.py`` phase 29;
generation runs in float32).

``--root`` names the checkout whose ``chip_smoke.py`` and ``mpgan_tpu_torch``
are used (default: the one that holds this script), and ``--label`` goes into
every line, so that two checkouts run in turns on one card can be told apart.
``--plain`` adds each kernel's plain version's time (best of 3).

With ``--phases`` the kernels are built with ``-DMPGAN_PHASE_CLOCKS`` (a build of
its own) and K5's and K8's rows are followed by the share of their clocks that
each phase took (K5's search included), summed over the CTAs' first threads;
K5's and K7's rows also split the search's clocks into staging, keys, selection
and outputs (``search_split``). The stamps cost time: read the shares from such
a run and the milliseconds from a run without the flag.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

import torch

TOL = 1e-4
N, C, K = 150, 32, 20
CLOCKS = {"knn_fused_layer": "mpgan_knn_fused_layer_phase_clocks",
          "knn_edge_aggregate": "mpgan_knn_edge_aggregate_phase_clocks",
          "knn_search": "mpgan_knn_search_phase_clocks"}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(pathlib.Path(__file__).resolve().parents[1]))
    ap.add_argument("--label", default="tree")
    ap.add_argument("--phases", action="store_true")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--plain", action="store_true")
    ap.add_argument("--bf16", action="store_true", help="time the bf16 modes of K5 and K8")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("torch_knn_bench: no CUDA device available")
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
    from torch_fwd_bench import phase_shares

    sys.path.insert(0, str(pathlib.Path(args.root).resolve()))
    import chip_smoke as cs
    from mpgan_tpu_torch.models.registry import build_suite
    from mpgan_tpu_torch.ops import _build
    from mpgan_tpu_torch.ops import knn_kernels as kk
    from mpgan_tpu_torch.training.config import from_args_dict

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = cs.card_line()
    _build.library(defines=("MPGAN_PHASE_CLOCKS",)) if args.phases else _build.library()
    lines = _build.build_info.get("log", "").splitlines()
    regs = [" ".join(x.strip() for x in lines[i + 1:i + 3]) for i, line in enumerate(lines)
            if "Function properties" in line and "knn" in line and "bwd" not in line]
    print(json.dumps({"label": args.label, "card": card, "phases": args.phases,
                      "bf16": args.bf16, "build_s": _build.build_info.get("seconds"),
                      "ptxas": regs}), flush=True)
    tol = cs.BF16_TOL if args.bf16 else TOL
    mode = "_bf16" if args.bf16 else ""
    clock_fns = {k: "mpgan_knn_fused_layer_bf16_phase_clocks" for k in CLOCKS} \
        if args.bf16 else CLOCKS

    def report(kernel, shape, call, check, bound, plain):
        """Check (``check`` returns whether the kernel agrees, and a note), two
        launches bit for bit, then the time."""
        res, again = call(), call()
        torch.cuda.synchronize()
        ok, note = check(res)
        same = all(torch.equal(a, b) for a, b in zip(res, again) if a is not None)
        del res, again
        clocks = clock_fns.get(kernel) if args.phases else None
        if clocks:
            phase_shares(_build, clocks)  # drop the clocks of the launches above
        ms = cs.best_ms(call, reps=args.reps, inner=1)
        row = {"label": args.label, "kernel": kernel + mode, "shape": shape, "ms": ms,
               "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"],
               "share_of_bound_rate": bound["bound_ms"] / ms, "agrees": ok, **note,
               "two_runs_bit_identical": same}
        if clocks:
            row["phase_shares"] = phase_shares(_build, clocks)
        if args.plain:
            row["plain_ms"] = cs.best_ms(plain, reps=3, inner=1)
            torch.cuda.empty_cache()
        print(json.dumps(row), flush=True)
        if not ok or not same:
            raise SystemExit(f"torch_knn_bench: {kernel} at {shape}: {note}, bit-identical {same}")

    def k5_check(d, fwd, emit):
        def check(res):
            ref, idx_ref, _ = kk.knn_fused_layer_reference(*fwd, True)
            idx = res[1] if emit else kk.knn_fused_layer(*fwd, True)[1]
            agree, differing, far = kk.compare_neighbours(idx, idx_ref,
                                                          kk.knn_keys(d["xs"].float(),
                                                                      d["xf"].float()),
                                                          d["mask"])
            out, ref = res[0].float(), ref.float()
            err = ((out - ref).abs() / (tol + tol * ref.abs()))[agree].max().item()
            ok = err <= 1 and far == 0 and differing <= 0.01 * agree.numel()
            return ok, {"err_over_tol": err, "rows_differing": differing}
        return check

    rows = lambda b: 2 * b * N * K * cs.macs(cs.FE)  # noqa: E731  the chain's FLOPs
    search_flops = lambda b: 2 * b * N * N * (C + 1)  # noqa: E731
    idx_of = {}
    for b, p, emit, tag in ((512, 0.0, False, "eval"), (160, 0.5, True, "p=0.5, idx written"),
                            (160, 0.0, False, "eval")):
        d = cs.knn_inputs(dev, b, N, C, cs.FE, K, seed=b)
        if args.bf16:
            d = cs.knn_bf16(d)
        fwd = (d["xs"], d["xf"], d["u1"], d["u2m"], None, d["hidden"], K, True, False, 0.2, True,
               p, 5)
        out, idx, _ = kk.knn_fused_layer(*fwd, True)
        idx_of[(b, p)] = (d, idx, out)
        moved = cs.nbytes(d["xs"], d["xf"], d["u1"], d["u2m"], *d["hidden"], out,
                          idx if emit else None)
        report("knn_fused_layer", f"B={b} N=150 k=20 {tag}",
               lambda: kk.knn_fused_layer(*fwd, emit), k5_check(d, fwd, emit),
               cs.bf16_knn_bound(b, N, C, K, "k5", moved) if args.bf16
               else cs.bound(rows(b) + search_flops(b), moved),
               lambda: kk.knn_fused_layer_reference(*fwd, emit))
        torch.cuda.empty_cache()
    for b, p, tag in ((512, 0.0, "eval"), (160, 0.5, "p=0.5")):
        d, idx, out5 = idx_of[(b, p)]
        agg = (d["u1"], d["u2m"], idx, None, None, d["hidden"], 0.2, True, p, 5)

        moved8 = cs.nbytes(d["u1"], d["u2m"], idx, *d["hidden"], out5)

        def check(res, out5=out5):
            return torch.equal(res[0], out5), {"bit_identical_to_k5": torch.equal(res[0], out5)}
        report("knn_edge_aggregate", f"B={b} N=150 k=20 {tag}",
               lambda: (kk.knn_edge_aggregate(*agg),), check,
               (cs.bf16_knn_bound(b, N, C, K, "k8", moved8) if args.bf16
                else cs.bound(rows(b), moved8)),
               lambda: kk.knn_edge_aggregate_reference(*agg))
    if args.bf16:
        return
    for b, want in ((512, False), (160, False), (160, True)):
        d, idx5, _ = idx_of[(b, 0.0)]

        def search_check(res, d=d, idx5=idx5, want=want):
            same = torch.equal(res[0], idx5)
            note = {"idx_equal_to_k5": same}
            if want:
                _, dref = kk.knn_search_reference(d["xs"], d["xf"], K, True, True)
                live = torch.gather(d["mask"][:, None, :, 0].expand(-1, N, -1), 2,
                                    res[0].long()) > 0
                err = ((res[1] - dref).abs() / (TOL + TOL * dref.abs()))[live].max().item()
                note["dists_err_over_tol"] = err
                same = same and err <= 1
            return same, note
        moved = cs.nbytes(d["xs"], d["xf"], idx5) + (4 * idx5.numel() if want else 0)
        report("knn_search", f"B={b} N=150 C=32 k=20" + (" with distances" if want else ""),
               lambda d=d, want=want: kk.knn_search(d["xs"], d["xf"], K, True, want),
               search_check, cs.bound(search_flops(b), moved),
               lambda d=d, want=want: kk.knn_search_reference(d["xs"], d["xf"], K, True, want))
    del idx_of, d, idx5
    torch.cuda.empty_cache()

    # knn-20 generation at the sampler's batch, route 4 and route 3 in turns
    g = build_suite(from_args_dict(cs.KNN150)).generator(cs.prng_key(3, "cpu"),
                                                         device=dev)
    noise = torch.randn(512, N, 32, generator=torch.Generator(device=dev).manual_seed(2),
                        device=dev) * 0.2
    lab = torch.full((512, 1), 0.7, device=dev)

    def gen_on(route):
        def f():
            cs.set_knn_route(route)
            with torch.inference_mode():
                g(noise, lab)
        return f

    ms = {"4": float("inf"), "3": float("inf")}
    try:
        for route in ("4", "3", "3", "4"):
            ms[route] = min(ms[route], cs.best_ms(gen_on(route), reps=args.reps, inner=1))
    finally:
        cs.set_knn_route()
    for route in ("4", "3"):
        print(json.dumps({"label": args.label, "generation": "150p knn-20", "route": route,
                          "batch": 512, "ms": ms[route], "jets_per_s": 512 / ms[route] * 1e3}),
              flush=True)


if __name__ == "__main__":
    main()
