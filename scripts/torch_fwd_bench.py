#!/usr/bin/env python
"""Time the port's dense forward kernels (K2, K4) and the generation they carry.

    python scripts/torch_fwd_bench.py [--root CHECKOUT] [--label NAME] [--phases] [--reps N]
                                      [--plain] [--bf16]

For a machine with a CUDA card. It times, at the main paths' shapes and
published widths (fe [96, 160, 192], fn [256, 256]):

- K2 eval at B=512 N=150 (150p dense generation) and on the ``--fe 128 256``
  chain at the same shape; K2 with dropout 0.5 at B=256 N=30 (the flagship D in
  training);
- K4 at B=4096 N=30 (30p generation) and at B=256 N=30 (G in the flagship D+G
  step);
- K9, the fused GAPT generator, at B=1024 and B=4096 N=30 masked (GAPT
  generation) and at N=150 B=512, with ``--phases`` its share of clocks per
  phase (projections, attention split into scores with softmax and the
  weighted sum by the warps' own clocks, the weight waits inside the
  projections, the tail);
- the generator forward of 30p (B=4096) and 150p dense (B=512) jets, and of
  GAPT jets (B=1024, B=4096), in jets/s,

on inputs drawn as ``chip_smoke.py`` draws them and with its timer (CUDA
events, one call a timing, best of ``--reps`` after a warm-up). Each kernel is
first held against its plain version (on the first 16 jets where the plain
version of the whole batch would take gigabytes; K9 on the timed launch's own
output over the whole batch) and launched twice for equal bits. One JSON object a line.

``--root`` names the checkout whose ``chip_smoke.py`` and ``mpgan_tpu_torch``
are used (default: the one that holds this script), and ``--label`` goes into
every line, so that two checkouts run in turns on one card can be told apart.

``--bf16`` times the bf16 modes of K2, K4 and K9 instead (the bf16 training
steps' shapes: K2 with dropout 0.5 and eval at B=256 N=30, the flagship, and at
B=32 N=150, 150p dense; K4 at B=256 N=30, its fn output 3 as the flagship G's
last MP layer; K9, the bf16 GAPT step's D-step generator, at B=1024 and B=4096
N=30 masked), on the same inputs rounded to bf16, each held to its plain version
within ``chip_smoke.BF16_TOL`` (rtol = atol) on the whole batch; no generation
rows (generation runs in float32). With ``--phases`` K4's rows split its warps'
clocks into K2's phases and its fn's (the grid-wide barrier and the weights'
copies, the first layer's FMA chains, the mma.sync layers).

With ``--plain`` every kernel row also gives its plain version's time on the
whole batch (best of 3), ``plain_ms``.

With ``--phases`` the kernels are built with ``-DMPGAN_PHASE_CLOCKS`` (a build of
its own) and every kernel shape is followed by the share of a pass's clocks that
each phase took, summed over the CTAs' first threads. The stamps cost time: read
the shares from such a run and the milliseconds from a run without the flag.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import sys

import numpy as np
import torch

TOL = 1e-4
PHASES = ("rows_a0", "fwd_hidden", "fwd_last", "unused_wgrad", "unused_da", "unused_rebuild",
          "tail", "in_products_wait", "in_products_loop", "in_products_epilogue", "search")
CLOCK_SLOTS = 25  # edge_products.cuh: kPhaseCount; slots 11-14 split the search
TILE_PHASES = ("wait", "rows_a0", "mma_loops", "hidden_epilogues", "last_layer",
               "receiver_adds", "search", "fn_wait", "fn_first_layer",
               "fn_mma_layers")  # slots 15-24: the bf16 forward's warp tiles (22-24: K4's fn)
GAPT_PHASES = ("qkv", "out", "ff", "fc", "attention", "tail")  # gapt_fused.cu: GaptPhase
GAPT_SLOTS = 9
CHECK_JETS = 16


def inputs(dev, b, n, seed, fe, fn_out=3):
    """u1, u2, mask, the hidden layers, x and fn at the published widths
    (fe as given, fn [256, 256] -> fn_out), drawn as ``chip_smoke.kernel_inputs``
    draws them."""
    g = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *s, scale=1.0: torch.randn(*s, generator=g, device=dev) * scale  # noqa: E731
    hidden = tuple(t for a, c in zip(fe[:-1], fe[1:]) for t in (r(a, c, scale=a ** -0.5),
                                                               r(c, scale=0.1)))
    k = fe[-1] + 32
    fn = (r(fe[-1], 256, scale=k ** -0.5), r(32, 256, scale=k ** -0.5), r(256, scale=0.1),
          r(256, 256, scale=1 / 16), r(256, scale=0.1), r(256, fn_out, scale=1 / 16),
          r(fn_out, scale=0.1))
    mask = (torch.rand(b, n, 1, generator=g, device=dev) > 0.3).float()
    return (r(b, n, fe[0], scale=0.5), r(b, n, fe[0], scale=0.5), mask, hidden, r(b, n, 32), fn)


def read_clocks(build, fn_name, slots):
    """The clocks summed per phase since the last read, which resets them."""
    fn = getattr(build.library(), fn_name)
    fn.argtypes = [ctypes.POINTER(ctypes.c_ulonglong), ctypes.c_int]
    fn.restype = ctypes.c_int
    buf = (ctypes.c_ulonglong * slots)()
    torch.cuda.synchronize()
    build.check(fn(buf, 1), fn_name)
    return list(buf)


def phase_shares(build, fn_name="mpgan_edge_aggregate_phase_clocks"):
    """Shares of a launch's pass clocks per phase since the last read (which resets
    them), from the kernel library's entry ``fn_name``. Where a search ran, also
    ``search_split``: the search's own clocks split into the staging of the
    senders (thread 0) and the rest, which the warps' own clocks split into keys,
    selection and outputs."""
    buf = read_clocks(build, fn_name, CLOCK_SLOTS)
    tile = buf[15:25]
    if any(tile):
        # the bf16 forward's warp tiles (edge_fwd_bf16_tiles.cuh): every warp's own
        # clocks, so the shares are of the warps' time, waits included
        return {name: round(v / sum(tile), 4) for name, v in zip(TILE_PHASES, tile)}
    total = max(sum(buf[:7]) + buf[10], 1)  # 7-9 split the products' time again
    out = {name: round(v / total, 4) for name, v in zip(PHASES, buf) if not name.startswith("un")}
    if buf[10]:
        stage = min(buf[11] / buf[10], 1.0)
        warp = max(sum(buf[12:15]), 1)
        out["search_split"] = {"stage": round(stage, 4), **{
            name: round((1 - stage) * v / warp, 4)
            for name, v in zip(("keys", "select", "out"), buf[12:15])}}
    return out


def gapt_phase_shares(build):
    """K9's shares of its CTAs' clocks per phase since the last read (which resets
    them); the attention is split into scores with softmax and the weighted sum
    by the warps' own clocks, and ``weight_waits`` is the share of the clocks
    that the projections spent waiting for a weight slab."""
    buf = read_clocks(build, "mpgan_gapt_fused_phase_clocks", GAPT_SLOTS)
    total = max(sum(buf[:6]), 1)
    out = {name: round(v / total, 4) for name, v in zip(GAPT_PHASES, buf)}
    warp = max(buf[7] + buf[8], 1)
    out["attention_scores_softmax"] = round(buf[4] / total * buf[7] / warp, 4)
    out["attention_weighted_sum"] = round(buf[4] / total * buf[8] / warp, 4)
    out["weight_waits"] = round(buf[6] / total, 4)
    return out


def bf16_rows(cs, mk, gk, dev, report, phases):
    """The bf16 modes of K2, K4 and K9 at the bf16 training steps' shapes."""
    shares = (lambda build: phase_shares(build, "mpgan_edge_aggregate_bf16_phase_clocks")) \
        if phases else phase_shares
    for b, n in ((256, 30), (32, 150)):
        u1, u2, mask, hidden, x, fn = inputs(dev, b, n, b + n, cs.FE)
        u1, u2, mask, x = cs.to_bf16(u1, u2, mask, x)
        hidden, fn = cs.to_bf16(*hidden), cs.to_bf16(*fn)
        for p, tag in ((0.5, "p=0.5"), (0.0, "eval")):
            a = (u1, u2, mask, hidden, 0.2, p == 0, p, 5)
            report("edge_aggregate_bf16", f"B={b} N={n} {tag}", lambda: mk.edge_aggregate(*a),
                   lambda: (mk.edge_aggregate(*a), mk.edge_aggregate_reference(*a)),
                   cs.bf16_bound(b, n, "fwd")["bound_ms"],
                   lambda: mk.edge_aggregate_reference(*a), shares)
        if n <= 64:
            a = (u1, u2, mask, hidden, x, fn, 0.2, True, 0.2, True)
            report("edge_aggregate_fn_bf16", f"B={b} N={n}", lambda: mk.edge_aggregate_fn(*a),
                   lambda: (mk.edge_aggregate_fn(*a), mk.edge_aggregate_fn_reference(*a)),
                   cs.bf16_bound(b, n, "fn")["bound_ms"],
                   lambda: mk.edge_aggregate_fn_reference(*a), shares)
        del u1, u2, mask, hidden, x, fn, a
        torch.cuda.empty_cache()
    from mpgan_tpu_torch.models.registry import build_suite
    from mpgan_tpu_torch.training.config import from_args_dict

    g = build_suite(from_args_dict(cs.GAPT)).generator(cs.prng_key(30, "cpu"),
                                                       device=dev)
    w = gk.GaptWeights(*cs.to_bf16(*g.fused_weights()))
    for b in (1024, 4096):
        x, mask = cs.to_bf16(*cs.gapt_kernel_inputs(dev, g, b, True, seed=b + 1))
        a = (x, mask, w, g.cfg.num_heads, 0.2)
        with torch.no_grad():
            out = gk.gapt_g_fused(*a)
            flops = cs.gapt_flops(b, 30, g.cfg.embed_dim, g.cfg.sab_layers, g.cfg.feat_size)
            report("gapt_g_fused_bf16", f"B={b} N=30 E=64 H=4 L=4 masked",
                   lambda: gk.gapt_g_fused(*a), lambda: gk.gapt_g_fused_reference(*a),
                   cs.bound(flops, cs.nbytes(x, mask, out, *w))["bound_ms"],
                   lambda: gk.gapt_g_fused_reference(*a), lambda build: None)
        del x, mask, a, out
        torch.cuda.empty_cache()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(pathlib.Path(__file__).resolve().parents[1]))
    ap.add_argument("--label", default="tree")
    ap.add_argument("--phases", action="store_true")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--plain", action="store_true")
    ap.add_argument("--bf16", action="store_true", help="time the bf16 modes of K2, K4 and K9")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("torch_fwd_bench: no CUDA device available")
    sys.path.insert(0, str(pathlib.Path(args.root).resolve()))
    import chip_smoke as cs
    from mpgan_tpu_torch.models.mpgan import MPGenerator
    from mpgan_tpu_torch.models.registry import build_suite
    from mpgan_tpu_torch.ops import _build
    from mpgan_tpu_torch.ops import gapt_kernels as gk
    from mpgan_tpu_torch.ops import mp_kernels as mk
    from mpgan_tpu_torch.training.config import build_mpgan_generator, from_args_dict

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = cs.card_line()
    _build.library(defines=("MPGAN_PHASE_CLOCKS",)) if args.phases else _build.library()
    lines = _build.build_info.get("log", "").splitlines()
    regs = [" ".join(x.strip() for x in lines[i + 1:i + 3]) for i, line in enumerate(lines)
            if "Function properties" in line and "edge_aggregate_kernel" in line]
    print(json.dumps({"label": args.label, "card": card, "phases": args.phases,
                      "bf16": args.bf16, "build_s": _build.build_info.get("seconds"),
                      "ptxas": regs}), flush=True)
    tol = cs.BF16_TOL if args.bf16 else TOL

    def report(kernel, shape, call, check, bound_ms, plain, shares=phase_shares):
        """``check`` gives (kernel output, plain output) on a part of the batch, or the
        plain output alone, which is then held against the timed call's own output."""
        res, again = call(), call()
        checked = check()
        out, ref = (res, checked) if isinstance(checked, torch.Tensor) else checked
        torch.cuda.synchronize()
        same = torch.equal(res, again)
        out, ref = out.float(), ref.float()
        err = ((out - ref).abs() / (tol + tol * ref.abs())).max().item()  # > 1: beyond rtol=atol
        del res, again, out, ref
        if args.phases:
            shares(_build)  # drop the clocks of the launches above
        row = {"label": args.label, "kernel": kernel, "shape": shape,
               "ms": cs.best_ms(call, reps=args.reps, inner=1), "bound_ms": bound_ms,
               "err_over_tol": err, "two_runs_bit_identical": same}
        if args.plain:
            row["plain_ms"] = cs.best_ms(plain, reps=3, inner=1)
            torch.cuda.empty_cache()
        if args.phases:
            row["phase_shares"] = shares(_build)
        print(json.dumps(row), flush=True)
        if err > 1 or not same:
            raise SystemExit(f"torch_fwd_bench: {kernel} at {shape}: error {err} x tol, "
                             f"bit-identical {same}")

    if args.bf16:
        bf16_rows(cs, mk, gk, dev, report, args.phases)
        return
    j = CHECK_JETS
    for fe, tag in ((cs.FE, ""), ([128, 256], " fe 128 256")):
        u1, u2, mask, hidden, _, _ = inputs(dev, 512, 150, 8, fe)
        flops = 2 * 512 * 150 * 150 * cs.macs(fe)
        report("edge_aggregate", "B=512 N=150 eval" + tag,
               lambda: mk.edge_aggregate(u1, u2, mask, hidden, 0.2, True),
               lambda: (mk.edge_aggregate(u1[:j], u2[:j], mask[:j], hidden, 0.2, True),
                        mk.edge_aggregate_reference(u1[:j], u2[:j], mask[:j], hidden, 0.2, True)),
               cs.bound(flops, 4 * (2 * 512 * 150 * fe[0] + 512 * 150 * (1 + fe[-1])))["bound_ms"],
               lambda: mk.edge_aggregate_reference(u1, u2, mask, hidden, 0.2, True))
        del u1, u2, mask, hidden
        torch.cuda.empty_cache()
    u1, u2, mask, hidden, _, _ = inputs(dev, 256, 30, 256, cs.FE)
    a = (u1, u2, mask, hidden, 0.2, True, 0.5, 5)
    report("edge_aggregate", "B=256 N=30 p=0.5", lambda: mk.edge_aggregate(*a),
           lambda: (mk.edge_aggregate(*a), mk.edge_aggregate_reference(*a)),
           cs.dense_fwd_bound(256, 30)["bound_ms"], lambda: mk.edge_aggregate_reference(*a))
    for b in (4096, 256):
        u1, u2, mask, hidden, x, fn = inputs(dev, b, 30, 7, cs.FE)
        a = (u1, u2, mask, hidden, x, fn, 0.2, True, 0.2, True)
        report("edge_aggregate_fn", f"B={b} N=30", lambda: mk.edge_aggregate_fn(*a),
               lambda: (mk.edge_aggregate_fn(*a), mk.edge_aggregate_fn_reference(*a)),
               cs.dense_fwd_bound(b, 30, 3)["bound_ms"], lambda: mk.edge_aggregate_fn_reference(*a))
        del u1, u2, mask, hidden, x, fn, a
        torch.cuda.empty_cache()

    gens = {}
    for n, b in ((30, 1024), (30, 4096), (150, 512)):
        if n not in gens:
            gens[n] = build_suite(from_args_dict({**cs.GAPT, "num_hits": n})).generator(
                cs.prng_key(30 if n == 30 else 6, "cpu"), device=dev)
        g = gens[n]
        x, mask = cs.gapt_kernel_inputs(dev, g, b, True, seed=b + 1)
        w, heads = g.fused_weights(), g.cfg.num_heads
        with torch.no_grad():
            out = gk.gapt_g_fused(x, mask, w, heads, 0.2)
            flops = cs.gapt_flops(b, n, g.cfg.embed_dim, g.cfg.sab_layers, g.cfg.feat_size)
            report("gapt_g_fused", f"B={b} N={n} E=64 H=4 L=4 masked",
                   lambda: gk.gapt_g_fused(x, mask, w, heads, 0.2),
                   lambda: gk.gapt_g_fused_reference(x, mask, w, heads, 0.2),
                   cs.bound(flops, cs.nbytes(x, mask, out, *w))["bound_ms"],
                   lambda: gk.gapt_g_fused_reference(x, mask, w, heads, 0.2), gapt_phase_shares)
        del x, mask, w, out
        torch.cuda.empty_cache()
    if not args.phases:
        g = gens[30]
        for b in (1024, 4096):
            noise = torch.randn(b, 30, g.cfg.embed_dim,
                                generator=torch.Generator(device=dev).manual_seed(b),
                                device=dev) * 0.2
            lab = torch.as_tensor((np.random.default_rng(b).integers(1, 31, size=(b, 1)) / 30)
                                  .astype(np.float32), device=dev)

            def gen():
                with torch.inference_mode():
                    g(noise, lab)
            ms = cs.best_ms(gen, reps=args.reps, inner=1)
            print(json.dumps({"label": args.label, "generation": "gapt 30p", "batch": b, "ms": ms,
                              "jets_per_s": b / ms * 1e3}), flush=True)
    del gens, g
    torch.cuda.empty_cache()

    for n, b in ((30, 4096), (150, 512)):
        g = MPGenerator(build_mpgan_generator(from_args_dict({**cs.FLAGSHIP, "num_hits": n})),
                        cs.prng_key(n, "cpu"), device=dev)
        noise = torch.randn(b, n, 32, generator=torch.Generator(device=dev).manual_seed(2),
                            device=dev) * 0.2
        lab = torch.full((b, 1), 0.7, device=dev)

        def gen():
            with torch.inference_mode():
                g(noise, lab)
        ms = cs.best_ms(gen, reps=args.reps, inner=1)
        print(json.dumps({"label": args.label, "generation": f"{n}p", "batch": b, "ms": ms,
                          "jets_per_s": b / ms * 1e3}), flush=True)
        del g, noise, lab
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
