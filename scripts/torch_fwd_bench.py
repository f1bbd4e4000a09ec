#!/usr/bin/env python
"""Time the port's dense forward kernels (K2, K4) and the generation they carry.

    python scripts/torch_fwd_bench.py [--root CHECKOUT] [--label NAME] [--phases] [--reps N]
                                      [--plain]

For a machine with a CUDA card. It times, at the main paths' shapes and
published widths (fe [96, 160, 192], fn [256, 256]):

- K2 eval at B=512 N=150 (150p dense generation) and on the ``--fe 128 256``
  chain at the same shape; K2 with dropout 0.5 at B=256 N=30 (the flagship D in
  training);
- K4 at B=4096 N=30 (30p generation) and at B=256 N=30 (G in the flagship D+G
  step);
- K9, the fused GAPT generator, at B=1024 N=30 masked (GAPT generation), as a
  control beside the dense kernels (not with ``--phases``: it has no phase clocks);
- the generator forward of 30p (B=4096) and 150p dense (B=512) jets, in jets/s,

on inputs drawn as ``chip_smoke.py`` draws them and with its timer (CUDA
events, one call a timing, best of ``--reps`` after a warm-up). Each kernel is
first held against its plain version (on the first 16 jets where the plain
version of the whole batch would take gigabytes) and launched twice for equal
bits. One JSON object a line.

``--root`` names the checkout whose ``chip_smoke.py`` and ``mpgan_tpu_torch``
are used (default: the one that holds this script), and ``--label`` goes into
every line, so that two checkouts run in turns on one card can be told apart.

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

import torch

TOL = 1e-4
PHASES = ("rows_a0", "fwd_hidden", "fwd_last", "unused_wgrad", "unused_da", "unused_rebuild",
          "tail", "in_products_wait", "in_products_loop", "in_products_epilogue", "search")
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


def phase_shares(build, fn_name="mpgan_edge_aggregate_phase_clocks"):
    """Shares of a launch's pass clocks per phase since the last read (which resets
    them), from the kernel library's entry ``fn_name``."""
    fn = getattr(build.library(), fn_name)
    fn.argtypes = [ctypes.POINTER(ctypes.c_ulonglong), ctypes.c_int]
    fn.restype = ctypes.c_int
    buf = (ctypes.c_ulonglong * len(PHASES))()
    torch.cuda.synchronize()
    build.check(fn(buf, 1), fn_name)
    total = max(sum(buf[:7]) + buf[10], 1)  # 7-9 split the products' time again
    return {name: round(v / total, 4) for name, v in zip(PHASES, buf) if not name.startswith("un")}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(pathlib.Path(__file__).resolve().parents[1]))
    ap.add_argument("--label", default="tree")
    ap.add_argument("--phases", action="store_true")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--plain", action="store_true")
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
                      "build_s": _build.build_info.get("seconds"), "ptxas": regs}), flush=True)

    def report(kernel, shape, call, check, bound_ms, plain):
        res, again = call(), call()
        out, ref = check()
        torch.cuda.synchronize()
        same = torch.equal(res, again)
        err = ((out - ref).abs() / (TOL + TOL * ref.abs())).max().item()  # > 1: beyond rtol=atol
        del res, again, out, ref
        if args.phases:
            phase_shares(_build)  # drop the clocks of the launches above
        row = {"label": args.label, "kernel": kernel, "shape": shape,
               "ms": cs.best_ms(call, reps=args.reps, inner=1), "bound_ms": bound_ms,
               "err_over_tol": err, "two_runs_bit_identical": same}
        if args.plain:
            row["plain_ms"] = cs.best_ms(plain, reps=3, inner=1)
            torch.cuda.empty_cache()
        if args.phases:
            row["phase_shares"] = phase_shares(_build)
        print(json.dumps(row), flush=True)
        if err > 1 or not same:
            raise SystemExit(f"torch_fwd_bench: {kernel} at {shape}: error {err} x tol, "
                             f"bit-identical {same}")

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

    if not args.phases:
        g = build_suite(from_args_dict(cs.GAPT)).generator(torch.Generator().manual_seed(30),
                                                            device=dev)
        x, mask = cs.gapt_kernel_inputs(dev, g, 1024, True, seed=1025)
        w, heads = g.fused_weights(), g.cfg.num_heads
        with torch.no_grad():
            out = gk.gapt_g_fused(x, mask, w, heads, 0.2)
            flops = cs.gapt_flops(1024, 30, g.cfg.embed_dim, g.cfg.sab_layers, g.cfg.feat_size)
            report("gapt_g_fused", "B=1024 N=30 E=64 H=4 L=4 masked",
                   lambda: gk.gapt_g_fused(x, mask, w, heads, 0.2),
                   lambda: (gk.gapt_g_fused(x, mask, w, heads, 0.2),
                            gk.gapt_g_fused_reference(x, mask, w, heads, 0.2)),
                   cs.bound(flops, cs.nbytes(x, mask, out, *w))["bound_ms"],
                   lambda: gk.gapt_g_fused_reference(x, mask, w, heads, 0.2))
        del g, x, mask, w, out
        torch.cuda.empty_cache()

    for n, b in ((30, 4096), (150, 512)):
        g = MPGenerator(build_mpgan_generator(from_args_dict({**cs.FLAGSHIP, "num_hits": n})),
                        torch.Generator().manual_seed(n), device=dev)
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
