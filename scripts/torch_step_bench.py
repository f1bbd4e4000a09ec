#!/usr/bin/env python
"""Time the port's D+G train steps that run the backward kernels, kernel path only.

    python scripts/torch_step_bench.py [--root CHECKOUT] [--label NAME] [--reps N]

For a machine with a CUDA card. Flagship step at B=256 N=30, knn-20 step at
B=128 N=150 and GAPT step at B=512 N=30 (K9 for the D step's fake batch),
published widths, random weights from a seed, built and timed with
``chip_smoke.py``'s helpers: CUDA events, best of ``--reps`` timings of two
steps each; then a ``torch.profiler`` window of three steps for the device time
a step, the idle share and the backward kernels' rows. One JSON object a line.

``--bf16`` times instead the bf16 steps (``--compute-dtype bfloat16``) as the
training loop runs them, on CUDA graphs (``--epoch-scan``): the flagship at
B=256, knn-20 at B=128 on routes 4 and 3 (``MPGAN_TPU_KNN_KERNEL=3``) and GAPT at
B=512 (K9 in its bf16 mode for the D step's fake batch), an
epoch of ``chip_smoke.GRAPH_STEPS`` batches that captures, then wall ms a step
(the best of ``--reps`` epochs) and a ``torch.profiler`` epoch: device ms a
step, idle share and kernels a step (``chip_smoke.epoch_profile``); ``--paths``
names some of them (flagship, knn20, knn20_route3, gapt).

``--graphs`` times the graph steps as the training loop runs them
(``--epoch-scan``, an epoch of ``chip_smoke.GRAPH_STEPS`` batches that
captures first): the float32 and bf16 flagship at B=256, knn-20 at B=128 and
GAPT at B=512, each with its wall ms a step (the best of ``--reps`` epochs),
the host's time to issue a step (``chip_smoke.issue_epoch``: the device
drained before each step call) and a ``torch.profiler`` epoch (device ms a
step, idle share, kernels a step); then GAPT generation through
``generate_multi_batch`` at B=1024 and B=4096 (jets/s, 50 batches, the best of
``--reps``). A checkpoint whose sampler takes a key gets ``PRNGKey(1)``, an
older one a device ``torch.Generator`` seeded 1.

``--eager`` times the same four steps on the eager loop (``--no-epoch-scan``,
a step's draws and its dropout keys drawn as the loop draws them): wall ms a
step (the best of ``--reps`` epochs of ``chip_smoke.GRAPH_STEPS`` batches after
a first epoch), issue ms and a ``torch.profiler`` epoch, as ``--graphs`` reads
them.

``--root`` names the checkout whose ``chip_smoke.py`` and ``mpgan_tpu_torch``
are used (default: the one that holds this script), and ``--label`` goes into
every line, so that two checkouts run in turns on one card can be told apart.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import tempfile
import time

import numpy as np
import torch


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(pathlib.Path(__file__).resolve().parents[1]))
    ap.add_argument("--label", default="tree")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--bf16", action="store_true", help="time the bf16 graph steps")
    ap.add_argument("--paths", default="flagship,knn20,knn20_route3,gapt",
                    help="the bf16 graph steps to time, comma-separated")
    ap.add_argument("--graphs", action="store_true",
                    help="time the float32 and bf16 graph steps and GAPT generation")
    ap.add_argument("--eager", action="store_true",
                    help="time the float32 and bf16 eager steps (--no-epoch-scan)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("torch_step_bench: no CUDA device available")
    sys.path.insert(0, str(pathlib.Path(args.root).resolve()))
    import chip_smoke as cs
    from mpgan_tpu_torch.training.config import from_args_dict

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = cs.card_line()
    if args.graphs or args.eager:
        return graph_steps(cs, from_args_dict, dev, card, args)
    if args.bf16:
        return bf16_graph_steps(cs, from_args_dict, dev, card, args)
    for name, model, batch, n in (("flagship", cs.FLAGSHIP, 256, 30),
                                  ("knn20", cs.KNN150, 128, 150), ("gapt", cs.GAPT, 512, 30)):
        margs = from_args_dict(model)
        data, labels = (t.to(dev) for t in cs.real_batch(batch, n))
        state = cs.make_state(margs, dev)
        cs.use_kernels(state, True)
        step = cs.step_fn(state, margs, data, labels)
        ms = cs.best_ms(step, reps=args.reps, inner=2)
        print(json.dumps({"label": args.label, "card": card, "step": name, "batch": batch, "n": n,
                          "kernel_path_ms": ms}), flush=True)
        cs.profile_steps(step, card, f"{args.label}_{name}_step_profile", batch=batch, n=n)
        del state, step
        torch.cuda.empty_cache()


def bf16_graph_steps(cs, from_args_dict, dev, card, args):
    from mpgan_tpu_torch.data.loader import BatchLoader

    for name, model, batch, route in (("flagship", cs.FLAGSHIP, 256, None),
                                      ("knn20", cs.KNN150, 128, None),
                                      ("knn20_route3", cs.KNN150, 128, "3"),
                                      ("gapt", cs.GAPT, 512, None)):
        if name not in args.paths.split(","):
            continue
        cs.set_knn_route(route)
        try:
            margs = from_args_dict({**model, "compute_dtype": "bfloat16"})
            margs.batch_size = batch
            data, labels = cs.graph_data(margs, cs.GRAPH_STEPS * batch)
            with tempfile.TemporaryDirectory() as tmp:
                t = cs.graph_trainer(margs, dev, pathlib.Path(tmp), name, True)
                loader = BatchLoader(data, labels, batch_size=batch, shuffle=True,
                                     seed=margs.seed)
                t.train_epoch(1, loader)  # captures
                wall = [cs.timed_epoch(t, 2 + i, loader) for i in range(args.reps)]
                prof = cs.epoch_profile(t, 2 + args.reps, loader)
            print(json.dumps({"label": args.label, "card": card, "bf16_graph_step": name,
                              "batch": batch, "wall_ms": min(wall), "wall_ms_all": wall,
                              **prof}), flush=True)
            del t
            torch.cuda.empty_cache()
        finally:
            cs.set_knn_route()


def graph_steps(cs, from_args_dict, dev, card, args):
    """The graph steps and GAPT generation, or with ``args.eager`` the eager steps."""
    from mpgan_tpu_torch.data.loader import BatchLoader
    from mpgan_tpu_torch.models.registry import build_suite
    from mpgan_tpu_torch.training.sampling import generate_multi_batch

    for name, model, batch in (("flagship", cs.FLAGSHIP, 256),
                               ("flagship_bf16", {**cs.FLAGSHIP, "compute_dtype": "bfloat16"},
                                256),
                               ("knn20", cs.KNN150, 128), ("gapt", cs.GAPT, 512)):
        margs = from_args_dict(model)
        margs.batch_size = batch
        data, labels = cs.graph_data(margs, cs.GRAPH_STEPS * batch)
        with tempfile.TemporaryDirectory() as tmp:
            t = cs.graph_trainer(margs, dev, pathlib.Path(tmp), name, not args.eager)
            loader = BatchLoader(data, labels if t.use_labels else None, batch_size=batch,
                                 shuffle=True, seed=margs.seed)
            t.train_epoch(1, loader)  # records, warms up, captures
            wall = [cs.timed_epoch(t, 2 + i, loader) for i in range(args.reps)]
            issue = cs.issue_epoch(t, 2 + args.reps, loader)
            prof = cs.epoch_profile(t, 3 + args.reps, loader)
        print(json.dumps({"label": args.label, "card": card,
                          "eager_step" if args.eager else "graph_step": name, "batch": batch,
                          "wall_ms_best": min(wall), "wall_ms_all": wall, "issue_ms": issue,
                          "profile": prof}), flush=True)
        del t
        torch.cuda.empty_cache()
    if args.eager:
        return
    margs = from_args_dict(cs.GAPT)
    g = build_suite(margs).generator(cs.prng_key(30, "cpu"), device=dev)
    spec = build_suite(margs).noise
    labels = cs.graph_data(margs, 4096)[1]
    for batch in (1024, 4096):
        n = 50 * batch
        lab = None if labels is None else labels[np.arange(n) % len(labels)]
        rates = []
        for _ in range(args.reps + 1):  # the first call captures
            key = cs.prng_key(1, dev) if hasattr(cs, "prng_key") else \
                torch.Generator(device=dev).manual_seed(1)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            generate_multi_batch(g, spec, key, n, batch, labels=lab)
            rates.append(n / (time.perf_counter() - t0))
        print(json.dumps({"label": args.label, "card": card, "gapt_generation": batch,
                          "jets_per_s": max(rates[1:]), "jets_per_s_all": rates[1:]}),
              flush=True)


if __name__ == "__main__":
    main()
