#!/usr/bin/env python
"""Hold the FP32 kernels of two checkouts to each other: their build and their bits.

    python scripts/torch_fp32_parity.py --root CHECKOUT --save OUT.pt
    python scripts/torch_fp32_parity.py --root OTHER --against OUT.pt

For a machine with a CUDA card. It builds ``CHECKOUT``'s kernels, keeps what
``ptxas -v`` said of every kernel in the FP32 sources (registers, stack, spill
stores and loads, by source and kernel; the names with the per-build hashes of
their translation units taken out), and runs the FP32 kernels K2-K9 on seeded
inputs at the flagship and knn-20 widths: K2 (eval, dropout 0.5), K3 and K6
(with and without weight gradients, dropout 0.5), K4, K5 (eval; dropout 0.5
with ``idx`` and distances), K7 (with distances), K8 on K5's ``idx``, K9 at
B=64. ``--save`` writes the outputs and the ``ptxas`` lines; ``--against`` holds
this checkout's to a saved file, prints one JSON line (tensors compared, those
not bit-identical, kernels whose ``ptxas`` lines differ) and exits 1 on any
difference. A kernel of an FP32 source that only this checkout has and whose name
holds ``bf16`` (a bf16 entry beside the FP32 one, as K7's and K9's) is listed
apart (``bf16_kernels_added``), not as a difference.

The bf16 modes run too, on the inputs of ``chip_smoke.py`` phases 28-29 rounded
to bf16. K3 and K6 (B=256 N=30, B=160 N=150 k=20, dropout 0.5, with and without
weight gradients), K4 (B=256 N=30: its tile pass keeps the FP32 pass's sums and
fn's k order), K7 (B=160, with distances) and K9 (B=1024 on bf16 inputs) are held
to equal bits with the FP32 outputs. K2 (B=256 N=30 and
B=32 N=150, eval and dropout 0.5), K5 (B=160 N=150 k=20 and N=13 k=5 in phase
29's four configurations, ``idx`` and distances too) and K8 on K5's ``idx`` are
reported apart (keys ``bf16_``): each output's largest difference from the
saved one over the saved one's largest element, how many elements differ and
how many there are, so that a change to their pass shows as bit for bit or as
the size of its difference.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import re
import sys

import torch

FP32_SOURCES = ("edge_aggregate.cu", "edge_aggregate_bwd.cu", "knn_fused.cu", "knn_edge_bwd.cu",
                "knn_search.cu", "knn_edge_aggregate.cu", "gapt_fused.cu")


def ptxas_by_kernel(log: str) -> dict[str, list[str]]:
    """Per ``source:kernel`` of the FP32 sources, ptxas's lines on its resources."""
    out, src, fn = {}, None, None
    for line in log.splitlines():
        if " -c -o " in line:
            name = line.split()[-1].rsplit("/", 1)[-1]
            src = name if name in FP32_SOURCES else None
            continue
        if src is None:
            continue
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)'?", line)
        if m:
            # the mangled name holds hashes of its translation unit, which differ by tree
            fn = f"{src}:{re.sub(r'_[0-9a-f]{8}', '_', m.group(1))}"
        elif fn and ("spill" in line or "Used" in line or "stack frame" in line):
            out.setdefault(fn, []).append(" ".join(line.split()))
    return out


def outputs(cs, mk, kk, gk, dev, from_args_dict) -> dict[str, torch.Tensor]:
    res = {}

    def keep(name, value):
        if isinstance(value, torch.Tensor):
            res[name] = value.detach().cpu()
        elif isinstance(value, (tuple, list)):
            for i, v in enumerate(value):
                if v is not None:
                    keep(f"{name}.{i}", v)

    for b, n in ((64, 30), (4, 150)):
        u1, u2, mask, hidden, x, fn = cs.kernel_inputs(dev, b, n, 3, seed=1500 + n)
        g = torch.randn(b, n, cs.FE[-1], device=dev,
                        generator=torch.Generator(device=dev).manual_seed(n))
        keep(f"k2_eval_{n}", mk.edge_aggregate(u1, u2, mask, hidden, 0.2, True))
        keep(f"k2_train_{n}", mk.edge_aggregate(u1, u2, mask, hidden, 0.2, False, 0.5, 1515))
        for need in (True, False):
            keep(f"k3_{n}_{need}", mk.edge_aggregate_bwd(u1, u2, mask, hidden, g, 0.2, False,
                                                         0.5, 1515, need))
        if n <= 64:
            keep(f"k4_{n}", mk.edge_aggregate_fn(u1, u2, mask, hidden, x, fn, 0.2, True, 0.2,
                                                 True))
    d = cs.knn_inputs(dev, 16, 150, 32, cs.FE, 20, seed=1515)
    fwd = (d["xs"], d["xf"], d["u1"], d["u2m"])
    keep("k5_eval", kk.knn_fused_layer(*fwd, None, d["hidden"], 20, True, False, 0.2, True))
    out5, idx, dists = kk.knn_fused_layer(*fwd, d["w_d"], d["hidden"], 20, False, True, 0.2,
                                          False, 0.5, 1515, True)
    keep("k5_train", (out5, idx, dists))
    keep("k7", kk.knn_search(d["xs"], d["xf"], 20, False, True))
    keep("k8", kk.knn_edge_aggregate(d["u1"], d["u2m"], idx, dists, d["w_d"], d["hidden"], 0.2,
                                     False, 0.5, 1515))
    for need in (True, False):
        keep(f"k6_{need}", kk.knn_edge_aggregate_bwd(d["u1"], d["u2m"], idx, dists, d["w_d"],
                                                     d["hidden"], d["g"], 0.2, False, 0.5, 1515,
                                                     need))
    # the bf16 modes: K3, K4, K6, K7 held to equal bits ("bf16held_"), K2 reported apart
    for b, n in ((256, 30), (32, 150)):
        u1, u2, mask, hidden, x, fn = cs.kernel_inputs(dev, b, n, 3, seed=28 + n)
        g = torch.randn(b, n, cs.FE[-1], device=dev,
                        generator=torch.Generator(device=dev).manual_seed(n))
        u1, u2, mask, x, g = cs.to_bf16(u1, u2, mask, x, g)
        hidden, fn = cs.to_bf16(*hidden), cs.to_bf16(*fn)
        keep(f"bf16_k2_eval_{n}", mk.edge_aggregate(u1, u2, mask, hidden, 0.2, True))
        keep(f"bf16_k2_train_{n}", mk.edge_aggregate(u1, u2, mask, hidden, 0.2, False, 0.5,
                                                     2828))
        for need in (True, False):
            keep(f"bf16held_k3_{n}_{need}", mk.edge_aggregate_bwd(u1, u2, mask, hidden, g, 0.2,
                                                                  False, 0.5, 1515, need))
        if n <= 64:
            keep("bf16held_k4", mk.edge_aggregate_fn(u1, u2, mask, hidden, x, fn, 0.2, True,
                                                     0.2, True))
    for b, n, c, widths, k in ((160, 150, 32, cs.FE, 20), (3, 13, 8, [24, 16, 12], 5)):
        d = cs.knn_bf16(cs.knn_inputs(dev, b, n, c, widths, k, seed=290 + n))
        for self_loops, sum_agg, dists_on, p in ((True, True, False, 0.0),
                                                 (False, False, True, 0.5),
                                                 (True, False, True, 0.0),
                                                 (False, True, False, 0.5)):
            w_d = d["w_d"] if dists_on else None
            tag = f"{n}_{self_loops}_{sum_agg}_{dists_on}_{p}"
            out5, idx, dists = kk.knn_fused_layer(d["xs"], d["xf"], d["u1"], d["u2m"], w_d,
                                                  d["hidden"], k, self_loops, dists_on, 0.2,
                                                  sum_agg, p, 292929, True)
            keep(f"bf16_k5_{tag}", (out5, idx, dists))
            keep(f"bf16_k8_{tag}", kk.knn_edge_aggregate(d["u1"], d["u2m"], idx, dists, w_d,
                                                         d["hidden"], 0.2, sum_agg, p, 292929))
            if n == 150 and dists_on:
                keep(f"bf16held_k7_{tag}", kk.knn_search(d["xs"], d["xf"], k, self_loops, True))
    d = cs.knn_bf16(cs.knn_inputs(dev, 160, 150, 32, cs.FE, 20, seed=1516))
    idx = kk.knn_search(d["xs"], d["xf"], 20, True)[0]
    for need in (True, False):
        keep(f"bf16held_k6_{need}", kk.knn_edge_aggregate_bwd(d["u1"], d["u2m"], idx, None, None,
                                                              d["hidden"], d["g"], 0.2, True, 0.5,
                                                              1515, need))
    from mpgan_tpu_torch.models.registry import build_suite

    g = build_suite(from_args_dict(cs.GAPT)).generator(cs.prng_key(15, "cpu"),
                                                        device=dev)
    x, mask = cs.gapt_kernel_inputs(dev, g, 64, True, seed=15)
    with torch.no_grad():
        w = g.fused_weights()
        keep("k9", gk.gapt_g_fused(x, mask, w, g.cfg.num_heads, 0.2))
        x, mask = cs.gapt_kernel_inputs(dev, g, 1024, True, seed=1053)
        keep("bf16held_k9", gk.gapt_g_fused(*cs.to_bf16(x, mask), gk.GaptWeights(
            *cs.to_bf16(*w)), g.cfg.num_heads, 0.2))
    torch.cuda.synchronize()
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", required=True)
    side = ap.add_mutually_exclusive_group(required=True)
    side.add_argument("--save")
    side.add_argument("--against")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("torch_fp32_parity: no CUDA device available")
    sys.path.insert(0, str(pathlib.Path(args.root).resolve()))
    import chip_smoke as cs
    from mpgan_tpu_torch.ops import _build
    from mpgan_tpu_torch.ops import gapt_kernels as gk
    from mpgan_tpu_torch.ops import knn_kernels as kk
    from mpgan_tpu_torch.ops import mp_kernels as mk
    from mpgan_tpu_torch.training.config import from_args_dict

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    _build.library()
    log = _build.build_info.get("log") or (pathlib.Path(_build.build_info["path"]).parent
                                           / "build.log").read_text()
    mine = {"ptxas": ptxas_by_kernel(log),
            "outputs": outputs(cs, mk, kk, gk, dev, from_args_dict)}
    if args.save:
        torch.save(mine, args.save)
        print(json.dumps({"root": args.root, "saved": args.save,
                          "tensors": len(mine["outputs"]), "kernels": len(mine["ptxas"])}))
        return
    theirs = torch.load(args.against)
    differ = sorted(k for k in theirs["outputs"] if not k.startswith("bf16_") and (
        k not in mine["outputs"] or not torch.equal(theirs["outputs"][k], mine["outputs"][k])))
    bf16 = {}
    for k, t in theirs["outputs"].items():
        if k.startswith("bf16_"):
            a, b = mine["outputs"][k].float(), t.float()
            bf16[k] = [((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item(),
                       int((a != b).sum().item()), b.numel()]
    bf16_bits = all(v[1] == 0 for v in bf16.values())
    added = sorted(k for k in mine["ptxas"] if k not in theirs["ptxas"] and "bf16" in k)
    ptx = sorted(k for k in set(theirs["ptxas"]) | set(mine["ptxas"])
                 if theirs["ptxas"].get(k) != mine["ptxas"].get(k) and k not in added)
    print(json.dumps({"root": args.root, "against": args.against,
                      "tensors": len(theirs["outputs"]) - len(bf16), "not_bit_identical": differ,
                      "bf16_diff_over_max_n_differing_numel": bf16,
                      "bf16_reported_bit_identical": bf16_bits,
                      "kernels": len(theirs["ptxas"]), "ptxas_differs": ptx,
                      "bf16_kernels_added": added,
                      "ptxas_lines_differing": {k: [theirs["ptxas"].get(k), mine["ptxas"].get(k)]
                                                for k in ptx}}))
    if differ or ptx:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
