#!/usr/bin/env python
"""K4's bf16 outputs on inputs drawn with numpy, to hold two checkouts to each other bit for bit.

    python scripts/torch_k4_bf16_bits.py [--root CHECKOUT] --save OUT.npz
    python scripts/torch_k4_bf16_bits.py [--root CHECKOUT] --against OUT.npz

For a machine with a CUDA card. It runs ``CHECKOUT``'s K4 in the bf16 mode
(``mp_kernels.edge_aggregate_fn`` on bf16 tensors) on the cases of ``CASES``: the
flagship G's two MP layers at the bf16 D+G step's batch and a smaller one, odd
widths, a wide chain and a chain without a hidden layer, each drawn from its seed
with numpy (so the inputs are the same on any machine and PyTorch). ``--save``
writes the outputs' bf16 bit patterns (uint16) into an ``.npz``; ``--against``
holds this checkout's to a saved file, prints one JSON line (per case: equal, the
elements that differ, their count) and exits 1 on any difference.
``tests/data/k4_bf16_fp32_pass.npz`` holds the outputs of the FP32 pass's bf16 mode
(K4's kernel before it ran on ``csrc/edge_fwd_bf16_tiles.cuh``), which the card test
``test_edge_aggregate_fn_bf16_equals_the_fp32_pass_bit_for_bit`` holds the kernel to.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

import numpy as np
import torch

# name: (batch, n, fe widths, x features, fn widths after its first layer's input,
# sum_agg, fn_final_linear, seed)
CASES = {
    "flagship_fn_3": (256, 30, [96, 160, 192], 32, [256, 256, 3], True, True, 1),
    "flagship_fn_32": (16, 30, [96, 160, 192], 32, [256, 256, 32], True, False, 2),
    "odd": (33, 13, [30, 50, 7], 6, [13, 3], False, False, 3),
    "wide": (2, 45, [64, 256, 224], 32, [256, 8], True, True, 4),
    "no_hidden": (3, 5, [96], 16, [20], False, True, 5),
}


def case_args(name: str, dev) -> tuple:
    """The arguments of ``edge_aggregate_fn`` for a case, bf16 on ``dev``."""
    b, n, fe, feat, fn, sum_agg, final_linear, seed = CASES[name]
    rng = np.random.default_rng(seed)

    def r(*shape, scale=0.3):
        t = torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))
        return t.to(device=dev, dtype=torch.bfloat16)

    hidden = tuple(t for a, c in zip(fe[:-1], fe[1:]) for t in (r(a, c, scale=a ** -0.5), r(c)))
    k = fe[-1] + feat
    fn_flat = [r(fe[-1], fn[0], scale=k ** -0.5), r(feat, fn[0], scale=k ** -0.5), r(fn[0])]
    for a, c in zip(fn[:-1], fn[1:]):
        fn_flat += [r(a, c, scale=a ** -0.5), r(c)]
    mask = torch.from_numpy((rng.random((b, n, 1)) > 0.3).astype(np.float32))
    u1, u2, x = r(b, n, fe[0], scale=0.5), r(b, n, fe[0], scale=0.5), r(b, n, feat)
    return (u1, u2, mask.to(device=dev, dtype=torch.bfloat16), hidden, x, tuple(fn_flat), 0.2,
            sum_agg, 0.1, final_linear)


def outputs(mk, dev) -> dict[str, np.ndarray]:
    """Each case's K4 bf16 output as its bit patterns (uint16)."""
    out = {}
    for name in CASES:
        y = mk.edge_aggregate_fn(*case_args(name, dev))
        out[name] = y.view(torch.int16).cpu().numpy().view(np.uint16)
    torch.cuda.synchronize()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(pathlib.Path(__file__).resolve().parents[1]))
    side = ap.add_mutually_exclusive_group(required=True)
    side.add_argument("--save")
    side.add_argument("--against")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("torch_k4_bf16_bits: no CUDA device available")
    sys.path.insert(0, str(pathlib.Path(args.root).resolve()))
    from mpgan_tpu_torch.ops import mp_kernels as mk

    mine = outputs(mk, torch.device("cuda"))
    if args.save:
        np.savez_compressed(args.save, **mine)
        print(json.dumps({"root": args.root, "saved": args.save, "cases": list(mine)}))
        return
    theirs = np.load(args.against)
    res = {k: {"equal": bool(np.array_equal(mine[k], theirs[k])),
               "differing": int((mine[k] != theirs[k]).sum()), "numel": int(theirs[k].size)}
           for k in theirs.files}
    print(json.dumps({"root": args.root, "against": args.against, "cases": res}))
    if not all(v["equal"] for v in res.values()):
        raise SystemExit(1)


if __name__ == "__main__":
    main()
