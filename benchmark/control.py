"""The readings that a cell's limits are set from, on the chip at the cell's size.

    python3 benchmark/control.py --workload mpgan30-train --program 1,2,3 --control 4,5,6

For each ``--program`` seed: the program's numbers, from a run's set-up (and,
for generation, a window of ``--seconds``), against the plain reference. For
each ``--control`` seed: the numbers of the reference put in the program's
place at the next precision down (the reference module's ``control_matmul``:
TF32 products), and, for training, of the fault that takes each loss's mean
over half of the batch. With ``--witness`` (training), each program seed also
reads G against the reference that goes on from the program's own D
(:func:`witness`). One JSON line a reading. The benchmark's own runs do not
run this; it is what ``benchmark/limits/<cell>.json`` records the readings of.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _readings(loop, side):
    """The numbers of ``side`` against the reference in the configuration's precision."""
    from benchmark import correct

    ref = loop.reference()
    if side == "program":
        return loop.numbers(ref), ref
    if loop.unit == "step":
        alt = loop.reference(mm=loop.ref.control_matmul) if side == "tf32" else \
            loop.reference(half_batch=True)
        return correct.train_numbers(correct.as_program(alt), ref, loop.init), ref
    alt = loop.reference(mm=loop.ref.control_matmul)
    return correct.gen_numbers(alt["jets"], ref["jets"], ref["risky"]), ref


def _flips(loop, model: str, after: dict, ref_after: dict, ref_grad: dict) -> list:
    """The weights of ``model`` that the program's first update (``after``)
    moved against the reference's sign (``ref_after``), and the largest
    reference gradient among them over its leaf's largest."""
    count, worst = 0, 0.0
    for name, p0 in loop.init[model].items():
        bad = torch.sign(after[model][name] - p0) != torch.sign(ref_after[model][name] - p0)
        count += int(bad.sum())
        if bad.any():
            g = ref_grad[model][name].cpu().abs()
            worst = max(worst, float(g[bad].max() / g.max()))
    return [count, worst]


def detail(loop, ref) -> dict:
    """Per step the program's and the reference's losses; after the first
    update, the weights that moved against the reference's sign, by model, and
    the largest reference gradient among them over its leaf's largest; the
    four leaves whose change over the steps lies farthest from the
    reference's (gap, reference and program norms, gradient over the median
    leaf's, size)."""
    if loop.unit != "step" or not hasattr(loop, "program"):
        return {}
    from benchmark import correct
    one = loop.reference_steps(1)
    flips = {m: _flips(loop, m, loop.snapshots["params"][1], one["after"][0], one["grad"])
             for m in ("g", "d")}
    leaves = {}
    for m in ("g", "d"):
        ref_grad = {k: correct._norm(v) for k, v in ref["grad"][m].items()}
        med = correct._median(list(ref_grad.values()))
        for k, p0 in loop.init[m].items():
            rc = correct._norm(ref["final"][m][k].cpu() - p0)
            pc = correct._norm(loop.program["final"][m][k].cpu() - p0)
            leaves[f"{m}.{k}"] = [abs(pc - rc) / max(rc, 1e-30), rc, pc, ref_grad[k] / med,
                                  p0.numel()]
    top = sorted(leaves.items(), key=lambda kv: -kv[1][0])[:4]
    return {"losses": loop.program["losses"], "ref_losses": ref["losses"], "flips1": flips,
            "change_leaves": top}


def witness(loop, ref) -> dict:
    """G against two references: the plain one (``ref``), and one whose D is
    the program's own after each step's D update (``d_after``), so that only
    G's own arithmetic differs. For each: G's weights moved against the
    reference's sign by the first update (count, largest reference gradient
    among them over its leaf's largest), the worst G leaf of the first
    gradient's norm gap, and G's three worst leaves of the change over the
    steps (gap, reference gradient over the median leaf's)."""
    from benchmark import correct

    steps = len(loop.first_rows)
    d_after = [loop.snapshots["params"][s + 1]["d"] for s in range(steps)]
    out = {}
    for side, r in (("plain", ref), ("program_d", loop.reference_steps(steps, d_after=d_after))):
        ref_grad = {k: correct._norm(v) for k, v in r["grad"]["g"].items()}
        med = correct._median(list(ref_grad.values()))
        grad = {k: abs(loop.program["grad_norm"]["g"][k] - v) / max(v, med)
                for k, v in ref_grad.items()}
        change = {}
        for k, p0 in loop.init["g"].items():
            if ref_grad[k] < correct.MOVED * med:
                continue
            rc = correct._norm(r["final"]["g"][k].cpu() - p0)
            pc = correct._norm(loop.program["final"]["g"][k].cpu() - p0)
            change[k] = [abs(pc - rc) / max(rc, 1e-30), ref_grad[k] / med]
        out[side] = {
            "flips1": _flips(loop, "g", loop.snapshots["params"][1], r["after"][0], r["grad"]),
            "grad_worst": max(grad.items(), key=lambda kv: kv[1]),
            "change_worst": sorted(change.items(), key=lambda kv: -kv[1][0])[:3],
            "losses": r["losses"]}
    return out


def readings(root, workload: str, seed: int, role: str, device, seconds: float = 0.0,
             requests: int = 0, with_witness: bool = False):
    """The reading dicts of one seed: ``role`` "program" (the program's
    numbers, and for training with ``with_witness`` :func:`witness`'s) or
    "control" (the TF32 control's and, for training, the half-batch fault's)."""
    from benchmark import harness

    c = harness.cell(root, workload)
    t0 = time.perf_counter()
    loop = harness.make_loop(c, seed, device)
    try:
        if role == "program":
            with loop.patch():
                loop.setup()
                if loop.unit == "batch":
                    loop.window(seconds)
            loop.free()
            sides = ["program"]
        else:
            if loop.unit == "batch":
                loop.kept = [(r, loop.pick(r), None) for r in range(1, requests + 1)]
            loop.free()
            sides = ["tf32", "half_batch"] if loop.unit == "step" else ["tf32"]
        for side in sides:
            numbers, ref = _readings(loop, side)
            more = {"witness": witness(loop, ref)} if with_witness and side == "program" \
                and loop.unit == "step" else {}
            yield {"workload": workload, "seed": seed, "side": side, "numbers": numbers,
                   "extra": loop.extra, "seconds": time.perf_counter() - t0,
                   **detail(loop, ref), **more}
    finally:
        loop.close()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--program", default="")
    p.add_argument("--control", default="")
    p.add_argument("--seconds", type=float, default=0.0)
    p.add_argument("--requests", type=int, default=0,
                   help="generation: the requests a run makes, whose batches a control compares")
    p.add_argument("--witness", action="store_true",
                   help="training: G against the reference that goes on from the program's D")
    ns = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    seeds = [(int(s), "program") for s in ns.program.split(",") if s.isdigit()]
    seeds += [(int(s), "control") for s in ns.control.split(",") if s.isdigit()]
    for seed, role in seeds:
        for r in readings(ROOT, ns.workload, seed, role, dev, ns.seconds, ns.requests,
                          ns.witness):
            print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
