"""The numbers that decide ``correct``, each against its limit.

Training (the first ``check_steps`` D+G steps of the window's own step object,
against :mod:`.reference.step` from the same weights, batches and keys):

- ``real1_gap``: ``|L - L_ref| / |L_ref|`` of the first step's D-real loss,
  D on real jets from the initial weights (the first knn selection on the
  same bits on both sides);
- ``real1_jets``: the share of the first step's real jets whose D output
  (that loss's terms, one a jet) lies more than ``JET_TOL`` (relative) from
  the reference's: steady where a rare near-tie moves a few jets' outputs;
- ``loss1_gap``: the same as ``real1_gap``, the larger of the first step's D-real and D-fake
  losses (the fakes carry G's forward, whose later knn selections can differ
  from the reference's at near-ties);
- ``dgrad_gap``: over D's leaves, the gap between the norms of D's first
  gradient (the program's worked out from its optimizer's state after one
  step: RMSprop's ``sqrt(v / 0.01)``) and the reference's, over the larger of the reference
  leaf's norm and the median leaf norm;
- ``loss_gap``: as ``loss1_gap`` over every step's D-real, D-fake and G loss
  (the third step is the captured graph's first replay);
- ``grad_gap``: as ``dgrad_gap`` over both models' leaves (G's first gradient
  follows D's first update);
- ``change_gap``: the median leaf's gap of the parameters' change over the
  steps, each leaf's as above, leaving out the leaves whose reference
  gradient lies under a thousandth of the model's median leaf norm (rounding
  alone moves them under RMSprop). The median and not the worst leaf: the
  change of G's output layer after three steps swings from seed to seed with
  the later steps' noise (up to 0.57 on sound runs), where every leaf left
  unchanged reads 1.

The last three carry what RMSprop's first update does to rounding: it moves
every weight by ``lr / sqrt(0.01)`` in its gradient's sign, so a gradient
element that rounding alone sets moves a weight by as much as any other.

Generation (a sample of the window's batches, drawn from the seed, against
:func:`.reference.model.generator` on the same weights, noise and labels):

- ``max_err``: the largest absolute difference over the sampled jets' values,
  leaving out the rows whose last knn selection lies near a tie.
"""

from __future__ import annotations

import json
import pathlib

import torch

MOVED = 1e-3  # a leaf moves where its reference gradient reaches this share of the median
JET_TOL = 1e-5  # a jet's D output agrees within this relative gap: sound runs round at ~1e-7


def _median(values):
    v = sorted(values)
    return v[len(v) // 2] if len(v) % 2 else 0.5 * (v[len(v) // 2 - 1] + v[len(v) // 2])


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.double()))


def leaf_gaps(prog: dict, ref: dict, keep=None) -> list[float]:
    """Each leaf's ``|n_prog - n_ref| / max(n_ref, median n_ref)`` of norms by name."""
    med = _median(list(ref.values()))
    return [abs(prog[name] - r) / max(r, med, 1e-30) for name, r in ref.items()
            if keep is None or name in keep]


def leaf_gap(prog: dict, ref: dict, keep=None) -> float:
    """The worst leaf's gap (:func:`leaf_gaps`)."""
    return max(leaf_gaps(prog, ref, keep))


def train_numbers(prog: dict, ref: dict, init: dict) -> dict:
    """``prog``: ``losses`` ``[[Dr, Df, G], ...]``, ``grad_norm`` and ``final``
    by model (``"g"``, ``"d"``) and leaf; ``ref``: :func:`.reference.step.run_steps`'
    result; ``init``: the initial weights by model and leaf (host tensors)."""
    def rel(a, b):
        return abs(a - b) / max(abs(b), 1e-30)

    pairs = list(zip(prog["losses"], ref["losses"], strict=True))
    loss1 = max(rel(a, b) for a, b in zip(pairs[0][0][:2], pairs[0][1][:2]))
    loss = max(rel(a, b) for lp, lr in pairs for a, b in zip(lp, lr, strict=True))
    dp, dr = prog["d_real1"].double(), ref["d_real1"].double()
    jets = float(((dp - dr).abs() > JET_TOL * dr.abs()).double().mean())
    out = {"real1_gap": rel(pairs[0][0][0], pairs[0][1][0]), "real1_jets": jets,
           "loss1_gap": loss1,
           "dgrad_gap": 0.0, "loss_gap": loss, "grad_gap": 0.0, "change_gap": 0.0}
    changes, worst_change = [], 0.0
    for m in ("g", "d"):
        ref_grad = {k: _norm(v) for k, v in ref["grad"][m].items()}
        gap = leaf_gap(prog["grad_norm"][m], ref_grad)
        out["grad_gap"] = max(out["grad_gap"], gap)
        if m == "d":
            out["dgrad_gap"] = gap
        med = _median(list(ref_grad.values()))
        keep = {k for k, v in ref_grad.items() if v >= MOVED * med}
        ref_change = {k: _norm(ref["final"][m][k].cpu() - init[m][k]) for k in init[m]}
        prog_change = {k: _norm(prog["final"][m][k].cpu() - init[m][k]) for k in init[m]}
        changes += leaf_gaps(prog_change, ref_change, keep)
        worst_change = max(worst_change, leaf_gap(prog_change, ref_change, keep))
    out["change_gap"] = _median(changes)
    out["change_worst"] = worst_change
    return out


def as_program(ref: dict) -> dict:
    """A reference run's readings in the program's form (its first gradients'
    norms), for a control or a fault put in the program's place."""
    return {"losses": ref["losses"], "final": ref["final"], "d_real1": ref["d_real1"],
            "grad_norm": {m: {k: _norm(v) for k, v in g.items()} for m, g in ref["grad"].items()}}


def gen_numbers(prog: torch.Tensor, ref: torch.Tensor, risky: torch.Tensor) -> dict:
    """``prog``, ``ref`` ``[J, N, F]``; ``risky`` ``[J, N]`` rows left out."""
    err = (prog.double() - ref.double()).abs().amax(dim=-1)
    err = torch.where(risky, torch.zeros_like(err), err)
    return {"max_err": float(err.max())}


def load_limits(path: pathlib.Path) -> dict:
    return {k: float(v["limit"]) for k, v in json.loads(path.read_text())["numbers"].items()}


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """``correct`` (every number the cell's limits name is finite and within
    its limit) and those numbers beside their limits. A limit without its
    number fails; a number the cell does not compare is left out."""
    checks, ok = {}, set(limits) <= set(numbers)
    for name, limit in limits.items():
        value = numbers.get(name, float("nan"))
        ok = ok and value == value and value <= limit
        checks[name] = {"value": value, "limit": limit}
    return ok, checks
