"""The comparison that decides ``correct`` fails where it must: the control
(the reference in the program's place at TF32) and every fault a cell can
have, planted under a run that otherwise goes as on the card."""

from __future__ import annotations

import contextlib

import pytest
import torch

from benchmark import control, correct, harness
from benchmark.tests.tiny import REPO, tiny_root


@pytest.mark.parametrize("knn", [False, True], ids=["dense", "knn"])
@pytest.mark.parametrize("workload", ["tiny-train", "tiny-gen"])
def test_control_is_not_correct(tmp_path, workload, knn):
    root = tiny_root(tmp_path, knn=knn)
    limits = harness.cell(root, workload).limits
    seen = {}
    for seed in (1, 2, 3):
        for r in control.readings(root, workload, seed, "control", torch.device("cpu"),
                                  requests=3):
            seen.setdefault(r["side"], []).append(correct.judge(r["numbers"], limits)[0])
    assert seen["tf32"] == [False] * 3
    if workload == "tiny-train":
        assert seen["half_batch"] == [False] * 3


@contextlib.contextmanager
def _planted(obj, name, make):
    original = getattr(obj, name)
    setattr(obj, name, make(original))
    try:
        yield
    finally:
        setattr(obj, name, original)


def _unchanged(original):
    def step(self, *a, **kw):  # the optimizer leaves every parameter and its state as they are
        return None
    return step


def _half_batch(original):
    def mse(outputs, targets):
        n = outputs.shape[0] // 2
        return torch.mean((outputs[:n] - targets[:n]) ** 2)
    return mse


def _altered(original):
    def call(self, labels):
        out = original(self, labels).clone()
        out[0, 0, 0] += 0.01  # one value of each generated batch, as it is produced
        return out
    return call


FAULTS = {
    "state_unchanged": ("tiny-train", lambda: _planted(torch.optim.RMSprop, "step", _unchanged)),
    "half_batch": ("tiny-train", lambda: _planted(
        __import__("mpgan_tpu_torch.training.losses", fromlist=["_mse"]), "_mse", _half_batch)),
    "answer_altered": ("tiny-gen", lambda: _planted(
        __import__("mpgan_tpu_torch.training.sampling", fromlist=["_StaticSampler"])
        ._StaticSampler, "__call__", _altered)),
}


@pytest.mark.parametrize("knn", [False, True], ids=["dense", "knn"])
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_timed_path_is_not_correct(tmp_path, fault, knn):
    """The harness's run without its look for a chip, with the timed path
    broken underneath: ``correct`` comes out false. (A cell on one chip has no
    exchange between chips to leave out.)"""
    root = tiny_root(tmp_path, knn=knn)
    workload, plant = FAULTS[fault]
    with plant():
        out = harness.run(root, workload, 4, 0.2, False, torch.device("cpu"), 0.0)
    assert out["correct"] is False, out["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["mpgan30-train", "mpgan150knn20-train", "mpgan30-gen",
                                      "mpgan150knn20-gen"])
def test_control_fails_at_the_cells_size(workload):
    """On the card at the cell's own size: the TF32 control fails the cell's limits."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the cells run at their published sizes")
    limits = harness.cell(REPO, workload).limits
    for r in control.readings(REPO, workload, 11, "control", torch.device("cuda"), requests=4):
        assert not correct.judge(r["numbers"], limits)[0], r
