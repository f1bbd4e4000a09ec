"""The MP layer's configuration lattice against the JAX package, points
5, 24, 31, 35, 40, 41, 44, 47 (``tests/torch_mp_lattice.py`` says what each check holds).

The JAX package's lattice (``tests/test_kernel_fuzz.py``) is split over eight
files so that parallel workers share it, the points grouped so that the
files take about equal time.
"""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one thread a test worker: the suite runs in parallel workers
torch.backends.cuda.matmul.allow_tf32 = False

import torch_mp_lattice as lattice  # noqa: E402

CASES = (5, 24, 31, 35, 40, 41, 44, 47)


@pytest.mark.parametrize("name", lattice.checks(CASES))
def test_lattice_point_matches_jax(name, monkeypatch):
    lattice.check(name, monkeypatch)


def test_k4_route_is_differentiable_as_in_jax(monkeypatch):
    """An eval-mode dense layer on the K4 route (no conditioning, no SN or BN,
    N <= 64; point 28 without ``mask_fne_np``, which no sampled point is): the
    kernel path's gradients through K4's backward (K2 recomputed, K3) against
    JAX's custom VJP in interpret mode, outputs and every gradient."""
    s = {**lattice.point(28), "mask_fne_np": False}
    lattice.set_env(monkeypatch, s)
    p = lattice.Point(28, 0.0, s)
    assert p.takes_kernels() and not p.d["train"]
    lattice.assert_close(28, "K4 route", p.port_run(True), p.jax_run(True))
    lattice.assert_close(28, "plain path", p.port_run(False), p.jax_run(False))


def test_files_cover_every_point_once():
    """The eight files' points are the JAX lattice's 48, each once."""
    import importlib

    cases = [c for f in "abcdefgh"
             for c in importlib.import_module(f"test_torch_mp_lattice_{f}").CASES]
    assert sorted(cases) == list(range(lattice.N_CASES))
