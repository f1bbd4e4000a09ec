"""The MP layer's configuration lattice against the JAX package, points
15, 25, 27, 29, 38 (``tests/torch_mp_lattice.py`` says what each check holds).

The JAX package's lattice (``tests/test_kernel_fuzz.py``) is split over eight
files so that parallel workers share it, the points grouped so that the
files take about equal time.
"""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one thread a test worker: the suite runs in parallel workers
torch.backends.cuda.matmul.allow_tf32 = False

import torch_mp_lattice as lattice  # noqa: E402

CASES = (15, 25, 27, 29, 38)


@pytest.mark.parametrize("name", lattice.checks(CASES))
def test_lattice_point_matches_jax(name, monkeypatch):
    lattice.check(name, monkeypatch)
