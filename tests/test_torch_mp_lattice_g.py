"""The MP layer's configuration lattice against the JAX package, points
7, 8, 10, 13, 16, 42 (``tests/torch_mp_lattice.py`` says what each check holds).

The JAX package's lattice (``tests/test_kernel_fuzz.py``) is split over eight
files so that parallel workers share it, the points grouped so that the
files take about equal time.
"""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one thread a test worker: the suite runs in parallel workers
torch.backends.cuda.matmul.allow_tf32 = False

import torch_mp_lattice as lattice  # noqa: E402

CASES = (7, 8, 10, 13, 16, 42)


@pytest.mark.parametrize("name", lattice.checks(CASES))
def test_lattice_point_matches_jax(name, monkeypatch):
    lattice.check(name, monkeypatch)


def test_card_phase_samples_the_same_points():
    """chip_smoke.py's copy of the sampler gives the JAX lattice's 48 points."""
    import pathlib
    import random
    import sys

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import chip_smoke

    for case in range(lattice.N_CASES):
        assert chip_smoke.lattice_sample(random.Random(4242 + case)) == lattice.point(case)
    assert chip_smoke.LATTICE_CASES == lattice.N_CASES
