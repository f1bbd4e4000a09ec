"""The 150-particle dense D+G step in FP32, the port's kernel path against the
JAX package's jnp path on the CPU (``test_torch_dense150.step_matches_jax``):
losses and every gradient at rtol = atol = 1e-4, D's last layer scaled so that
every gradient is live. A file of its own: the JAX side's compiles take most
of a minute."""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one thread a test worker: the suite runs in parallel workers

from test_torch_dense150 import step_matches_jax  # noqa: E402


def test_dense150_step_matches_jax():
    step_matches_jax(bf16=False)
