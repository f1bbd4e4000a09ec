"""The 150-particle dense D+G step in bf16, the port's kernel path against the
JAX package's float32 step (jnp path) on the CPU
(``test_torch_dense150.step_matches_jax``): losses at rtol = atol = 2e-2 and
every gradient within 0.15 of the tensor's largest (JAX's bf16 tolerances).
A file of its own: the JAX side's compiles take most of a minute."""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one thread a test worker: the suite runs in parallel workers

from test_torch_dense150 import step_matches_jax  # noqa: E402


def test_dense150_step_bf16_matches_jax():
    step_matches_jax(bf16=True)
