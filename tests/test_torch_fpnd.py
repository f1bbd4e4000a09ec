"""The PyTorch port's FPND (``evaluation/fpnd.py``) against the JAX package.

- ParticleNet activations on JAX's random trunk (``particlenet_from_jax``) on
  jets of 3 to 30 real particles, zero-padded (so padded neighbours tie and the
  stable sort decides), within 1e-5;
- the Frechet distance of equal activations within 1e-6 relative, and
  ``fpnd`` end to end within 1e-4 relative;
- a ``pnet_state_dict.pt`` in the schema of ``tests/test_fpnd_import.py``,
  written here, loaded by both packages: activations within 1e-5; a file of
  another schema raises ``KeyError`` in both;
- the seeded random trunk;
- the train CLI with ``--fpnd`` on synthetic 30-particle jets logs and saves an
  FPND entry (random trunk, with its warning); a weights file that fails to
  load leaves FPND out, as in the JAX package.
"""

import logging

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one thread a test worker: the suite runs in parallel workers

import jax
import jax.numpy as jnp

from mpgan_tpu.evaluation.fpd import frechet_distance as jfrechet_distance
from mpgan_tpu.evaluation import fpnd as jfpnd
from mpgan_tpu_torch.cli import args as targs_cli
from mpgan_tpu_torch.cli import train as ttrain_cli
from mpgan_tpu_torch.evaluation import fpnd as tfpnd
from mpgan_tpu_torch.ops import prng
from mpgan_tpu_torch.utils.weights import load_particlenet, particlenet_from_jax

from test_fpnd_import import _build_torch_particlenet

ACT_TOL = dict(rtol=1e-5, atol=1e-5)


def _jets(batch, n=30, seed=1, min_real=3):
    """Jets of ``min_real`` to ``n`` real particles, zero-padded; every count
    below 17 leaves the search's last neighbours among tied padded particles."""
    rng = np.random.default_rng(seed)
    jets = rng.normal(scale=0.3, size=(batch, n, 3)).astype(np.float32)
    jets[..., 2] = np.abs(jets[..., 2])
    counts = np.resize(np.arange(min_real, n + 1), batch)
    jets *= (np.arange(n)[None, :] < counts[:, None])[..., None]
    return jets


@pytest.fixture(scope="module")
def jax_trunk():
    return jfpnd.particlenet_init(jax.random.PRNGKey(42))


def test_activations_match_jax_on_padded_jets(jax_trunk):
    jets = _jets(56)
    assert (np.abs(jets).sum(-1) > 0).sum(1).min() == 3
    j = np.asarray(jfpnd.particlenet_activations(jax_trunk, jnp.asarray(jets)))
    t = tfpnd.particlenet_activations(particlenet_from_jax(jax.tree.map(np.asarray, jax_trunk)),
                                      torch.from_numpy(jets))
    assert t.shape == (56, 256)
    np.testing.assert_allclose(t.numpy(), j, **ACT_TOL)


def test_knn_breaks_padded_ties_by_index():
    """Padded particles sit at one point: their distances tie exactly, and the
    neighbours are the lowest indices, as ``jnp.argsort`` (stable) gives."""
    pts = np.zeros((1, 20, 2), np.float32)
    pts[0, :4] = np.random.default_rng(0).normal(size=(4, 2))
    pts[0, 4:] += 1e3
    t = tfpnd.knn_indices(torch.from_numpy(pts), 16).numpy()
    j = np.asarray(jnp.argsort(
        jnp.sum((pts[:, :, None] - pts[:, None]) ** 2, -1) + jnp.eye(20) * 1e9, axis=2))[..., :16]
    np.testing.assert_array_equal(t, j)
    np.testing.assert_array_equal(t[0, 0, 3:], np.arange(4, 17))


def test_frechet_on_equal_activations_matches_jax(jax_trunk):
    rng = np.random.default_rng(0)
    a_real = rng.normal(size=(600, 256)).astype(np.float32)
    a_gen = (rng.normal(size=(600, 256)) * 1.1 + 0.05).astype(np.float32)
    mu1, s1 = a_real.mean(axis=0), np.cov(a_real, rowvar=False)
    mu2, s2 = a_gen.mean(axis=0), np.cov(a_gen, rowvar=False)
    j = jfrechet_distance(mu1, s1, mu2, s2)
    assert tfpnd.frechet_from_activations(a_real, a_gen) == pytest.approx(j, rel=1e-6)


def test_fpnd_matches_jax(jax_trunk):
    real, gen = _jets(600, seed=2), _jets(600, seed=3)
    gen[:, 12:] = 0  # fewer particles: a clearly positive distance
    j = jfpnd.fpnd(real, gen, jax_trunk, batch_size=200, num_samples=600)
    t = tfpnd.fpnd(real, gen, particlenet_from_jax(jax.tree.map(np.asarray, jax_trunk)),
                   batch_size=128, num_samples=600, device="cpu")
    assert j > 0 and t == pytest.approx(j, rel=1e-4)


def test_random_trunk_is_seeded():
    a, b = tfpnd.particlenet_init(), tfpnd.particlenet_init()
    c = tfpnd.particlenet_init(prng.PRNGKey(7))
    wa, wb, wc = (p["edge_convs"][2]["convs"][1]["w"] for p in (a, b, c))
    assert wa.shape == (256, 256) and torch.equal(wa, wb) and not torch.equal(wa, wc)
    jets = torch.from_numpy(_jets(8))
    np.testing.assert_array_equal(tfpnd.particlenet_activations(a, jets).numpy(),
                                  tfpnd.particlenet_activations(b, jets).numpy())


def test_pnet_state_dict_loads_in_both_packages(tmp_path):
    path = tmp_path / "pnet_state_dict.pt"
    torch.save(_build_torch_particlenet(torch, seed=4).state_dict(), str(path))
    jets = _jets(40, seed=5)
    j = np.asarray(jfpnd.particlenet_activations(jfpnd.load_particlenet(str(path)),
                                                 jnp.asarray(jets)))
    t = tfpnd.particlenet_activations(load_particlenet(str(path)), torch.from_numpy(jets))
    np.testing.assert_allclose(t.numpy(), j, **ACT_TOL)


def test_wrong_schema_raises_key_error_in_both_packages(tmp_path):
    path = tmp_path / "bad.pt"
    torch.save({"some.other.key": torch.zeros(3)}, str(path))
    for load in (jfpnd.load_particlenet, load_particlenet):
        with pytest.raises(KeyError, match="Expected weaver-style keys"):
            load(str(path))


TINY30 = ["--model", "mpgan", "--jets", "g", "--num-hits", "30", "--hidden-node-size", "8",
          "--fe", "12", "16", "--fn", "16", "--batch-size", "16", "--eval-tot-samples", "64",
          "--w1-num-samples", "50", "--num-samples", "300", "--num-epochs", "1",
          "--save-epochs", "1"]


def _run(argv):
    """``cli.train`` after its logging setup, which would take the root
    logger's handlers from ``caplog``."""
    return ttrain_cli.run(targs_cli.parse_cli(argv), "cpu")


def test_train_cli_fpnd_logs_and_saves_the_metric(tmp_path, caplog):
    caplog.set_level(logging.INFO)
    t = _run(["--name", "f", "--dir-path", str(tmp_path), *TINY30, "--fpnd"])
    assert "fpnd" in t.eval_keys and len(t.losses["fpnd"]) == 1
    assert np.isfinite(t.losses["fpnd"][0]) and t.losses["fpnd"][0] > 0
    saved = np.loadtxt(tmp_path / "f" / "losses" / "fpnd.txt")
    assert float(saved) == pytest.approx(t.losses["fpnd"][0])
    assert "random ParticleNet trunk" in caplog.text and "fpnd " in caplog.text


def test_train_cli_fpnd_with_an_unreadable_weights_file_leaves_it_out(tmp_path, caplog):
    (tmp_path / "pnet_state_dict.pt").write_bytes(b"not a torch file")
    t = _run(["--name", "f", "--dir-path", str(tmp_path), "--datasets-path", str(tmp_path),
              *TINY30, "--fpnd"])
    assert "fpnd" not in t.eval_keys and "FPND unavailable" in caplog.text
    assert "pnet_state_dict.pt" in caplog.text
