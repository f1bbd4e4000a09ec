"""Losses, label targets, the WGAN-GP penalty and the optimizers of the
PyTorch port against the JAX package.

- ``d_loss``/``g_loss`` (og, ls, w, hinge) on the same targets within 1e-5;
- ``d_targets``' shapes, ranges and flip rates from a threefry key (the
  values themselves against JAX's in ``tests/test_torch_prng.py``);
- the GP penalty through a train-mode discriminator and its gradient with
  respect to D's weights (a double backward) within 1e-5 and 1e-4;
- the optimizers on identical gradients (both follow the torch update rules,
  so they agree to a few ulps).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one thread a test worker: the suite runs in parallel workers

import jax
import jax.numpy as jnp

from mpgan_tpu.models.mpgan import mp_discriminator_apply, mp_discriminator_init
from mpgan_tpu.training import config as jconfig
from mpgan_tpu.training import losses as jlosses
from mpgan_tpu.training import optimizers as jopt
from mpgan_tpu_torch.ops import prng
from mpgan_tpu_torch.data.jetnet import JetNetDataset
from mpgan_tpu_torch.training import config as tconfig
from mpgan_tpu_torch.training import losses as tlosses
from mpgan_tpu_torch.training import optimizers as topt
from mpgan_tpu_torch.utils.weights import jax_leaves, mp_discriminator_from_jax

from test_torch_ops import port_keys  # the port's keys of a JAX key

torch.backends.cuda.matmul.allow_tf32 = False
FWD_TOL = dict(rtol=1e-5, atol=1e-5)
BWD_TOL = dict(rtol=1e-4, atol=1e-4)
NARROW = {"model": "mpgan", "num_hits": 10, "hidden_node_size": 8, "fe": [12, 16], "fn": [16]}


def _disc_pair(card, seed=0):
    jcfg = jconfig.build_mpgan_discriminator(jconfig.from_args_dict(card))
    tcfg = tconfig.build_mpgan_discriminator(tconfig.from_args_dict(card))
    params, state = mp_discriminator_init(jax.random.PRNGKey(seed), jcfg)
    return jcfg, params, state, mp_discriminator_from_jax(
        jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, state), tcfg)


def _batch(card, b, seed=0):
    ds = JetNetDataset("g", num_particles=card["num_hits"], synthetic_num_jets=200, seed=seed)
    return ds.particle_data[:b], ds.jet_data[:b]


@pytest.mark.parametrize("loss", ["og", "ls", "w", "hinge"])
def test_losses_match_jax(loss):
    rng = np.random.RandomState(0)
    real = rng.uniform(0.05, 0.95, (8, 1)).astype(np.float32)
    fake = rng.uniform(0.05, 0.95, (8, 1)).astype(np.float32)
    key = jax.random.PRNGKey(1)
    total_j, parts_j = jlosses.d_loss(loss, jnp.asarray(real), jnp.asarray(fake), rng=key,
                                      label_smoothing=True, label_noise=0.2)
    targets = tuple(map(lambda a: torch.from_numpy(np.array(a)),
                        jlosses.d_targets(key, 8, True, 0.2)))
    total_t, parts_t = tlosses.d_loss(loss, torch.from_numpy(real), torch.from_numpy(fake),
                                      targets)
    for k in ("Dr", "Df", "D"):
        np.testing.assert_allclose(parts_t[k].numpy(), np.asarray(parts_j[k]), **FWD_TOL)
    np.testing.assert_allclose(tlosses.g_loss(loss, torch.from_numpy(fake)).numpy(),
                               np.asarray(jlosses.g_loss(loss, jnp.asarray(fake))), **FWD_TOL)


def test_d_targets_shapes_ranges_and_flips():
    key = prng.PRNGKey(0)
    y_real, y_fake = tlosses.d_targets(key, 4000, True, 0.0)
    assert y_real.shape == y_fake.shape == (4000, 1)
    assert 0.7 <= y_real.min() and y_real.max() <= 1.2 and 0 <= y_fake.min() and y_fake.max() <= 0.3
    y_real, y_fake = tlosses.d_targets(prng.fold_in(key, 1), 4000, False, 0.25)
    assert abs((y_real == 0).float().mean() - 0.25) < 0.03
    assert abs((y_fake == 1).float().mean() - 0.25) < 0.03
    ones, zeros = tlosses.d_targets(None, 3, False, 0.0)
    assert torch.equal(ones, torch.ones(3, 1)) and torch.equal(zeros, torch.zeros(3, 1))


def test_gradient_penalty_and_its_double_backward_match_jax():
    """GP through a train-mode D on the plain path; the penalty and its gradient
    with respect to D's weights (a double backward)."""
    card = dict(NARROW, gp=10.0)
    jcfg, params, state, d = _disc_pair(card)
    real, labels = _batch(card, 4)
    fake = real[::-1].copy()
    k_drop, k_gp = jax.random.split(jax.random.PRNGKey(3))
    alpha = jax.random.uniform(k_gp, (4, 1, 1))

    def jgp(p):
        return jlosses.gradient_penalty(
            lambda x: mp_discriminator_apply(jcfg, p, state, x, jnp.asarray(labels), train=True,
                                             rng=k_drop)[0],
            k_gp, jnp.asarray(real), jnp.asarray(fake), 10.0)

    gp_j, grads_j = jax.value_and_grad(jgp)(params)
    gp_t = tlosses.gradient_penalty(
        lambda x: d(x, torch.from_numpy(labels), train=True, rng=port_keys(k_drop)),
        torch.from_numpy(np.array(alpha)), torch.from_numpy(real), torch.from_numpy(fake), 10.0)
    gp_t.backward()
    np.testing.assert_allclose(gp_t.item(), float(gp_j), **FWD_TOL)
    for t, j in zip(jax_leaves(d, True), jax.tree.leaves(grads_j)):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j), **BWD_TOL)


@pytest.mark.parametrize("name", ["rmsprop", "adadelta", "adam"])
def test_optimizers_match_jax_on_identical_gradients(name):
    rng = np.random.RandomState(0)
    p0 = [rng.randn(5, 3).astype(np.float32), rng.randn(3).astype(np.float32)]
    grads = [[rng.randn(*p.shape).astype(np.float32) for p in p0] for _ in range(3)]
    jo = jopt.build_optimizer(name, 1e-3, beta1=0.5, beta2=0.99)
    jp = [jnp.asarray(p) for p in p0]
    js = jo.init(jp)
    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in p0]
    to = topt.build_optimizer(name, tp, 1e-3, beta1=0.5, beta2=0.99)
    for g in grads:
        upd, js = jo.update([jnp.asarray(x) for x in g], js, jp)
        jp = [a + u for a, u in zip(jp, upd)]
        for p, x in zip(tp, g):
            p.grad = torch.from_numpy(x)
        to.step()
    for t, j in zip(tp, jp):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=1e-6, atol=1e-7)
