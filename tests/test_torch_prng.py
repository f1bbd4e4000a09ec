"""The port's threefry PRNG (``mpgan_tpu_torch/ops/prng.py``) against ``jax.random``.

- keys, ``split`` (``split(k, n)[i]`` for several ``n``), ``fold_in``, the
  32-bit bits, ``uniform`` with bounds and ``randint`` on ``[0, 2**30)``, bit
  for bit, at sizes up to past 2**17 elements; ``normal`` within rtol = atol =
  1e-6 (the largest difference measured here is 4.8e-7: ``log1p`` is the
  library's, XLA's differs by an ulp at times, and the polynomial follows);
- JAX's CPU backend rounds a uniform's ``f * (hi - lo) + lo`` once (a fused
  multiply-add): rounding the product apart differs, and the port does not;
- the plans: rows below a batch counter and the order row, the next key written
  over the root (``advance``), the counter's bump, one plan equal to its rows
  drawn apart; what the wrapper refuses;
- the keys the modules take (``ops/keys.Keys``): the words and edge seeds of
  JAX's key tree, and the JAX package's dropout masks;
- the step's draws from keys: targets, the GP weight, the augmentation's and
  the noise, as the JAX package draws them.

The kernel ``csrc/threefry.cu`` is held to the plain version on the card
(``chip_smoke.py``, phase 31, and ``tests/test_torch_cuda_kernels.py``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one thread a test worker: the suite runs in parallel workers

import jax
import jax.numpy as jnp

from mpgan_tpu.ops import augment as jaug
from mpgan_tpu.ops import linear as jlinear
from mpgan_tpu.training import losses as jlosses
from mpgan_tpu.training import sampling as jsampling
from mpgan_tpu_torch.ops import augment as taug
from mpgan_tpu_torch.ops import linear as tlinear
from mpgan_tpu_torch.ops import prng
from mpgan_tpu_torch.ops.keys import Keys
from mpgan_tpu_torch.training import losses as tlosses
from mpgan_tpu_torch.training import sampling as tsampling

SIZES = [(1,), (7, 3), (2**17 + 5,)]


def _key(seed):
    return jax.random.PRNGKey(seed), prng.PRNGKey(seed)


def _same_bits(t: torch.Tensor, j) -> None:
    np.testing.assert_array_equal(t.numpy().view(np.uint32), np.asarray(j).view(np.uint32))


@pytest.mark.parametrize("seed", [0, 1, 42, 2**31 - 1, -5, 123456789])
def test_prngkey_matches_jax(seed):
    np.testing.assert_array_equal(prng.PRNGKey(seed).numpy(), np.asarray(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("num", [2, 3, 5, 9, 17])
def test_split_matches_jax_and_child_i_does_not_depend_on_num(num):
    jk, tk = _key(7)
    got = prng.split(tk, num)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax.random.split(jk, num)))
    for i in range(num):
        np.testing.assert_array_equal(got[i].numpy(), prng.fold_in(tk, i).numpy())
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(jax.random.split(jk, 20)[i]))


@pytest.mark.parametrize("data", [0, 1, 5, 123456, 2**31 - 1])
def test_fold_in_matches_jax(data):
    jk, tk = _key(3)
    np.testing.assert_array_equal(prng.fold_in(tk, data).numpy(),
                                  np.asarray(jax.random.fold_in(jk, data)))


@pytest.mark.parametrize("shape", SIZES)
def test_bits_match_jax(shape):
    jk, tk = _key(11)
    _same_bits(prng.random_bits(tk, shape), jax.random.bits(jk, shape))


@pytest.mark.parametrize("bounds", [(0.0, 1.0), (0.7, 1.2), (0.0, 0.3), (-3.0, 5.5)])
@pytest.mark.parametrize("shape", SIZES)
def test_uniform_matches_jax_bit_for_bit(shape, bounds):
    jk, tk = _key(5)
    lo, hi = bounds
    _same_bits(prng.uniform(tk, shape, lo, hi), jax.random.uniform(jk, shape, minval=lo, maxval=hi))


def test_jax_cpu_uniform_rounds_once():
    """The fused multiply-add is what JAX gives: the product rounded apart
    differs in a large share of the draws on [0.7, 1.2)."""
    jk, tk = _key(5)
    n = 50_000
    bits = prng._bits(prng.key_words(tk), n)
    f = prng._as_float((bits >> 9) | 0x3F800000) - 1.0
    lo, hi = torch.tensor(0.7), torch.tensor(1.2)
    apart = torch.maximum(lo, f * (hi - lo) + lo)
    want = np.asarray(jax.random.uniform(jk, (n,), minval=0.7, maxval=1.2))
    assert (apart.numpy() != want).mean() > 0.05
    _same_bits(prng.uniform(tk, (n,), 0.7, 1.2), want)


@pytest.mark.parametrize("scale", [1.0, 0.2])
@pytest.mark.parametrize("shape", SIZES)
def test_normal_matches_jax(shape, scale):
    jk, tk = _key(9)
    want = np.asarray(jax.random.normal(jk, shape) * scale)
    got = prng.normal(tk, shape, scale).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert np.abs(got - want).max() < 5e-7 * max(1.0, np.abs(want).max() / 4)


def test_erf_inv_matches_lax():
    x = np.linspace(-0.9999999, 0.9999999, 200_001).astype(np.float32)
    want = np.asarray(jax.lax.erf_inv(jnp.asarray(x)))
    np.testing.assert_allclose(prng.erf_inv(torch.from_numpy(x)).numpy(), want,
                               rtol=1e-6, atol=1e-6)
    assert torch.isinf(prng.erf_inv(torch.tensor([-1.0, 1.0]))).all()


@pytest.mark.parametrize("bounds", [(0, 2**30), (-7, 1000), (5, 5)])
@pytest.mark.parametrize("shape", SIZES)
def test_randint_matches_jax(shape, bounds):
    jk, tk = _key(13)
    lo, hi = bounds
    np.testing.assert_array_equal(prng.randint(tk, shape, lo, hi).numpy(),
                                  np.asarray(jax.random.randint(jk, shape, lo, hi)))


def _jax_words(key):
    kd = np.asarray(key).ravel()
    return int(kd[0]), int(kd[-1])


def _jax_edge_seed(key):
    s = jax.random.randint(jax.random.fold_in(key, 1), (), 0, 2**30, dtype=jnp.int32)
    return int(np.float32(s))


@pytest.mark.parametrize("seed", range(6))
def test_keys_serve_the_words_and_edge_seeds_of_jax_key_trees(seed):
    """``Keys`` below a root, split as a module splits, against the JAX key tree:
    ``linear.hash_seed`` of the words and the float32-rounded edge seed."""
    jk, tk = _key(seed)
    jax_node, port_node = jk, Keys(tk)
    for num, i in ((9, 2), (4, 3), (2, 1), (3, 0)):
        jax_node = jax.random.split(jax_node, num)[i]
        port_node = port_node.split(num)[i]
        assert int(port_node.words()) == tlinear.hash_seed(_jax_words(jax_node))
        assert int(port_node.edge_seed()) == _jax_edge_seed(jax_node)
        np.testing.assert_array_equal(port_node.key().numpy(), np.asarray(jax_node))


def test_edge_seeds_round_to_float32_as_jax_does():
    """Over many keys some seeds lie past 2**24 and round; they equal JAX's."""
    rounded = 0
    for seed in range(40):
        jk, tk = _key(seed)
        got = int(Keys(tk).edge_seed())
        assert got == _jax_edge_seed(jk)
        rounded += got % 2 == 0 and got > 2**24
    assert rounded > 0


@pytest.mark.parametrize("n", [13, 150])
@pytest.mark.parametrize("p", [0.5, 0.1])
def test_hash_dropout_with_port_keys_is_jax_mask(n, p):
    x = np.random.RandomState(n).randn(3, n, 17).astype(np.float32)
    jk, tk = _key(n)
    want = np.asarray(jlinear.hash_dropout(jnp.asarray(x), p, jk))
    got = tlinear.hash_dropout(torch.from_numpy(x), p, Keys(tk).words()).numpy()
    np.testing.assert_array_equal(got, want)


def test_plan_rows_counter_order_advance_and_bump():
    _, root = _key(21)
    order = torch.arange(12, dtype=torch.int32).reshape(3, 4)
    counter = torch.tensor([2], dtype=torch.int32)
    rows = [prng.Row("order", (4,)), prng.Row("key", (2,), (prng.COUNTER, 1)),
            prng.Row("uniform", (5, 2), (3,), 0.7, 1.2), prng.Row("normal", (6,), (1, 0), 0.2),
            prng.Row("words", (1,), (4, 1)), prng.Row("edge_seed", (1,), (2,)),
            prng.Row("key", (2,), (5,)), prng.Row("uniform", (4,), (6,), -3.0, 2.0)]
    plan = prng.Plan(rows)
    key = root.clone()
    views = plan.views(plan.run(key, counter=counter, order=order, advance=2, bump=True))
    np.testing.assert_array_equal(views[0].numpy(), [8, 9, 10, 11])
    np.testing.assert_array_equal(views[1].numpy(), prng.fold_in(prng.fold_in(root, 2), 1).numpy())
    alone = [prng.uniform(prng.fold_in(root, 3), (5, 2), 0.7, 1.2),
             prng.normal(prng.fold_in(prng.fold_in(root, 1), 0), (6,), 0.2)]
    for v, a in zip(views[2:4], alone):
        assert torch.equal(v, a)
    k = Keys(root, (4, 1))
    assert int(views[4]) == int(k.words()) and int(views[5]) == int(Keys(root, (2,)).edge_seed())
    assert torch.equal(views[6], prng.split(root, 6)[5])
    assert torch.equal(views[7], prng.uniform(prng.fold_in(root, 6), (4,), -3.0, 2.0))
    assert views[2].dtype == torch.float32 and views[6].dtype == torch.uint32
    # the next key: child 0 of child 0 of the root; the counter advanced
    np.testing.assert_array_equal(key.numpy(), prng.fold_in(prng.fold_in(root, 0), 0).numpy())
    assert int(counter) == 3


def test_plan_refuses_what_the_kernel_does_not_take():
    key = prng.PRNGKey(0)
    for dist in ("gamma", "split", "bits", "randint"):  # keys, bits and ints: the host's
        with pytest.raises(ValueError, match="unknown distribution"):
            prng.Plan([prng.Row(dist)])
    with pytest.raises(ValueError, match="path"):
        prng.Plan([prng.Row("uniform", (2,), (0,) * (prng.MAX_PATH + 1))])
    with pytest.raises(ValueError, match="scale"):
        prng.Plan([prng.Row("normal", (2,))])
    with pytest.raises(ValueError, match="counter"):
        prng.Plan([prng.Row("uniform", (2,), (prng.COUNTER,))]).run(key)
    with pytest.raises(ValueError, match="order"):
        prng.Plan([prng.Row("order", (4,))]).run(key, counter=torch.zeros(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="uint32"):
        prng.Plan([prng.Row("uniform", (2,))]).run(torch.zeros(2, dtype=torch.int64))
    plan = prng.Plan([prng.Row("uniform", (2,))], "meta")
    with pytest.raises(ValueError, match="meta"):
        prng.threefry_draws(torch.zeros(2, dtype=torch.uint32, device="meta"), plan,
                            torch.empty(2, dtype=torch.int32, device="meta"))


@pytest.mark.parametrize("smoothing,noise", [(True, 0.0), (False, 0.2), (True, 0.3)])
def test_d_targets_match_jax(smoothing, noise):
    jk, tk = _key(17)
    want = jlosses.d_targets(jk, 64, smoothing, noise)
    got = tlosses.d_targets(tk, 64, smoothing, noise)
    for g, w in zip(got, want):
        _same_bits(g, w)


def test_gp_alpha_matches_jax():
    jk, tk = _key(19)
    like = torch.zeros(6, 10, 3)
    _same_bits(tlosses.gp_alpha(tk, like), jax.random.uniform(jk, (6, 1, 1)))


def test_draw_augment_matches_jax_split_8():
    jk, tk = _key(23)
    cfg = taug.AugmentConfig(aug_t=True, aug_f=True, aug_r90=True, aug_s=True)
    got = taug.draw_augment(cfg, tk, 5)
    k = jax.random.split(jk, 8)
    u = lambda i, s: jax.random.uniform(k[i], (5,) + s)  # noqa: E731
    _same_bits(got.r90[0], u(0, (1, 1)))
    _same_bits(got.r90[1], u(1, (1, 1)))
    _same_bits(got.flip[0], u(2, (1, 1)))
    _same_bits(got.flip[1], u(3, (1, 2)))
    _same_bits(got.translate[1], u(5, (1, 2)))
    _same_bits(got.scale[0], u(6, (1, 1)))
    np.testing.assert_allclose(got.scale[1].numpy(),
                               np.asarray(jax.random.normal(k[7], (5, 1, 1))), rtol=1e-6, atol=1e-6)
    # and the augmented cloud equals the JAX package's
    x = np.random.RandomState(0).rand(5, 7, 3).astype(np.float32)
    jcfg = jaug.AugmentConfig(aug_t=True, aug_f=True, aug_r90=True, aug_s=True)
    want = np.asarray(jaug.augment(jcfg, jk, jnp.asarray(x), 0.7))
    np.testing.assert_allclose(taug.augment(cfg, torch.from_numpy(x), 0.7, got).numpy(), want,
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("points", [False, True])
def test_noise_spec_samples_jax_noise(points):
    jk, tk = _key(29)
    jspec = jsampling.NoiseSpec((10, 4), 0.2, (10, 3) if points else None)
    tspec = tsampling.NoiseSpec((10, 4), 0.2, (10, 3) if points else None)
    noise, point_noise = jspec.sample(jk, 8)
    np.testing.assert_allclose(tspec.sample(tk, 8).numpy(), np.asarray(noise), rtol=1e-6, atol=1e-6)
    if points:
        np.testing.assert_allclose(tspec.sample_points(tk, 8).numpy(), np.asarray(point_noise),
                                   rtol=1e-6, atol=1e-6)
    else:
        assert tspec.sample_points(tk, 8) is None
