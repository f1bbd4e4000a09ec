"""PyTorch port ops against the JAX package: MLP (eval), spectral norm, masking.

Inputs come from numpy seeds and go to both packages; tolerance rtol = atol =
1e-5 (float32, different summation order), masks exactly equal.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from mpgan_tpu.ops import linear as jlinear
from mpgan_tpu.ops import masking as jmasking
from mpgan_tpu.ops import spectral_norm as jsn
from mpgan_tpu_torch.ops import linear as tlinear
from mpgan_tpu_torch.ops import masking as tmasking
from mpgan_tpu_torch.ops import spectral_norm as tsn
from mpgan_tpu_torch.utils.weights import mlp_sd_from_jax

torch.backends.cuda.matmul.allow_tf32 = False
TOL = dict(rtol=1e-5, atol=1e-5)


def _mlp_pytrees(cfg, seed):
    """Random JAX-layout MLP params/state (numpy), including non-trivial BN stats."""
    rng = np.random.RandomState(seed)
    params = {"layers": []}
    state = {}
    for i in range(cfg.num_layers):
        d_in, d_out = cfg.sizes[i], cfg.sizes[i + 1]
        params["layers"].append({
            "w": (rng.randn(d_out, d_in) / np.sqrt(d_in)).astype(np.float32),
            "b": (rng.randn(d_out) * 0.1).astype(np.float32),
        })
    act = [i for i in range(cfg.num_layers) if cfg.layer_has_activation(i)]
    if cfg.batch_norm:
        params["bn"] = [{"scale": (1 + 0.1 * rng.randn(cfg.sizes[i + 1])).astype(np.float32),
                         "bias": (0.1 * rng.randn(cfg.sizes[i + 1])).astype(np.float32)}
                        for i in act]
        state["bn"] = [{"mean": (0.1 * rng.randn(cfg.sizes[i + 1])).astype(np.float32),
                        "var": (0.5 + rng.rand(cfg.sizes[i + 1])).astype(np.float32)}
                       for i in act]
    if cfg.spectral_norm:
        sn_u = []
        for i in range(cfg.num_layers):
            if cfg.layer_has_sn(i):
                u = rng.randn(cfg.sizes[i + 1]).astype(np.float32)
                sn_u.append(u / np.linalg.norm(u))
            else:
                sn_u.append(None)
        state["sn_u"] = sn_u
    return params, state


@pytest.mark.parametrize("final_linear", [False, True])
@pytest.mark.parametrize("batch_norm,spectral_norm", [
    (False, False), (True, False), (False, True), (True, True),
])
def test_mlp_eval_matches_jax(final_linear, batch_norm, spectral_norm):
    kw = dict(batch_norm=batch_norm, spectral_norm=spectral_norm, leaky_relu_alpha=0.2)
    jcfg = jlinear.MLPConfig.build([24, 16], input_size=10, output_size=6,
                                   final_linear=final_linear, **kw)
    tcfg = tlinear.MLPConfig.build([24, 16], input_size=10, output_size=6,
                                   final_linear=final_linear, **kw)
    assert dataclasses_equal(jcfg, tcfg)
    params, state = _mlp_pytrees(jcfg, seed=3)
    x = np.random.RandomState(4).randn(5, 7, 10).astype(np.float32)

    y_jax, _ = jlinear.mlp_apply(
        jcfg, _to_jnp(params), _to_jnp(state), jnp.asarray(x), train=False
    )
    mlp = tlinear.MLP(tcfg)
    mlp.load_state_dict(mlp_sd_from_jax("", tcfg, params, state), strict=True)
    y_torch = mlp(torch.from_numpy(x))
    np.testing.assert_allclose(y_torch.detach().numpy(), np.asarray(y_jax), **TOL)


def test_mlp_train_mode_waits_for_train_pr():
    mlp = tlinear.MLP(tlinear.MLPConfig.build([8], input_size=4, output_size=2, dropout_p=0.5))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        mlp(torch.zeros(3, 4), train=True)


def test_mlp_init_distribution_matches_linear_init():
    """Uniform(+-1/sqrt(fan_in)) weights and biases, as mpgan_tpu.ops.linear.linear_init."""
    cfg = tlinear.MLPConfig.build([256], input_size=64, output_size=128)
    mlp = tlinear.MLP(cfg, torch.Generator().manual_seed(0))
    for layer, fan_in in zip(mlp.net, (64, 256)):
        bound = 1 / np.sqrt(fan_in)
        w = layer.weight.detach().numpy()
        assert np.abs(w).max() <= bound
        assert abs(w.std() - bound / np.sqrt(3)) < 0.05 * bound


def test_spectral_normalize_matches_jax():
    rng = np.random.RandomState(5)
    w = rng.randn(12, 9).astype(np.float32)
    u = rng.randn(12).astype(np.float32)
    u /= np.linalg.norm(u)
    jw, ju, jv = jsn.spectral_normalize(jnp.asarray(w), jnp.asarray(u))
    tw, tu, tv = tsn.spectral_normalize(torch.from_numpy(w), torch.from_numpy(u))
    for a, b in ((tw, jw), (tu, ju), (tv, jv)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_counts_from_labels_matches_jax():
    rng = np.random.RandomState(6)
    n = 30
    exact = rng.randint(1, n + 1, size=16) / n
    noisy = rng.rand(16)
    labels = np.stack([rng.rand(32), np.concatenate([exact, noisy])], axis=1).astype(np.float32)
    j = np.asarray(jmasking.counts_from_labels(jnp.asarray(labels), n))
    t = tmasking.counts_from_labels(torch.from_numpy(labels), n).numpy()
    np.testing.assert_array_equal(t, j)
    assert t.dtype == np.int32


@pytest.mark.parametrize("ties", [False, True])
def test_mask_from_counts_matches_jax_exactly(ties):
    rng = np.random.RandomState(7)
    x0 = rng.randn(8, 30).astype(np.float32)
    if ties:
        x0 = np.round(x0 * 2) / 2  # many duplicates: ties broken by original index
    njp = rng.randint(0, 30, size=(8,)).astype(np.int32)
    j = np.asarray(jmasking.mask_from_counts(jnp.asarray(x0), jnp.asarray(njp)))
    t = tmasking.mask_from_counts(torch.from_numpy(x0), torch.from_numpy(njp)).numpy()
    np.testing.assert_array_equal(t, j)
    np.testing.assert_array_equal(t[:, :, 0].sum(1), njp + 1)


def test_split_mask_matches_jax():
    x = np.random.RandomState(8).randn(3, 5, 4).astype(np.float32)
    jf, jm = jmasking.split_mask(jnp.asarray(x))
    tf, tm = tmasking.split_mask(torch.from_numpy(x))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))


def _to_jnp(tree):
    if isinstance(tree, dict):
        return {k: _to_jnp(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_jnp(v) for v in tree]
    return None if tree is None else jnp.asarray(tree)


def dataclasses_equal(a, b):
    return dataclasses.asdict(a) == dataclasses.asdict(b)
