"""The PyTorch port's MPGAN generator against the JAX package (the slice as a whole).

The same weights (JAX init, carried over by ``mp_generator_from_jax``), noise
and labels go through ``mp_generator_apply`` and the port's ``MPGenerator``.
Tolerance rtol = atol = 1e-4 (two message-passing layers of float32 sums in a
different order, then tanh); the mask column is bit-identical.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from mpgan_tpu.models.mpgan import mp_generator_apply, mp_generator_init
from mpgan_tpu.training import config as jconfig
from mpgan_tpu_torch.training import config as tconfig
from mpgan_tpu_torch.utils.weights import mp_generator_from_jax

torch.backends.cuda.matmul.allow_tf32 = False
TOL = dict(rtol=1e-4, atol=1e-4)

NARROW = {"hidden_node_size": 16, "fe": [24, 16], "fn": [32]}


def _pair(card, seed=0):
    jcfg = jconfig.build_mpgan_generator(jconfig.from_args_dict(card))
    tcfg = tconfig.build_mpgan_generator(tconfig.from_args_dict(card))
    params, state = mp_generator_init(jax.random.PRNGKey(seed), jcfg)
    g = mp_generator_from_jax(
        jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, state), tcfg
    )
    return jcfg, params, state, g


def _inputs(cfg, b, seed=3):
    rng = np.random.RandomState(seed)
    n = cfg.num_particles
    if cfg.lfc:
        shape = (b, cfg.lfc_latent_size)
    else:
        shape = (b, n + int(cfg.mask.mask_learn_sep), cfg.input_node_size)
    noise = (rng.randn(*shape) * 0.2).astype(np.float32)
    labels = (rng.randint(1, n + 1, size=b) / n)[:, None].astype(np.float32)
    return noise, labels


def _compare(jcfg, params, state, g, b, use_pallas, use_kernels):
    noise, labels = _inputs(jcfg, b)
    yj, _ = mp_generator_apply(
        dataclasses.replace(jcfg, use_pallas=use_pallas), params, state,
        jnp.asarray(noise), jnp.asarray(labels),
    )
    g.cfg = dataclasses.replace(g.cfg, use_kernels=use_kernels)
    with torch.inference_mode():
        yt = g(torch.from_numpy(noise), torch.from_numpy(labels)).numpy()
    yj = np.asarray(yj)
    assert yt.shape == yj.shape
    np.testing.assert_allclose(yt, yj, **TOL)
    if jcfg.mask.use_mask_gen:
        np.testing.assert_array_equal(yt[..., -1], yj[..., -1])
    return yt


@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("num_hits", [20, 30])
def test_generator_matches_jax_pallas_narrow(use_kernels, num_hits):
    """JAX through its Pallas kernels (interpret); the port through its kernel
    path (the kernels' plain versions on the CPU) and its plain path."""
    jcfg, params, state, g = _pair({"model": "mpgan", "num_hits": num_hits, **NARROW})
    y = _compare(jcfg, params, state, g, 4, use_pallas=True, use_kernels=use_kernels)
    assert y.shape == (4, num_hits, 4)


def test_generator_matches_jax_flagship_width():
    """Full flagship width (fe [96,160,192], fn [256,256], hidden 32), 30p, B=4,
    against the JAX jnp path."""
    jcfg, params, state, g = _pair({"model": "mpgan", "jets": "g", "num_hits": 30})
    assert [l.fe.sizes for l in g.cfg.layers] == [(64, 96, 160, 192)] * 2
    assert g.cfg.layers[1].fn.sizes == (224, 256, 256, 3)
    y = _compare(jcfg, params, state, g, 4, use_pallas=False, use_kernels=True)
    mask = y[..., -1] + 0.5
    noise, labels = _inputs(jcfg, 4)
    np.testing.assert_array_equal(mask.sum(1), np.round(labels[:, 0] * 30))


@pytest.mark.parametrize("extra", [
    {"lfc": True, "lfc_latent_size": 24},
    {"mask_c": False, "mask_learn": True, "fmg": [8]},
    {"mask_c": False, "mask_learn_sep": True, "fmg": [8]},
    {"mask_c": False, "mask_feat_bin": True, "node_feat_size": 4},
    {"clabels": 1, "mask_fne_np": True},
    {"spectral_norm": True},
    {"sum": False, "mp_iters": 3},
])
def test_generator_variants_match_jax_jnp(extra):
    jcfg, params, state, g = _pair({"model": "mpgan", "num_hits": 12, **NARROW, **extra})
    _compare(jcfg, params, state, g, 3, use_pallas=False, use_kernels=True)


@pytest.mark.parametrize("card", [
    {"model": "mpgan"},
    {"model": "mpgan", "num_hits": 150, "jets": "t", "batch_size": 0},
    {"model": "mpgan", "lx": True, "n": True},
    {"model": "mpgan", "latent_node_size": 2},
    {"model": "mpgan", "mask_c": False, "noise_padding": True},
    {"model": "gapt"},
])
def test_args_processing_matches_jax(card):
    """The same card gives the same Args dict, or the same ArgsError."""
    try:
        j = jconfig.from_args_dict(card).to_dict()
    except jconfig.ArgsError as e:
        with pytest.raises(tconfig.ArgsError, match=str(e)):
            tconfig.from_args_dict(card)
        return
    assert tconfig.from_args_dict(card).to_dict() == j
