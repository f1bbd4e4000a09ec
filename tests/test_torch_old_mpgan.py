"""The PyTorch port's legacy MPGAN (``old_mpgan``) against the JAX package.

The cards are legacy ones: the MPGAN flags as processed for ``--model mpgan``,
then ``model = "old_mpgan"`` (as the shipped mpfc/mplfc cards carry their mask
flags; the args processing clears ``mask_c`` for any model but MPGAN and GAPT).
Weights go over with ``utils.weights.load_jax_trees``. Generator and
discriminator, eval and train (the JAX key splits replayed), across the mask
options and ``mask_epoch`` 0 and 2 at model epoch 1 (so the second keeps the
masks off): outputs within 1e-5, the generator's mask column bit for bit.

Both paths: the plain one (the JAX module as it is), and the kernel path, the
JAX module's ``mp_layer_apply`` taking ``use_pallas=True`` (its kernels in
interpret mode) against the port's ``use_kernels=True`` (its kernels' plain
versions on the CPU).
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one thread a test worker: the suite runs in parallel workers

import jax
import jax.numpy as jnp

from mpgan_tpu.models import old_mpgan as jold
from mpgan_tpu.ops import mp as jmp
from mpgan_tpu.training import config as jconfig
from mpgan_tpu_torch.models import old_mpgan as told
from mpgan_tpu_torch.models import registry as tregistry
from mpgan_tpu_torch.ops import prng
from mpgan_tpu_torch.training import config as tconfig
from mpgan_tpu_torch.utils.weights import load_jax_trees

from test_torch_ops import port_keys  # the port's keys of a JAX key

torch.backends.cuda.matmul.allow_tf32 = False
TOL = dict(rtol=1e-5, atol=1e-5)
BASE = {"model": "mpgan", "num_hits": 10, "hidden_node_size": 8, "fe": [12, 16], "fn": [16]}

G_CASES = {
    "mask_c": {},
    "lfc": {"lfc": True, "lfc_latent_size": 12},
    "clabels": {"clabels": 1},
    "mask_learn": {"mask_learn": True, "mask_c": False, "fmg": [6]},
    "mask_learn_sigmoid": {"mask_learn": True, "mask_learn_bin": False, "mask_c": False},
    "mask_learn_sep": {"mask_learn_sep": True, "mask_c": False, "fmg": [6]},
    "mask_feat_bin": {"mask_feat_bin": True},
    "mask_fne_np": {"mask_fne_np": True},
    "no_mask": {"mask_c": False},
}
D_CASES = {
    "mask_c": {},
    "no_mask": {"mask_c": False},
    "mean": {"sum": False},
    "no_dea": {"dea": False},
    "mask_fnd_np": {"mask_fnd_np": True},
    "mask_manual": {"mask_manual": True, "mask_c": False},
    "fnd_sn": {"fnd": [8], "spectral_norm_disc": True},
}


def _legacy_args(config, extra):
    args = config.from_args_dict(dict(BASE, **extra))
    args.model = "old_mpgan"
    return args


def _pair(extra, gen, mask_epoch, kernels, seed=0):
    extra = dict(extra, mask_epoch=mask_epoch)
    jcfg = jold.OldMPGANConfig.build(_legacy_args(jconfig, extra), gen=gen)
    tcfg = told.OldMPGANConfig.build(_legacy_args(tconfig, extra), gen=gen)
    params, state = jold.old_mpgan_init(jax.random.PRNGKey(seed), jcfg)
    module = told.OldMPGAN(dataclasses.replace(tcfg, use_kernels=kernels),
                           prng.PRNGKey(seed))
    load_jax_trees(module, jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, state))
    return jcfg, params, state, module


def _labels(b, n, clabels, seed):
    counts = np.random.RandomState(seed).randint(3, n + 1, size=b)
    cols = [np.random.RandomState(seed + 1).rand(b)] * clabels + [counts / n]
    return np.stack(cols, axis=1).astype(np.float32)


@pytest.fixture(params=[False, True], ids=["plain", "kernels"])
def kernels(request, monkeypatch):
    if request.param:
        monkeypatch.setattr(jold, "mp_layer_apply",
                            functools.partial(jmp.mp_layer_apply, use_pallas=True))
    return request.param


def _run(jcfg, params, state, module, x, labels, train, epoch=1):
    key = jax.random.PRNGKey(7)
    want, _ = jold.old_mpgan_apply(jcfg, params, state, jnp.asarray(x),
                                   None if labels is None else jnp.asarray(labels),
                                   train=train, rng=key if train else None, epoch=epoch)
    # update_sn=False: the spectral-norm u stays as loaded, as the JAX state here
    got = module(torch.from_numpy(x), None if labels is None else torch.from_numpy(labels),
                 train=train, rng=port_keys(key) if train else None, epoch=epoch,
                 update_sn=False)
    return np.asarray(want), got.detach().numpy()


@pytest.mark.parametrize("mask_epoch", [0, 2])
@pytest.mark.parametrize("case", list(G_CASES))
def test_generator_matches_jax(kernels, case, mask_epoch):
    extra = G_CASES[case]
    jcfg, params, state, g = _pair(extra, True, mask_epoch, kernels)
    b, n = 5, BASE["num_hits"]
    rng = np.random.RandomState(3)
    if jcfg.lfc:
        x = rng.randn(b, jcfg.lfc_latent_size)
    else:
        x = rng.randn(b, n + int(jcfg.mask.mask_learn_sep), jcfg.first_layer_node_size)
    x = (x * 0.2).astype(np.float32)
    labels = _labels(b, n, extra.get("clabels", 0), 4)
    for train in (False, True):
        want, got = _run(jcfg, params, state, g, x, labels, train)
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, **TOL)
        if want.shape[2] > 3:
            np.testing.assert_array_equal(got[..., 3:], want[..., 3:])
    masked = mask_epoch == 0 and case not in ("no_mask",)
    assert want.shape == (b, n, 4 if masked else 3)


@pytest.mark.parametrize("mask_epoch", [0, 2])
@pytest.mark.parametrize("case", list(D_CASES))
def test_discriminator_matches_jax(kernels, case, mask_epoch):
    extra = D_CASES[case]
    jcfg, params, state, d = _pair(extra, False, mask_epoch, kernels, seed=1)
    b, n = 5, BASE["num_hits"]
    rng = np.random.RandomState(5)
    x = np.tanh(rng.randn(b, n, 3))
    if extra.get("mask_c", True) or extra.get("mask_manual"):
        x = np.concatenate([x, np.where(rng.rand(b, n, 1) < 0.7, 0.5, -0.5)], axis=2)
    x = x.astype(np.float32)
    for train in (False, True):
        want, got = _run(jcfg, params, state, d, x, _labels(b, n, 0, 6), train)
        assert got.shape == want.shape == (b, 1)
        np.testing.assert_allclose(got, want, **TOL)


def test_mask_epoch_switches_the_generator_mask_on():
    """Model epoch 1 < mask_epoch 2: no mask column; epoch 2: the mask."""
    _, _, _, g = _pair({}, True, 2, False)
    x = torch.randn(3, BASE["num_hits"], 8, generator=torch.Generator().manual_seed(0)) * 0.2
    labels = torch.from_numpy(_labels(3, BASE["num_hits"], 0, 1))
    assert g(x, labels, epoch=1).shape[2] == 3
    assert g(x, labels, epoch=2).shape[2] == 4


def test_registry_builds_the_legacy_model():
    args = tconfig.from_args_dict({**BASE, "model": "old_mpgan", "model_D": "old_mpgan",
                                   "lfc": True, "gp": 10.0})
    suite = tregistry.build_suite(args)
    assert suite.g_cls is suite.d_cls is told.OldMPGAN
    assert suite.noise.shape == (args.lfc_latent_size,)
    # the gradient penalty pins the legacy D to the plain path, as the MPGAN D
    assert suite.d_cfg.use_kernels is False and suite.g_cfg.use_kernels is None
