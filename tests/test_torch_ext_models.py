"""The PyTorch port's external model families against the JAX package.

Every module gets the JAX module's weights through ``utils.weights.load_jax_trees``
(which flattens the JAX pytrees in ``jax.tree.flatten`` order, so a leaf out of
order would show here as a different output). On the same seeded inputs:

- rGAN G and D, PointNet-Mix D (with and without the mask fix-up), TreeGAN G,
  GraphCNN G (eval and train, its batch-norm running statistics included) and
  PCGAN's latent G and D: outputs, parameter gradients and input gradients
  within 1e-5;
- GraphCNN's neighbour indices exactly, on inputs whose sorted distances are
  clear of ties;
- PCGAN's pre-trained nets through the reference layout: ``G_inv`` for the
  ``max1``, ``max`` and ``mean`` pools and ``G_pc`` on equal point noise, read
  by the JAX package's ``*_weights_from_torch``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one thread a test worker: the suite runs in parallel workers

import jax
import jax.numpy as jnp

from mpgan_tpu.models.ext import graphcnn as jgraphcnn
from mpgan_tpu.models.ext import pcgan as jpcgan
from mpgan_tpu.models.ext import pointnet as jpointnet
from mpgan_tpu.models.ext import rgan as jrgan
from mpgan_tpu.models.ext import treegan as jtreegan
from mpgan_tpu_torch.models.ext import graphcnn as tgraphcnn
from mpgan_tpu_torch.models.ext import pcgan as tpcgan
from mpgan_tpu_torch.models.ext import pointnet as tpointnet
from mpgan_tpu_torch.models.ext import rgan as trgan
from mpgan_tpu_torch.models.ext import treegan as ttreegan
from mpgan_tpu_torch.ops import prng
from mpgan_tpu_torch.utils.weights import jax_leaves, load_jax_trees, tree_leaves

torch.backends.cuda.matmul.allow_tf32 = False
TOL = dict(rtol=1e-5, atol=1e-5)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _pair(jinit, jcls_cfg, tcls, tcfg, seed=0):
    params, state = jinit(jax.random.PRNGKey(seed), jcls_cfg)
    module = load_jax_trees(tcls(tcfg, prng.PRNGKey(seed + 100)),
                            _np(params), _np(state))
    return params, state, module


def _check(japply, params, state, module, x, train=False, check_state=True, null_grads=()):
    """Forward, parameter and input gradients of ``sum(out * w)``. ``null_grads``:
    parameters whose gradient is zero in exact arithmetic (a bias ahead of a
    train-mode batch norm); both packages' rounding residue there must stay
    below 1e-5 of the largest gradient."""
    out_j, new_state = japply(params, state, jnp.asarray(x), train)
    w = np.random.RandomState(1).randn(*np.shape(out_j)).astype(np.float32)

    def loss(p, xx):
        return jnp.sum(japply(p, state, xx, train)[0] * w)

    gp, gx = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    out_t = module(xt, None, train=train)
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j), **TOL)
    (out_t * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), **TOL)
    ours = jax_leaves(module, True)
    theirs = tree_leaves(_np(gp))
    assert len(ours) == len(theirs)
    scale = max(np.abs(g).max() for g in theirs)
    null = {id(t) for t in null_grads}
    for t, g in zip(ours, theirs):
        # a parameter the forward does not read (TreeGAN's last bias) has no grad
        grad = t.grad.numpy() if t.grad is not None else np.zeros_like(g)
        if id(t) in null:
            assert max(np.abs(grad).max(), np.abs(g).max()) < 1e-5 * scale
        else:
            np.testing.assert_allclose(grad, g, **TOL)
    if check_state:
        for t, s in zip(jax_leaves(module, False), tree_leaves(_np(new_state))):
            np.testing.assert_allclose(t.numpy(), s, **TOL)


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


# ---------------------------------------------------------------------------
# rGAN, PointNet, TreeGAN, PCGAN's latent GAN
# ---------------------------------------------------------------------------


def test_rgan_generator_matches_jax():
    cfg = dict(latent_dim=16, fc_layers=(24, 32), num_hits=10, node_feat_size=3)
    p, s, m = _pair(jrgan.rgan_g_init, jrgan.RGANGConfig(**cfg), trgan.RGANGenerator,
                    trgan.RGANGConfig(**cfg))
    jcfg = jrgan.RGANGConfig(**cfg)
    _check(lambda p, s, x, t: jrgan.rgan_g_apply(jcfg, p, s, x, train=t), p, s, m,
           _x(5, 16) * 0.2)
    assert set(m.state_dict()) == {f"model.{i}.{n}" for i in (0, 2, 4) for n in ("weight", "bias")}


@pytest.mark.parametrize("train", [False, True])
def test_rgan_discriminator_matches_jax(train):
    cfg = dict(sfc_layers=(8, 16, 12), fc_layers=(8,), num_hits=10, node_feat_size=3)
    jcfg = jrgan.RGANDConfig(**cfg)
    p, s, m = _pair(jrgan.rgan_d_init, jcfg, trgan.RGANDiscriminator, trgan.RGANDConfig(**cfg))
    _check(lambda p, s, x, t: jrgan.rgan_d_apply(jcfg, p, s, x, train=t), p, s, m,
           np.tanh(_x(4, 10, 3)), train)


@pytest.mark.parametrize("mask", [False, True])
def test_pointnet_discriminator_matches_jax(mask):
    cfg = dict(pointfc_layers=(8, 16), fc_layers=(12,), num_hits=10, node_feat_size=3,
               mask=mask)
    jcfg = jpointnet.PointNetMixDConfig(**cfg)
    p, s, m = _pair(jpointnet.pointnet_d_init, jcfg, tpointnet.PointNetMixDiscriminator,
                    tpointnet.PointNetMixDConfig(**cfg))
    x = np.tanh(_x(4, 10, 3))
    if mask:
        x = np.concatenate([x, np.where(_x(4, 10, 1, seed=2) > 0, 0.5, -0.5)], axis=2)
        x = x.astype(np.float32)
    _check(lambda p, s, x, t: jpointnet.pointnet_d_apply(jcfg, p, s, x, train=t), p, s, m, x)


@pytest.mark.parametrize("degrees", [(2, 2, 2), (4, 2)])
def test_treegan_generator_matches_jax(degrees):
    features = (8, 6, 5, 3)[: len(degrees) + 1]
    cfg = dict(features=features, degrees=degrees, support=3)
    jcfg = jtreegan.TreeGANGConfig(**cfg)
    p, s, m = _pair(jtreegan.treegan_g_init, jcfg, ttreegan.TreeGANGenerator,
                    ttreegan.TreeGANGConfig(**cfg))
    _check(lambda p, s, x, t: jtreegan.treegan_g_apply(jcfg, p, s, x, train=t), p, s, m,
           _x(4, 1, features[0]) * 0.2)
    assert "gcn.TreeGCN_1.W_root.1.weight" in m.state_dict()


@pytest.mark.parametrize("which", ["g", "d"])
def test_pcgan_latent_gan_matches_jax(which):
    jcfg = jpcgan.PCGANConfig(latent_dim=8, z1_dim=12, latent_g_layers=(16, 24),
                              latent_d_layers=(16, 8))
    tcfg = tpcgan.PCGANConfig(latent_dim=8, z1_dim=12, latent_g_layers=(16, 24),
                              latent_d_layers=(16, 8))
    if which == "g":
        init, apply, cls, x = jpcgan.latent_g_init, jpcgan.latent_g_apply, \
            tpcgan.LatentGenerator, _x(5, 8) * 0.2
    else:
        init, apply, cls, x = jpcgan.latent_d_init, jpcgan.latent_d_apply, \
            tpcgan.LatentDiscriminator, _x(5, 12)
    p, s, m = _pair(init, jcfg, cls, tcfg)
    _check(lambda p, s, x, t: apply(jcfg, p, s, x, train=t), p, s, m, x)


# ---------------------------------------------------------------------------
# GraphCNN
# ---------------------------------------------------------------------------


def _graphcnn(num_knn, num_hits=10, final_tanh=False):
    cfg = dict(latent_dim=8, layers=(6, 5), num_hits=num_hits, node_feat_size=3,
               num_knn=num_knn, final_tanh=final_tanh)
    jcfg = jgraphcnn.GraphCNNGANGConfig(**cfg)
    p, s, m = _pair(jgraphcnn.graphcnn_g_init, jcfg, tgraphcnn.GraphCNNGenerator,
                    tgraphcnn.GraphCNNGANGConfig(**cfg))
    return jcfg, p, s, m


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("num_knn,final_tanh", [(4, False), (10, True)], ids=["knn4", "loop"])
def test_graphcnn_generator_matches_jax(train, num_knn, final_tanh):
    """``num_knn == num_hits`` keeps the node among its own neighbours. In train
    mode the batch norm's running statistics move as JAX's new state does; a
    nontrivial running state makes eval mode read it."""
    jcfg, p, s, m = _graphcnn(num_knn, final_tanh=final_tanh)
    rng = np.random.RandomState(3)
    s = {"bn": [{"mean": rng.randn(5).astype(np.float32) * 0.1,
                 "var": (1 + rng.rand(5)).astype(np.float32)},
                {"mean": rng.randn(3).astype(np.float32) * 0.1,
                 "var": (1 + rng.rand(3)).astype(np.float32)}]}
    load_jax_trees(m, _np(p), s)
    _check(lambda p, s, x, t: jgraphcnn.graphcnn_g_apply(jcfg, p, s, x, train=t), p, s, m,
           _x(6, 8) * 0.2, train,
           null_grads=[conv.root.bias for conv in m.layers] if train else ())


def test_graphcnn_knn_indices_match_jax_exactly():
    """The same neighbours, in the same order, on inputs whose sorted
    distances are clear of near-ties (checked here first)."""
    x = _x(8, 12, 5, seed=4)
    d = ((x[:, :, None] - x[:, None]) ** 2).sum(-1)
    gaps = np.diff(np.sort(d + np.eye(12) * 1e10, axis=2)[:, :, :7], axis=2)
    assert gaps.min() > 1e-4
    for k, loop in ((6, False), (12, True)):
        want = np.asarray(jgraphcnn._knn_gather(jnp.asarray(x), k, loop))
        got = tgraphcnn.knn_indices(torch.from_numpy(x), k, loop).numpy()
        np.testing.assert_array_equal(got, want)


def test_graphcnn_state_dict_is_the_modules_own():
    _, _, _, m = _graphcnn(4)
    assert {"dense.weight", "layers.0.nn.weight", "layers.0.root.weight",
            "bn_layers.1.running_var"} <= set(m.state_dict())


# ---------------------------------------------------------------------------
# PCGAN's pre-trained nets, through the reference layout
# ---------------------------------------------------------------------------


def _ref_sd(module):
    return {k: v.detach().numpy() for k, v in module.state_dict().items()}


@pytest.mark.parametrize("pool", ["max1", "max", "mean"])
def test_pcgan_g_inv_matches_jax(pool):
    kw = dict(node_feat_size=3, z1_dim=12, d_dim=16, pool=pool)
    g_inv = tpcgan.GInv(tpcgan.PCGANConfig(**kw), prng.PRNGKey(1))
    jcfg = jpcgan.PCGANConfig(**kw)
    params, state = jpcgan.g_inv_weights_from_torch(_ref_sd(g_inv), jcfg)
    x = np.tanh(_x(5, 10, 3))
    want, _ = jpcgan.g_inv_apply(jcfg, params, state, jnp.asarray(x))
    with torch.no_grad():
        got = g_inv(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    assert ("phi.2.Lambda.weight" in g_inv.state_dict()) == (pool != "max1")


def test_pcgan_g_pc_matches_jax_on_equal_point_noise():
    kw = dict(node_feat_size=3, z1_dim=12, z2_dim=4)
    g_pc = tpcgan.GPc(tpcgan.PCGANConfig(**kw), prng.PRNGKey(2))
    jcfg = jpcgan.PCGANConfig(**kw)
    params, state = jpcgan.g_pc_weights_from_torch(_ref_sd(g_pc), jcfg)
    z1, z2 = _x(5, 1, 12), _x(5, 10, 4, seed=1)
    want, _ = jpcgan.g_pc_apply(jcfg, params, state, jnp.asarray(z1), jnp.asarray(z2))
    with torch.no_grad():
        got = g_pc(torch.from_numpy(z1), torch.from_numpy(z2)).numpy()
    assert got.shape == (5, 10, 3)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
