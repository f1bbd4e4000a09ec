"""The port's GAPT (``mpgan_tpu_torch.models.gapt``, ``ops.gapt_kernels``)
against the JAX package's on the CPU: the same numpy noise, labels and weights
through both, float32. Generator and discriminator 1e-4 with the generator's
mask column bit-identical; the fused generator kernel's plain version against
the JAX package's Pallas kernel in interpret mode 2e-5; the gate, the config
functions, the registry and the weight converters.
"""

from __future__ import annotations

import dataclasses
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one thread a test worker: the suite runs in parallel workers

import jax
import jax.numpy as jnp

from mpgan_tpu.models import gapt as jgapt
from mpgan_tpu.models import registry as jregistry
from mpgan_tpu.ops import gapt_pallas as jgp
from mpgan_tpu.training import config as jconfig
from mpgan_tpu_torch.ops import prng
from mpgan_tpu_torch.models import gapt as tgapt
from mpgan_tpu_torch.models import registry as tregistry
from mpgan_tpu_torch.ops import gapt_kernels as gk
from mpgan_tpu_torch.training import config as tconfig
from mpgan_tpu_torch.utils.weights import (
    gapt_discriminator_from_jax,
    gapt_generator_from_jax,
    gapt_generator_to_reference_sd,
    jax_leaves,
)

from test_torch_ops import port_keys  # the port's keys of a JAX key

TOL = dict(rtol=1e-4, atol=1e-4)
DEFAULT = {"model": "gapt"}
NARROW = {"model": "gapt", "num_hits": 9, "gapt_embed_dim": 8, "num_heads": 2,
          "sab_layers_gen": 2, "sab_layers_disc": 2, "use_isab": True, "num_isab_nodes": 3,
          "layer_norm": True, "sab_fc_layers": [12], "final_fc_layers_gen": [6],
          "final_fc_layers_disc": [6], "gapt_mask": False}
CARDS = [pytest.param(DEFAULT, id="default"), pytest.param(NARROW, id="narrow-isab-ln"),
         pytest.param(dict(NARROW, gapt_mask=True, use_isab=False, spectral_norm=True),
                      id="narrow-sn-masked")]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _cfg_fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
            if f.name not in ("use_pallas", "use_kernels")}


def _inputs(n, e, b, seed):
    rs = np.random.RandomState(seed)
    x = (rs.randn(b, n, e) * 0.2).astype(np.float32)
    labels = (rs.randint(1, n + 1, size=(b, 1)) / n).astype(np.float32)
    return x, labels


def _g_pair(card, seed=0):
    jcfg = jconfig.build_gapt(jconfig.from_args_dict(card), gen=True)
    tcfg = tconfig.build_gapt(tconfig.from_args_dict(card), gen=True)
    params, state = jgapt.gapt_g_init(jax.random.PRNGKey(seed), jcfg)
    return jcfg, params, state, gapt_generator_from_jax(_np(params), _np(state), tcfg)


def _d_pair(card, seed=0):
    jcfg = jconfig.build_gapt(jconfig.from_args_dict(card), gen=False)
    tcfg = tconfig.build_gapt(tconfig.from_args_dict(card), gen=False)
    params, state = jgapt.gapt_d_init(jax.random.PRNGKey(seed), jcfg)
    return jcfg, params, state, gapt_discriminator_from_jax(_np(params), _np(state), tcfg)


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("card", CARDS)
def test_generator_matches_jax(card, train):
    card = dict(card, gen_dropout=0.5 if train else 0.0)
    jcfg, params, state, g = _g_pair(card)
    x, labels = _inputs(jcfg.num_particles, jcfg.embed_dim, 3, seed=1)
    key = jax.random.PRNGKey(4)
    yj, _ = jgapt.gapt_g_apply(jcfg, params, state, jnp.asarray(x), jnp.asarray(labels),
                               train=train, rng=key if train else None)
    with torch.no_grad():
        yt = g(torch.from_numpy(x), torch.from_numpy(labels), train=train,
               rng=port_keys(key) if train else None)
    assert yt.shape == (3, jcfg.num_particles, 3 + int(jcfg.use_mask))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **TOL)
    if jcfg.use_mask:
        np.testing.assert_array_equal(yt.numpy()[..., -1], np.asarray(yj)[..., -1])


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("card", CARDS)
def test_discriminator_matches_jax(card, train):
    jcfg, params, state, d = _d_pair(card)
    assert jcfg.dropout_p == 0.5  # the reference's default disc dropout
    n = jcfg.num_particles
    rs = np.random.RandomState(2)
    x = (rs.randn(4, n, 3) * 0.3).astype(np.float32)
    labels = None
    if jcfg.use_mask:
        counts = rs.randint(1, n + 1, size=4)
        mask = (np.arange(n)[None, :] < counts[:, None]).astype(np.float32)[..., None]
        x = np.concatenate([x * mask, mask - 0.5], axis=-1)
        labels = (counts[:, None] / n).astype(np.float32)
    key = jax.random.PRNGKey(6)
    yj, _ = jgapt.gapt_d_apply(jcfg, params, state, jnp.asarray(x),
                               None if labels is None else jnp.asarray(labels), train=train,
                               rng=key if train else None)
    yt = d(torch.from_numpy(x), None if labels is None else torch.from_numpy(labels),
           train=train, rng=port_keys(key) if train else None)
    assert yt.shape == (4, 1)
    np.testing.assert_allclose(yt.detach().numpy(), np.asarray(yj), **TOL)


# tests/test_gapt_pallas.py's shapes, at batches the TPU kernel can block
FUSED_SHAPES = [
    (30, 64, 4, 4, True, 8),    # the jets-default generator
    (30, 64, 4, 4, False, 4),
    (25, 32, 2, 2, True, 10),   # the TPU kernel packs 5 jets
    (100, 32, 4, 1, True, 2),   # no packing on the TPU either
    (30, 64, 4, 2, True, 4),
]


@pytest.mark.parametrize("n, e, h, layers, masked, batch", FUSED_SHAPES)
def test_fused_plain_version_matches_the_pallas_kernel(n, e, h, layers, masked, batch):
    """K9's plain version against ``gapt_g_fused`` in interpret mode."""
    jcfg = jgapt.GAPTConfig(num_particles=n, feat_size=3, is_generator=True, sab_layers=layers,
                            num_heads=h, embed_dim=e, use_mask=masked)
    tcfg = tgapt.GAPTConfig(num_particles=n, feat_size=3, is_generator=True, sab_layers=layers,
                            num_heads=h, embed_dim=e, use_mask=masked, use_kernels=True)
    assert jgp.fused_gapt_eligible(jcfg, False, batch) and gk.fused_gapt_eligible(tcfg, False)
    params, state = jgapt.gapt_g_init(jax.random.PRNGKey(n), jcfg)
    g = gapt_generator_from_jax(_np(params), _np(state), tcfg)
    x, labels = _inputs(n, e, batch, seed=n)
    x = x * 5  # unit-scale noise, as in tests/test_gapt_pallas.py
    jmask = None
    if masked:
        njp = jgapt.counts_from_labels(jnp.asarray(labels), n)
        jmask = jgapt.mask_from_counts(jnp.asarray(x)[:, :, 0], njp)
    yj = jgp.gapt_g_fused(jcfg, params, jnp.asarray(x), jmask)
    before = dict(gk.launch_counts)
    with torch.no_grad():
        yt = g(torch.from_numpy(x), torch.from_numpy(labels))
        g.cfg = dataclasses.replace(tcfg, use_kernels=False)
        y_plain_path = g(torch.from_numpy(x), torch.from_numpy(labels))
    assert dict(gk.launch_counts) == before  # no kernel launch is counted on the CPU
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(yt.numpy(), y_plain_path.numpy(), rtol=2e-5, atol=2e-5)
    if masked:
        np.testing.assert_array_equal(yt.numpy()[..., -1], np.asarray(yj)[..., -1])


def test_fused_wrapper_is_eval_only_and_checks_shapes():
    tcfg = tgapt.GAPTConfig(num_particles=5, feat_size=3, is_generator=True, sab_layers=1,
                            num_heads=2, embed_dim=8, use_kernels=True)
    g = tgapt.GAPTGenerator(tcfg, prng.PRNGKey(0))
    w = g.fused_weights()
    assert g.fused_weights() is w  # cached until a parameter changes
    x = torch.zeros(2, 5, 8)
    with pytest.raises(RuntimeError, match="eval only"):
        gk.gapt_g_fused(x.requires_grad_(), None, w, 2, 0.2)
    with torch.no_grad():
        with pytest.raises(ValueError, match="heads"):
            gk.gapt_g_fused(x, None, w, 3, 0.2)
        with pytest.raises(ValueError, match="mask"):
            gk.gapt_g_fused(x, torch.ones(2, 5), w, 2, 0.2)
        g.final_fc.net[0].bias.add_(1.0)
    assert g.fused_weights() is not w
    # with gradients enabled the model takes the plain path instead of the kernel
    labels = torch.full((2, 1), 0.6)
    y = g(torch.randn(2, 5, 8), labels)
    assert y.requires_grad


GATE_GRID = list(itertools.product(
    (True, False),                       # is_generator
    (False, True),                       # train
    ({}, {"use_isab": True}, {"layer_norm": True}, {"sab_fc_layers": (16,)},
     {"final_fc_layers": (8,)}, {"linear_args": (("batch_norm", True),)},
     {"linear_args": (("spectral_norm", True),)}, {"num_heads": 3},
     {"num_particles": 512}, {"num_particles": 513}, {"num_particles": 150}),
))


@pytest.mark.parametrize("is_generator, train, override", GATE_GRID)
def test_gate_matches_jax(is_generator, train, override):
    """``fused_gapt_eligible`` agrees with the JAX package's gate at a batch the
    TPU kernel can always block (its batch condition is not carried over)."""
    base = dict(num_particles=30, feat_size=3, is_generator=is_generator, sab_layers=2,
                num_heads=4, embed_dim=64)
    base.update(override)
    n = base["num_particles"]
    batch = max(1, 128 // n) * 8
    want = jgp.fused_gapt_eligible(jgapt.GAPTConfig(**base), train, batch)
    assert gk.fused_gapt_eligible(tgapt.GAPTConfig(**base), train) == want
    # and an odd batch, which the TPU kernel refuses at N=30, does not matter here
    assert gk.fused_gapt_eligible(tgapt.GAPTConfig(**base), train) == want


@pytest.mark.parametrize("card", CARDS + [pytest.param(
    {"model": "gapt", "num_hits": 150, "gen_dropout": 0.1, "layer_norm_gen": True},
    id="150p")])
def test_build_gapt_and_registry_match_jax(card):
    jargs, targs = jconfig.from_args_dict(card), tconfig.from_args_dict(card)
    for gen in (True, False):
        assert _cfg_fields(tconfig.build_gapt(targs, gen)) == \
            _cfg_fields(jconfig.build_gapt(jargs, gen))
    jsuite, tsuite = jregistry.build_suite(jargs), tregistry.build_suite(targs)
    assert (tsuite.model, tsuite.model_d) == (jsuite.model, jsuite.model_d) == ("gapt", "gapt")
    assert _cfg_fields(tsuite.g_cfg) == _cfg_fields(jsuite.g_cfg)
    assert _cfg_fields(tsuite.d_cfg) == _cfg_fields(jsuite.d_cfg)
    assert tsuite.noise.shape == jsuite.noise.shape and tsuite.noise.std == jsuite.noise.std
    assert isinstance(tsuite.generator(), tgapt.GAPTGenerator)
    assert isinstance(tsuite.discriminator(), tgapt.GAPTDiscriminator)


def test_registry_builds_mpgan_and_refuses_the_rest():
    """The registry builds MPGAN's pair and, since the model zoo is ported, every
    generator and discriminator family the JAX registry builds, in any pair:
    the module classes, and a generator whose output has the noise spec's batch."""
    from mpgan_tpu_torch.models.mpgan import MPDiscriminator, MPGenerator

    suite = tregistry.build_suite(tconfig.from_args_dict(
        {"model": "mpgan", "num_hits": 8, "hidden_node_size": 8, "fe": [8], "fn": [8]}))
    assert isinstance(suite.generator(), MPGenerator)
    assert isinstance(suite.discriminator(), MPDiscriminator)
    assert suite.noise.shape == (8, 8)
    small = {"num_hits": 8, "hidden_node_size": 8, "fe": [8], "fn": [8], "rgang_fc": [8],
             "pointnetd_pointfc": [8], "pointnetd_fc": [8], "graphcnng_layers": [4],
             "treegang_features": [8, 3], "treegang_degrees": [8], "gapt_embed_dim": 8,
             "num_heads": 2, "pcgan_z1_dim": 8, "pcgan_d_dim": 8}
    for model in ("rgan", "graphcnngan", "treegan", "pcgan", "old_mpgan", "mpgan", "gapt"):
        for model_d in ("rgan", "pointnet", "pcgan", "old_mpgan", "mpgan", "gapt"):
            # GraphCNN's preset searches 20 neighbours
            n = 24 if model == "graphcnngan" else 8
            suite = tregistry.build_suite(tconfig.from_args_dict(
                dict(small, model=model, model_D=model_d, num_hits=n)))
            assert (suite.model, suite.model_d) == (model, model_d)
            g, d = suite.generator(), suite.discriminator()
            assert isinstance(g, torch.nn.Module) and isinstance(d, torch.nn.Module)
            noise = suite.noise.sample(prng.PRNGKey(0), 2, "cpu")
            assert g(noise, torch.full((2, 1), 0.5)).shape[0] == 2


@pytest.mark.parametrize("card", CARDS)
def test_weights_there_and_back(card):
    """JAX pytrees -> module -> the JAX flatten order gives back every leaf; the
    reference-layout state dict round-trips through torch.save's format."""
    for pair, init in ((_g_pair, jgapt.gapt_g_init), (_d_pair, jgapt.gapt_d_init)):
        jcfg, params, state, m = pair(card, seed=3)
        for tree, is_params in ((params, True), (state, False)):
            leaves = jax.tree.leaves(tree)
            ours = jax_leaves(m, is_params)
            assert len(ours) == len(leaves)
            for t, leaf in zip(ours, leaves):
                np.testing.assert_array_equal(t.detach().numpy(), np.asarray(leaf))
        sd = gapt_generator_to_reference_sd(m)
        assert set(sd) == set(m.state_dict())
        other = type(m)(m.cfg, prng.PRNGKey(9))
        other.load_state_dict(sd, strict=True)
        for a, b in zip(jax_leaves(other, True), jax_leaves(m, True)):
            assert torch.equal(a, b)


def test_reference_state_dict_names():
    """The keys the reference's GAPT checkpoints carry
    (``mpgan_tpu/utils/torch_import.py:114-151``)."""
    g = tregistry.build_suite(tconfig.from_args_dict(DEFAULT)).generator()
    keys = set(g.state_dict())
    assert len(keys) == 26
    for i in range(4):
        for leaf in ("attention.in_proj_weight", "attention.in_proj_bias",
                     "attention.out_proj.weight", "attention.out_proj.bias",
                     "ff.net.0.weight", "ff.net.0.bias"):
            assert f"sabs.{i}.mab.{leaf}" in keys
    assert {"final_fc.net.0.weight", "final_fc.net.0.bias"} <= keys
    d = tregistry.build_suite(tconfig.from_args_dict(dict(NARROW, use_isab=True))).discriminator()
    keys = set(d.state_dict())
    assert {"pma.S", "pma.mab.attention.in_proj_weight", "pma.mab.norm1.weight",
            "input_embedding.net.0.weight", "sabs.0.I", "sabs.1.mab0.norm2.bias",
            "sabs.0.mab1.ff.net.1.weight", "final_fc.net.1.bias"} <= keys
