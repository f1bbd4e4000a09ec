"""The port's attention blocks (``mpgan_tpu_torch.ops.attention``) against the
JAX package's (``mpgan_tpu.ops.attention``) on the CPU: the same numpy inputs
and weights through both, float32, 1e-5. The JAX side runs its packed
(block-diagonal) and its unpacked branch; the port has one branch, which must
equal both. Dropout masks replay the JAX key splits and must be bit-identical.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one thread a test worker: the suite runs in parallel workers

import jax
import jax.numpy as jnp

from mpgan_tpu.ops import attention as jatt
from mpgan_tpu_torch.ops import attention as tatt

from test_torch_ops import port_keys  # the port's keys of a JAX key

TOL = dict(rtol=1e-5, atol=1e-5)


def _mha_pair(e, heads, seed):
    params = jatt.mha_init(jax.random.PRNGKey(seed), e)
    # mha_init leaves the biases at zero; fill them so they are compared
    rs = np.random.RandomState(seed)
    params = dict(params, in_proj_b=jnp.asarray(rs.randn(3 * e).astype(np.float32) * 0.1),
                  out_b=jnp.asarray(rs.randn(e).astype(np.float32) * 0.1))
    m = tatt.MHA(e, heads)
    m.load_state_dict({
        "in_proj_weight": torch.from_numpy(np.array(params["in_proj_w"])),
        "in_proj_bias": torch.from_numpy(np.array(params["in_proj_b"])),
        "out_proj.weight": torch.from_numpy(np.array(params["out_w"])),
        "out_proj.bias": torch.from_numpy(np.array(params["out_b"])),
    })
    return params, m


def _mask(rs, b, n):
    """JetNet mask [B, N, 1]: every jet keeps at least one real particle."""
    counts = rs.randint(1, n + 1, size=b)
    return (np.arange(n)[None, :] < counts[:, None]).astype(np.float32)[..., None]


# (B, Lq, Lk, E, H): B*H and the lengths decide whether JAX packs (_pack_group > 1)
SHAPES = [
    pytest.param(4, 10, 10, 16, 4, True, id="sab-packed"),
    pytest.param(1, 70, 70, 8, 1, False, id="sab-unpacked"),
    pytest.param(3, 1, 12, 16, 2, True, id="pma-packed"),
    pytest.param(1, 1, 130, 8, 1, False, id="pma-unpacked"),
    pytest.param(2, 5, 9, 8, 2, True, id="isab-packed"),
]


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("b, lq, lk, e, heads, packed", SHAPES)
def test_mha_matches_jax(b, lq, lk, e, heads, packed, masked):
    assert (jatt._pack_group(b * heads, lq, lk) > 1) == packed
    rs = np.random.RandomState(lq * 31 + lk)
    params, m = _mha_pair(e, heads, seed=lk)
    q = rs.randn(b, lq, e).astype(np.float32)
    kv = q if lq == lk else rs.randn(b, lk, e).astype(np.float32)
    jmask = tmask = None
    if masked:
        mask = _mask(rs, b, lk)
        jmask = jatt.sab_mask(jnp.asarray(mask), lq)
        tmask = tatt.sab_mask(torch.from_numpy(mask), lq)
        np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    yj = jatt.mha_apply(params, heads, jnp.asarray(q), jnp.asarray(kv), jnp.asarray(kv), jmask)
    tq = torch.from_numpy(q)
    tkv = tq if lq == lk else torch.from_numpy(kv)
    with torch.no_grad():
        yt = m(tq, tkv, tmask)
    assert yt.shape == (b, lq, e)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **TOL)


def test_mha_packed_bias_is_the_same_function():
    """The JAX package hoists a packed additive bias across a SAB stack; the
    port's one branch equals that route too."""
    b, n, e, heads = 4, 10, 16, 4
    rs = np.random.RandomState(3)
    params, m = _mha_pair(e, heads, seed=3)
    x = rs.randn(b, n, e).astype(np.float32)
    mask = _mask(rs, b, n)
    jmask = jatt.sab_mask(jnp.asarray(mask), n)
    pbias = jatt.packed_attn_bias(jmask, heads, n, n)
    assert pbias is not None
    yj = jatt.mha_apply(params, heads, jnp.asarray(x), jnp.asarray(x), jnp.asarray(x), jmask,
                        packed_bias=pbias)
    tx = torch.from_numpy(x)
    with torch.no_grad():
        yt = m(tx, tx, tatt.sab_mask(torch.from_numpy(mask), n))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **TOL)


def test_layer_norm_matches_jax():
    rs = np.random.RandomState(0)
    x = rs.randn(3, 7, 16).astype(np.float32) * 3 + 1
    scale, bias = rs.randn(16).astype(np.float32), rs.randn(16).astype(np.float32)
    yj = jatt.layer_norm(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    yt = tatt.layer_norm(torch.from_numpy(x), torch.from_numpy(scale), torch.from_numpy(bias))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **TOL)


def _mab_pair(cfg_kwargs, seed):
    from mpgan_tpu_torch.models.gapt import GAPTConfig
    from mpgan_tpu_torch.utils.weights import _mab_sd_from_jax

    jcfg = jatt.MABConfig.build(**cfg_kwargs)
    tcfg = tatt.MABConfig.build(**cfg_kwargs)
    params, state = jatt.mab_init(jax.random.PRNGKey(seed), jcfg)
    if jcfg.layer_norm:  # non-trivial LN parameters
        rs = np.random.RandomState(seed)
        for name in ("norm1", "norm2"):
            params[name] = {k: jnp.asarray(rs.randn(jcfg.embed_dim).astype(np.float32))
                            for k in ("scale", "bias")}
    m = tatt.MAB(tcfg)
    # a GAPT config whose mab_cfg() is tcfg, for the weight converter
    la = cfg_kwargs.get("linear_args") or {}
    gcfg = GAPTConfig(num_particles=1, feat_size=1, is_generator=True,
                      embed_dim=tcfg.embed_dim, num_heads=tcfg.num_heads,
                      sab_fc_layers=tuple(cfg_kwargs.get("ff_layers", ())),
                      layer_norm=tcfg.layer_norm, dropout_p=tcfg.dropout_p,
                      linear_args=tuple(la.items()))
    assert gcfg.mab_cfg() == tcfg
    np_tree = jax.tree.map(np.asarray, (params, state))
    m.load_state_dict(_mab_sd_from_jax("", gcfg, *np_tree), strict=True)
    return jcfg, params, state, m


MABS = [
    pytest.param(dict(embed_dim=16, num_heads=4, final_linear=False), False, id="plain"),
    pytest.param(dict(embed_dim=16, num_heads=2, layer_norm=True, ff_layers=[12],
                      final_linear=False), False, id="ln-ff"),
    pytest.param(dict(embed_dim=16, num_heads=4, dropout_p=0.5, final_linear=False,
                      linear_args={"dropout_p": 0.5}), True, id="dropout"),
    pytest.param(dict(embed_dim=8, num_heads=2, layer_norm=True, dropout_p=0.5,
                      final_linear=False, linear_args={"dropout_p": 0.5}), True,
                 id="ln-dropout"),
]


@pytest.mark.parametrize("cross", [False, True], ids=["self", "cross"])
@pytest.mark.parametrize("cfg_kwargs, train", MABS)
def test_mab_matches_jax(cfg_kwargs, train, cross):
    jcfg, params, state, m = _mab_pair(cfg_kwargs, seed=7)
    e = jcfg.embed_dim
    rs = np.random.RandomState(11)
    b, n = 3, 9
    y = rs.randn(b, n, e).astype(np.float32)
    x = rs.randn(b, 4, e).astype(np.float32) if cross else y
    mask = _mask(rs, b, n)
    key = jax.random.PRNGKey(5)
    yj, _ = jatt.mab_apply(jcfg, params, state, jnp.asarray(x), jnp.asarray(y),
                           jatt.sab_mask(jnp.asarray(mask), x.shape[1]), train=train,
                           rng=key if train else None)
    ty = torch.from_numpy(y)
    tx = torch.from_numpy(x) if cross else ty
    with torch.no_grad():
        yt = m(tx, ty, tatt.sab_mask(torch.from_numpy(mask), x.shape[1]), train=train,
               rng=port_keys(key) if train else None)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **TOL)
    if train:
        # the last op is a dropout: the zero patterns are the masks, bit for bit
        zeros_j = np.asarray(yj) == 0
        assert 0.3 < zeros_j.mean() < 0.7
        np.testing.assert_array_equal(yt.numpy() == 0, zeros_j)


def test_mab_dropout_needs_keys():
    _, _, _, m = _mab_pair(dict(embed_dim=8, num_heads=2, dropout_p=0.5, final_linear=False), 0)
    x = torch.zeros(1, 3, 8)
    with pytest.raises(ValueError, match="rng"):
        m(x, x, None, train=True)
