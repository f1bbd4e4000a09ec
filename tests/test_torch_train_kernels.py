"""Train-mode edge kernels of the PyTorch port against the JAX package.

- K1: the port's ``_dropmul`` (the plain version of the in-kernel hash) is bit
  identical to ``mp_pallas._dropmul`` on the dense pair ids;
- K2 in train mode: ``edge_aggregate_reference`` with dropout against
  ``mp_pallas.edge_aggregate`` (interpret mode) within rtol = atol = 1e-5;
- K3: the plain backward ``edge_aggregate_bwd_reference`` and the gradients of
  the ``EdgeAggregate`` Function against ``jax.grad`` of
  ``mp_pallas.edge_aggregate`` within rtol = atol = 1e-4 (a backward sums
  over N^2 pairs in another order);
- the dense MP layer in train mode, on the plain and the kernel path.

Dropout seeds are passed as ``int(np.float32(seed))``: the JAX path rounds its
seed through float32 (``ops/mp.py:376-378``, ``mp_pallas.py:288``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one thread a test worker: the suite runs in parallel workers

import jax
import jax.numpy as jnp

import mpgan_tpu.ops.mp_pallas as jmpp
from mpgan_tpu.ops import mp as jmp
from mpgan_tpu_torch.ops import mp as tmp
from mpgan_tpu_torch.ops import mp_kernels as tmk
from mpgan_tpu_torch.utils.weights import mlp_sd_from_jax

from test_torch_ops import port_keys  # the port's keys of a JAX key

torch.backends.cuda.matmul.allow_tf32 = False
FWD_TOL = dict(rtol=1e-5, atol=1e-5)
BWD_TOL = dict(rtol=1e-4, atol=1e-4)
SEED = int(np.float32(123456789))


def _inputs(n, b=2, widths=(24, 16, 12), seed=1):
    rng = np.random.RandomState(seed)
    f = lambda *s, scale=1.0: (rng.randn(*s) * scale).astype(np.float32)  # noqa: E731
    u1, u2 = f(b, n, widths[0], scale=0.5), f(b, n, widths[0], scale=0.5)
    mask = (rng.rand(b, n, 1) > 0.3).astype(np.float32)
    hidden = []
    for a, c in zip(widths[:-1], widths[1:]):
        hidden += [f(a, c, scale=a ** -0.5), f(c, scale=0.1)]
    g = f(b, n, widths[-1])
    return u1, u2, mask, tuple(hidden), g


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("n", [13, 30, 150])
@pytest.mark.parametrize("salt", [0, 2])
def test_dropmul_bit_identical_to_pallas(n, salt):
    b, cols, p = 2, 20, 0.5
    ids = tmk.pair_ids(b, n, "cpu").reshape(-1, 1)
    t = tmk._dropmul(ids, cols, p, SEED, salt).numpy()
    j = jmpp._dropmul((ids.shape[0], cols), p, jnp.asarray(SEED, jnp.int32), salt, None,
                      ids=jnp.asarray(ids.numpy().astype(np.uint32)))
    np.testing.assert_array_equal(t, np.asarray(j))
    assert abs((t == 0).mean() - p) < 0.02


def test_pair_ids_use_padded_sender_count():
    assert tmk.pad_senders(30) == 32 and tmk.pad_senders(150) == 152 and tmk.pad_senders(8) == 8
    ids = tmk.pair_ids(2, 30, "cpu")[..., 0]
    assert ids[1, 2, 3].item() == 1 * 30 * 32 + 2 * 32 + 3
    assert tmk.dropout_threshold_mult(0.5) == (2**31, 2.0)


@pytest.mark.parametrize("sum_agg", [True, False])
@pytest.mark.parametrize("n", [13, 30])
def test_edge_aggregate_train_reference_matches_pallas(sum_agg, n):
    u1, u2, mask, hidden, _ = _inputs(n)
    j = jmpp.edge_aggregate(jnp.asarray(u1), jnp.asarray(u2), jnp.asarray(mask),
                            tuple(map(jnp.asarray, hidden)), jnp.float32(SEED), 0.2, sum_agg,
                            32, 0.5, True)
    t = tmk.edge_aggregate_reference(_t(u1), _t(u2), _t(mask), tuple(map(_t, hidden)), 0.2,
                                     sum_agg, 0.5, SEED)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **FWD_TOL)


def _jax_grads(u1, u2, mask, hidden, g, sum_agg, dropout_p, need_wgrads):
    def f(u1, u2, mask, hidden):
        out = jmpp.edge_aggregate(u1, u2, mask, hidden, jnp.float32(SEED), 0.2, sum_agg, 32,
                                  dropout_p, need_wgrads)
        return jnp.sum(out * jnp.asarray(g))

    return jax.grad(f, argnums=(0, 1, 2, 3))(
        jnp.asarray(u1), jnp.asarray(u2), jnp.asarray(mask), tuple(map(jnp.asarray, hidden)))


@pytest.mark.parametrize("need_wgrads", [True, False])
@pytest.mark.parametrize("sum_agg", [True, False])
@pytest.mark.parametrize("dropout_p", [0.0, 0.5])
def test_edge_aggregate_bwd_reference_matches_jax_grad(need_wgrads, sum_agg, dropout_p):
    u1, u2, mask, hidden, g = _inputs(13)
    ju1, ju2, jmask, jhidden = _jax_grads(u1, u2, mask, hidden, g, sum_agg, dropout_p,
                                          need_wgrads)
    du1, du2, dmask, dhidden = tmk.edge_aggregate_bwd_reference(
        _t(u1), _t(u2), _t(mask), tuple(map(_t, hidden)), _t(g), 0.2, sum_agg, dropout_p, SEED,
        need_wgrads)
    for a, b in ((du1, ju1), (du2, ju2), (dmask, jmask)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **BWD_TOL)
    for a, b in zip(dhidden, jhidden):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **BWD_TOL)
        if not need_wgrads:
            assert not a.any()


def _function_grads(u1, u2, mask, hidden, g, sum_agg, dropout_p, weights_grad=True):
    ts = [_t(a).requires_grad_() for a in (u1, u2, mask)]
    th = [_t(a).requires_grad_(weights_grad) for a in hidden]
    out = tmk.EdgeAggregate.apply(*ts, 0.2, sum_agg, dropout_p, SEED, *th)
    (out * _t(g)).sum().backward()
    return [t.grad for t in ts], [t.grad for t in th]


@pytest.mark.parametrize("sum_agg", [True, False])
@pytest.mark.parametrize("dropout_p", [0.0, 0.5])
def test_edge_aggregate_function_grads_match_jax(sum_agg, dropout_p):
    u1, u2, mask, hidden, g = _inputs(30)
    jgrads = _jax_grads(u1, u2, mask, hidden, g, sum_agg, dropout_p, True)
    (du1, du2, dmask), dhidden = _function_grads(u1, u2, mask, hidden, g, sum_agg, dropout_p)
    for a, b in zip((du1, du2, dmask, *dhidden), (*jgrads[:3], *jgrads[3])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **BWD_TOL)


def test_edge_aggregate_function_without_weight_grads_counts_nothing():
    """Weights without ``requires_grad`` (the G step through D): the backward
    takes K3 without the weight contractions; inputs' gradients are unchanged."""
    u1, u2, mask, hidden, g = _inputs(13)
    (du1, du2, dmask), _ = _function_grads(u1, u2, mask, hidden, g, True, 0.5)
    (eu1, eu2, emask), wgrads = _function_grads(u1, u2, mask, hidden, g, True, 0.5,
                                                weights_grad=False)
    assert all(w is None for w in wgrads)
    for a, b in ((du1, eu1), (du2, eu2), (dmask, emask)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert set(tmk.launch_counts.values()) == {0}


def test_edge_aggregate_function_is_once_differentiable():
    u1, u2, mask, hidden, _ = _inputs(6)
    x = _t(u1).requires_grad_()
    out = tmk.EdgeAggregate.apply(x, _t(u2), _t(mask), 0.2, True, 0.0, 0, *map(_t, hidden))
    (gx,) = torch.autograd.grad(out.sum(), x, create_graph=True)
    with pytest.raises(RuntimeError):
        gx.sum().backward()


def test_edge_aggregate_bwd_flagship_width_matches_jax_grad():
    u1, u2, mask, hidden, g = _inputs(30, b=2, widths=(96, 160, 192), seed=4)
    jgrads = _jax_grads(u1, u2, mask, hidden, g, True, 0.5, True)
    du1, du2, dmask, dhidden = tmk.edge_aggregate_bwd_reference(
        _t(u1), _t(u2), _t(mask), tuple(map(_t, hidden)), _t(g), 0.2, True, 0.5, SEED)
    for a, b in zip((du1, du2, dmask, *dhidden), (*jgrads[:3], *jgrads[3])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **BWD_TOL)


def test_wrappers_check_dropout_arguments():
    u1, u2, mask, hidden, g = map(lambda a: tuple(map(_t, a)) if isinstance(a, tuple) else _t(a),
                                  _inputs(5))
    with pytest.raises(ValueError, match="outside"):
        tmk.edge_aggregate(u1, u2, mask, hidden, 0.2, True, 1.0, 0)
    with pytest.raises(ValueError, match="seed"):
        tmk.edge_aggregate_bwd(u1, u2, mask, hidden, g, 0.2, True, 0.5, -1)


# ---------------------------------------------------------------------------
# the dense layer in train mode
# ---------------------------------------------------------------------------


def _layer(node, fe, fn, out, linear_args, **mp_args):
    jcfg = jmp.MPLayerConfig.build(node, fe, fn, out, linear_args=linear_args, **mp_args)
    tcfg = tmp.MPLayerConfig.build(node, fe, fn, out, linear_args=linear_args, **mp_args)
    params, state = jmp.mp_layer_init(jax.random.PRNGKey(0), jcfg)
    params_np = jax.tree.map(np.asarray, params)
    state_np = jax.tree.map(np.asarray, state)
    layer = tmp.MPLayer(tcfg)
    layer.load_state_dict({**mlp_sd_from_jax("fe.", tcfg.fe, params_np["fe"], state_np["fe"]),
                           **mlp_sd_from_jax("fn.", tcfg.fn, params_np["fn"], state_np["fn"])},
                          strict=True)
    return jcfg, params, state, layer


@pytest.mark.parametrize("sum_agg", [True, False])
@pytest.mark.parametrize("use_pallas", [True, False])
def test_dense_layer_train_matches_jax(use_pallas, sum_agg):
    """Output and input/weight gradients of one train-mode layer with dropout 0.5."""
    jcfg, params, state, layer = _layer(8, [24, 16], [32], 8, {"dropout_p": 0.5},
                                        sum_agg=sum_agg)
    rng = np.random.RandomState(2)
    n = 13
    x = (rng.randn(2, n, 8) * 0.3).astype(np.float32)
    mask = (np.arange(n)[None, :] < np.array([[9], [13]])).astype(np.float32)[..., None]
    key = jax.random.PRNGKey(7)

    def jf(params, x):
        y, _ = jmp.mp_layer_apply(jcfg, params, state, x, mask=jnp.asarray(mask), train=True,
                                  rng=key, use_pallas=use_pallas)
        return jnp.sum(jnp.sin(y)), y

    (_, yj), (jgp, jgx) = jax.value_and_grad(jf, argnums=(0, 1), has_aux=True)(
        params, jnp.asarray(x))
    tx = _t(x).requires_grad_()
    yt = tmp.mp_layer_apply(layer, tx, mask=_t(mask), train=True, rng=port_keys(key),
                            use_kernels=use_pallas)
    torch.sin(yt).sum().backward()
    np.testing.assert_allclose(yt.detach().numpy(), np.asarray(yj), **FWD_TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), **BWD_TOL)
    for part in ("fe", "fn"):
        for k, lin in enumerate(getattr(layer, part).net):
            np.testing.assert_allclose(lin.weight.grad.numpy(),
                                       np.asarray(jgp[part]["layers"][k]["w"]), **BWD_TOL)
            np.testing.assert_allclose(lin.bias.grad.numpy(),
                                       np.asarray(jgp[part]["layers"][k]["b"]), **BWD_TOL)


# ---------------------------------------------------------------------------
# the backward kernels' plan (pass shape, static schedule, slab sizes)
# ---------------------------------------------------------------------------

FE = [96, 160, 192]
PLAN_CASES = [
    # batch, receivers, senders (knn: k), widths
    (256, 30, 30, FE), (33, 30, 30, FE), (1, 30, 30, FE), (32, 150, 150, FE), (16, 150, 150, FE),
    (160, 150, 20, FE), (128, 150, 20, FE), (1, 150, 20, FE), (8, 150, 20, FE),
    (3, 13, 5, [24, 16, 12]), (2, 70, 33, [30, 50, 7]), (2, 9, 3, [96]), (4, 30, 30, [96, 64]),
    (3, 30, 30, [250, 255, 256, 249, 200]), (2, 40, 40, [13, 9, 11, 5]),
]


@pytest.mark.parametrize("batch,n_recv,n_send,dims", PLAN_CASES)
def test_bwd_plan_fits_and_covers_every_item_once(batch, n_recv, n_send, dims):
    plan = tmk.bwd_plan(batch, n_recv, n_send, dims, 132)
    assert plan.rows in (32, 64, 128) and 1 <= plan.ti * plan.jc <= plan.rows
    assert plan.ti <= n_recv and plan.jc <= n_send
    assert plan.smem_bytes == tmk.bwd_smem_bytes(dims, plan.rows) <= tmk.MAX_SMEM_BYTES
    assert plan.blocks == -(-n_recv // plan.ti) and plan.items == batch * plan.blocks
    assert 1 <= plan.grid <= min(132, plan.items)
    # the ranges tile [0, items) in CTA order, none empty, sizes within one of each other
    ranges = [plan.item_range(c) for c in range(plan.grid)]
    assert ranges[0][0] == 0 and ranges[-1][1] == plan.items
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    sizes = [hi - lo for lo, hi in ranges]
    assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1
    # the owner of an item, as the kernels and the reduction compute it
    for c, (lo, hi) in enumerate(ranges):
        assert plan.item_owner(lo) == c and plan.item_owner(hi - 1) == c
    # every CTA that touches a jet finds a slab
    for b in range(batch):
        touching = {plan.item_owner(t) for t in range(b * plan.blocks, (b + 1) * plan.blocks)}
        assert len(touching) == plan.slabs_of_jet(b) <= plan.slots
        assert touching == set(range(min(touching), max(touching) + 1))


@pytest.mark.parametrize("batch,n_recv,n_send,ti,jc", [
    (256, 30, 30, 4, 30),      # flagship: 120 of 128 pair rows
    (32, 150, 150, 5, 25),     # 150 particles dense: 125 of 128
    (160, 150, 20, 6, 20),     # 150 particles knn-20: 120 of 128
])
def test_bwd_plan_at_the_published_widths(batch, n_recv, n_send, ti, jc):
    plan = tmk.bwd_plan(batch, n_recv, n_send, FE, 132)
    assert (plan.ti, plan.jc, plan.rows, plan.grid) == (ti, jc, 128, 132)
    # a_1 + dz_2 = 352 floats a row, the weight slabs, the row arrays: under 227 KB
    assert plan.smem_bytes == 4 * (352 * 132 + 2 * 4096 + (4 + 10) * 132)


def test_bwd_plan_shrinks_the_pass_for_wide_chains_and_refuses_what_cannot_fit():
    assert tmk.bwd_plan(4, 30, 30, [250, 255, 256, 249, 200], 132).rows == 32
    assert tmk.bwd_smem_bytes([256, 256, 256], 128) > tmk.MAX_SMEM_BYTES
    assert tmk.bwd_smem_bytes([256, 256, 256], 64) <= tmk.MAX_SMEM_BYTES
    assert tmk.bwd_plan(256, 30, 30, [256, 256, 256], 132).rows in (32, 64)
    with pytest.raises(ValueError, match="shared memory"):
        tmk.bwd_plan(4, 30, 30, [256] * 9, 132)


def test_bwd_plan_balances_the_last_round():
    # 150 particles dense at B=32: 960 items of 6 passes on 132 SMs, the busiest CTA 48 passes
    plan = tmk.bwd_plan(32, 150, 150, FE, 132)
    busiest = max(hi - lo for lo, hi in map(plan.item_range, range(plan.grid)))
    assert busiest * -(-150 // plan.jc) == 48
    # knn-20 at B=160: 4,000 items on 132 SMs, 31 passes where 30.3 is the mean
    plan = tmk.bwd_plan(160, 150, 20, FE, 132)
    assert max(hi - lo for lo, hi in map(plan.item_range, range(plan.grid))) == 31


@pytest.mark.parametrize("dims,rows,packed,wslab", [
    (FE, 128, (96 * 5 + 160 * 3 + 160 * 6 + 192 * 5) * 32, 3 * 5 * 1024 + 160 + 5 * 6 * 1024 + 192),
    ([30, 50, 7], 32, (30 * 1 + 50 * 1 + 50 * 1 + 7 * 1) * 128, 2 * 1024 + 52 + 2 * 1024 + 8),
    ([96], 128, 0, 0),
])
def test_bwd_scratch_sizes(dims, rows, packed, wslab):
    assert tmk.bwd_packed_floats(dims, rows) == packed
    assert tmk.bwd_wslab_floats(dims) == wslab
    assert tmk.bwd_wslab_floats(dims, 5) == wslab + 8
