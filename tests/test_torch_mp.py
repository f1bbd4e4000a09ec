"""PyTorch port of dense message passing against the JAX package.

- the kernels' plain versions (``edge_aggregate_reference``,
  ``edge_aggregate_fn_reference``) against the JAX Pallas kernels
  ``mp_pallas.edge_aggregate`` / ``edge_aggregate_fn`` in interpret mode;
- the dense ``mp_layer_apply`` (eval) against JAX ``mp_layer_apply`` with
  ``use_pallas=True`` (interpret) and ``use_pallas=False``.

Inputs come from numpy seeds; tolerance rtol = atol = 1e-5 (float32 sums in
a different order).
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

torch.backends.cuda.matmul.allow_tf32 = False
TOL = dict(rtol=1e-5, atol=1e-5)


def _edge_inputs(n, seed=1, b=2, h1=24, h2=16, h3=12, node=8):
    rng = np.random.RandomState(seed)
    f = lambda *s, scale=1.0: (rng.randn(*s) * scale).astype(np.float32)
    u1, u2 = f(b, n, h1), f(b, n, h1)
    mask = (rng.rand(b, n, 1) > 0.3).astype(np.float32)
    hidden = (f(h1, h2, scale=0.2), f(h2, scale=0.2), f(h2, h3, scale=0.3), f(h3, scale=0.2))
    x = f(b, n, node, scale=0.3)
    fn = (f(h3, 20, scale=0.2), f(node, 20, scale=0.2), f(20, scale=0.1),
          f(20, 5, scale=0.2), f(5, scale=0.1))
    return u1, u2, mask, hidden, x, fn


@pytest.mark.parametrize("sum_agg", [True, False])
@pytest.mark.parametrize("n", [13, 30])
def test_edge_aggregate_reference_matches_pallas(sum_agg, n):
    u1, u2, mask, hidden, _, _ = _edge_inputs(n)
    j = jmpp.edge_aggregate(
        jnp.asarray(u1), jnp.asarray(u2), jnp.asarray(mask), tuple(map(jnp.asarray, hidden)),
        None, 0.2, sum_agg, 32,
    )
    t = tmk.edge_aggregate_reference(
        torch.from_numpy(u1), torch.from_numpy(u2), torch.from_numpy(mask),
        tuple(map(torch.from_numpy, hidden)), 0.2, sum_agg,
    )
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


@pytest.mark.parametrize("final_linear", [True, False])
@pytest.mark.parametrize("sum_agg", [True, False])
@pytest.mark.parametrize("n", [13, 30])
def test_edge_aggregate_fn_reference_matches_pallas(final_linear, sum_agg, n):
    u1, u2, mask, hidden, x, fn = _edge_inputs(n, seed=2)
    j = jmpp.edge_aggregate_fn(
        jnp.asarray(u1), jnp.asarray(u2), jnp.asarray(mask), tuple(map(jnp.asarray, hidden)),
        jnp.asarray(x), tuple(map(jnp.asarray, fn)), 0.2, sum_agg, 32, 0.2, final_linear,
    )
    t = tmk.edge_aggregate_fn_reference(
        torch.from_numpy(u1), torch.from_numpy(u2), torch.from_numpy(mask),
        tuple(map(torch.from_numpy, hidden)), torch.from_numpy(x),
        tuple(map(torch.from_numpy, fn)), 0.2, sum_agg, 0.2, final_linear,
    )
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


def test_wrappers_on_cpu_run_plain_versions_and_count_nothing():
    u1, u2, mask, hidden, x, fn = _edge_inputs(13)
    t = lambda a: torch.from_numpy(a)
    tmk.reset_launch_counts()
    out = tmk.edge_aggregate(t(u1), t(u2), t(mask), tuple(map(t, hidden)), 0.2, True)
    ref = tmk.edge_aggregate_reference(t(u1), t(u2), t(mask), tuple(map(t, hidden)), 0.2, True)
    assert torch.equal(out, ref)
    out = tmk.edge_aggregate_fn(t(u1), t(u2), t(mask), tuple(map(t, hidden)), t(x),
                                tuple(map(t, fn)), 0.2, False, 0.2, True)
    ref = tmk.edge_aggregate_fn_reference(t(u1), t(u2), t(mask), tuple(map(t, hidden)), t(x),
                                          tuple(map(t, fn)), 0.2, False, 0.2, True)
    assert torch.equal(out, ref)
    assert set(tmk.launch_counts.values()) == {0}


def test_kernel_argument_checks_refuse_what_the_kernels_do_not_take():
    """The checks a wrapper runs before it hands pointers to a CUDA kernel."""
    u1, u2, mask, hidden, _, _ = map(
        lambda a: tuple(map(torch.from_numpy, a)) if isinstance(a, tuple) else torch.from_numpy(a),
        _edge_inputs(13),
    )
    pairs = tmk._pairs(hidden)
    assert tmk._check_edge_shapes("k", u1, u2, mask, pairs) == [24, 16, 12]
    with pytest.raises(ValueError, match="do not chain"):
        tmk._check_edge_shapes("k", u1, u2, mask, pairs[::-1])
    with pytest.raises(ValueError, match=r"mask .* must be \[B, N, 1\]"):
        tmk._check_edge_shapes("k", u1, u2, mask[..., 0], pairs)
    with pytest.raises(ValueError, match="cap 256"):
        tmk._chain_dims("k", "fn", [24], [(torch.zeros(24, 300), torch.zeros(300))])
    with pytest.raises(ValueError, match="cap 8"):
        tmk._chain_dims("k", "fn", [4], [(torch.zeros(4, 4), torch.zeros(4))] * 9)
    tmk._check_cuda_args("k", {"u1": u1}, hidden[::2])
    with pytest.raises(TypeError, match="float32"):
        tmk._check_cuda_args("k", {"u1": u1.double()}, ())
    with pytest.raises(ValueError, match="contiguous"):
        tmk._check_cuda_args("k", {"u1": u1.transpose(0, 1)}, ())
    misaligned = torch.zeros(24 * 16 + 1)[1:].view(24, 16)
    with pytest.raises(ValueError, match="16-byte"):
        tmk._check_cuda_args("k", {"w": misaligned}, (misaligned,))


def test_wrappers_reject_devices_without_a_kernel():
    u1, u2, mask, hidden, _, _ = _edge_inputs(13)
    meta = lambda a: torch.empty(a.shape, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        tmk.edge_aggregate(meta(u1), meta(u2), meta(mask), tuple(map(meta, hidden)), 0.2, True)
    with pytest.raises(ValueError, match="different devices"):
        tmk.edge_aggregate(meta(u1), torch.from_numpy(u2), torch.from_numpy(mask),
                           tuple(map(torch.from_numpy, hidden)), 0.2, True)


# ---------------------------------------------------------------------------
# the dense layer
# ---------------------------------------------------------------------------


def _layers(node, fe, fn, out, linear_args=None, **mp_args):
    jcfg = jmp.MPLayerConfig.build(node, fe, fn, out, linear_args=linear_args, **mp_args)
    tcfg = tmp.MPLayerConfig.build(node, fe, fn, out, linear_args=linear_args, **mp_args)
    params, state = jmp.mp_layer_init(jax.random.PRNGKey(0), jcfg)
    params_np = jax.tree.map(np.asarray, params)
    state_np = jax.tree.map(np.asarray, state)
    layer = tmp.MPLayer(tcfg)
    sd = {**mlp_sd_from_jax("fe.", tcfg.fe, params_np["fe"], state_np["fe"]),
          **mlp_sd_from_jax("fn.", tcfg.fn, params_np["fn"], state_np["fn"])}
    layer.load_state_dict(sd, strict=True)
    return jcfg, params, state, layer


def _layer_inputs(n, node=8, b=2, seed=0):
    rng = np.random.RandomState(seed)
    x = (rng.randn(b, n, node) * 0.3).astype(np.float32)
    counts = rng.randint(1, n + 1, size=b)
    mask = (np.arange(n)[None, :] < counts[:, None]).astype(np.float32)[..., None]
    labels = rng.rand(b, 3).astype(np.float32)
    njp = np.array([5.0, 12.0], np.float32)[:b]
    return x, mask, labels, njp


def _apply_both(jcfg, params, state, layer, n, with_mask, use_pallas, **kw):
    x, mask, labels, njp = _layer_inputs(n)
    m = mask if with_mask else None
    yj, _ = jmp.mp_layer_apply(
        jcfg, params, state, jnp.asarray(x), mask=None if m is None else jnp.asarray(m),
        labels=jnp.asarray(labels), num_jet_particles=jnp.asarray(njp), use_pallas=use_pallas,
    )
    yt = tmp.mp_layer_apply(
        layer, torch.from_numpy(x), mask=None if m is None else torch.from_numpy(m),
        labels=torch.from_numpy(labels), num_jet_particles=torch.from_numpy(njp),
        use_kernels=use_pallas, **kw,
    )
    return yt.detach().numpy(), np.asarray(yj)


@pytest.mark.parametrize("with_mask", [True, False])
@pytest.mark.parametrize("sum_agg", [True, False])
@pytest.mark.parametrize("n", [13, 30])
def test_dense_layer_plain_matches_jax_jnp(with_mask, sum_agg, n):
    layers = _layers(8, [24, 16], [32], 8, sum_agg=sum_agg)
    yt, yj = _apply_both(*layers, n, with_mask, use_pallas=False)
    np.testing.assert_allclose(yt, yj, **TOL)


@pytest.mark.parametrize("with_mask", [True, False])
@pytest.mark.parametrize("sum_agg", [True, False])
@pytest.mark.parametrize("n", [13, 30])
def test_dense_layer_kernel_path_matches_jax_pallas(with_mask, sum_agg, n):
    """N <= 64 without conditioning: the K4 gate on both sides."""
    layers = _layers(8, [24, 16], [32], 8, sum_agg=sum_agg)
    yt, yj = _apply_both(*layers, n, with_mask, use_pallas=True)
    np.testing.assert_allclose(yt, yj, **TOL)


@pytest.mark.parametrize("mp_args,linear_args,n", [
    ({"clabels": 2, "mask_fne_np": True}, None, 13),  # conditioning: K2 + fn in torch
    ({}, {"spectral_norm": True}, 13),                  # SN in fn: K2 + fn in torch
    ({"sum_agg": False}, None, 70),                     # N > 64: K2 + fn in torch
])
def test_dense_layer_k2_path_matches_jax_pallas(mp_args, linear_args, n):
    layers = _layers(8, [16, 12], [16], 8, linear_args=linear_args, **mp_args)
    yt, yj = _apply_both(*layers, n, True, use_pallas=True)
    np.testing.assert_allclose(yt, yj, **TOL)


def test_dense_layer_kernel_path_matches_plain_with_fe_batch_norm():
    """fe batch norm is not kernel-eligible: both switches take the plain path."""
    layers = _layers(8, [16, 12], [16], 8, linear_args={"batch_norm": True})
    yt, yj = _apply_both(*layers, 13, True, use_pallas=True)
    np.testing.assert_allclose(yt, yj, **TOL)


@pytest.mark.parametrize("mp_args", [
    {"pos_diffs": True, "delta_coords": True, "all_ef": True},     # dense: built != declared
    {"fully_connected": False, "pos_diffs": True, "delta_coords": True, "delta_r": True},
])
def test_edge_feature_checks_raise_like_jax(mp_args):
    jcfg, params, state, layer = _layers(4, [8], [8], 4, **mp_args)
    x = np.zeros((1, 6, 4), np.float32)
    with pytest.raises(ValueError) as jerr:
        jmp.mp_layer_apply(jcfg, params, state, jnp.asarray(x))
    with pytest.raises(ValueError) as terr:
        tmp.mp_layer_apply(layer, torch.from_numpy(x))
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("mp_args,kw,match", [
    ({"fully_connected": False}, {}, "knn"),
    ({"fully_connected": False}, {"train": True}, "knn"),
])
def test_unported_paths_raise(mp_args, kw, match):
    """No path of the layer is left unported: the knn layer, once refused with
    ``NotImplementedError``, runs (``tests/test_torch_knn.py`` holds it against
    JAX). What it still refuses is a cloud with fewer senders than ``num_knn``
    (default 20), as the JAX package's search does."""
    _, _, _, layer = _layers(4, [8], [8], 4, **mp_args)
    with pytest.raises(ValueError, match=match):
        tmp.mp_layer_apply(layer, torch.zeros(1, 6, 4), **kw)
    y = tmp.mp_layer_apply(layer, torch.zeros(1, 20, 4), **kw)
    assert y.shape == (1, 20, 4) and torch.isfinite(y).all()


@pytest.mark.parametrize("use_pallas", [True, False])
def test_dense_150p_fe128_256_layer_matches_jax(use_pallas):
    """The 150-particle dense ``--fe 128 256`` config's layer (one hidden fe layer,
    128 -> 256; N > 64, so K2 + fn in torch on the kernel path), eval."""
    layers = _layers(8, [128, 256], [32], 8, sum_agg=False)
    yt, yj = _apply_both(*layers, 150, True, use_pallas=use_pallas)
    assert yt.shape == (2, 150, 8)
    np.testing.assert_allclose(yt, yj, **TOL)


# ---------------------------------------------------------------------------
# the forward kernels' plan (csrc/edge_aggregate.cu checks it on the card)
# ---------------------------------------------------------------------------

FE = [96, 160, 192]
FN30 = [224, 256, 256, 3]  # fn of the flagship generator's last layer: [agg | x] -> 3


@pytest.mark.parametrize("batch,n,dims,fn_dims,want", [
    (512, 150, FE, None, (5, 25, 128)),       # 150p dense generation: 125 of 128 rows
    (256, 30, FE, None, (4, 30, 128)),        # the flagship D's K2 in training
    (4096, 30, FE, FN30, (4, 30, 128)),       # 30p generation: 120 of 128 rows
    (4096, 30, FE, [224, 256, 256, 32], (4, 30, 128)),
    (512, 150, [128, 256], None, (5, 25, 128)),  # the --fe 128 256 config
])
def test_forward_plans_at_the_published_widths(batch, n, dims, fn_dims, want):
    plan = tmk.fwd_plan(batch, n, dims, 132, fn_dims)
    assert (plan.ti, plan.jc, plan.rows) == want
    if fn_dims:
        # fn takes all of an item's rows at once: TN = 8 on its 256-wide layers
        assert plan.span % plan.ti == 0 and 96 <= plan.span <= 128
    else:
        assert plan.span == plan.ti
    assert plan.grid == 132 and plan.smem_bytes <= tmk.MAX_SMEM_BYTES


FWD_SHAPES = [
    (1, 30, FE, None), (33, 30, FE, None), (256, 30, FE, None), (1, 150, FE, None),
    (33, 150, FE, None), (16, 150, [128, 256], None), (3, 13, FE, None), (2, 5, [96], None),
    (2, 70, [24, 16], None), (3, 30, [250, 255, 256, 249, 200], None),
    (1, 30, FE, FN30), (33, 30, FE, FN30), (4096, 30, FE, FN30), (7, 64, FE, [224, 64, 5]),
    (4, 150, FE, FN30),
    (2, 45, [64, 256, 224], [256, 256, 8]), (2, 5, [96], [112, 20]), (2, 33, [30, 50, 7], [13, 3]),
]


@pytest.mark.parametrize("sms", [132, 7])
@pytest.mark.parametrize("batch,n,dims,fn_dims", FWD_SHAPES)
def test_forward_plan_covers_every_receiver_once(batch, n, dims, fn_dims, sms):
    plan = tmk.fwd_plan(batch, n, dims, sms, fn_dims)
    assert 1 <= plan.grid <= min(sms, plan.items)
    assert plan.rows in (32, 64, 128) and plan.ti * plan.rs <= plan.rows and plan.jc <= n
    assert plan.smem_bytes == tmk.fwd_smem_bytes(dims, plan.rows, plan.ti, fn_dims)
    assert plan.smem_bytes <= tmk.MAX_SMEM_BYTES
    # the slabs the launcher lays out: the plan's, 16-byte aligned, at least the least
    assert plan.slab_floats == tmk.fwd_slab_floats(dims, plan.rows, plan.ti, fn_dims)
    assert plan.slab_floats % 4 == 0 and plan.slab_floats >= tmk.BWD_SLAB_FLOATS
    if fn_dims:
        # K4: whole blocks of ti an item, fn on all of their rows at once
        assert plan.span % plan.ti == 0 and plan.span <= plan.rows
    else:
        assert plan.span == plan.ti
    # the CTAs' ranges cut the items into contiguous pieces, the items the receivers
    ranges = [plan.item_range(c) for c in range(plan.grid)]
    assert ranges[0][0] == 0 and ranges[-1][1] == plan.items
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert all(lo < hi for lo, hi in ranges)
    seen = np.zeros(batch * n, np.int64)
    for item in range(plan.items):
        recv = plan.item_receivers(item, batch, n)
        assert len(recv) > 0
        seen[recv.start:recv.stop] += 1
    assert (seen == 1).all()


def test_forward_plan_is_memoised_and_shrinks_the_pass_for_wide_chains():
    assert tmk.fwd_plan(256, 30, FE, 132) is tmk.fwd_plan(256, 30, [96, 160, 192], 132)
    # K4 keeps agg^T beside the pass buffer: 512 floats a row do not fit in 128 rows
    plan = tmk.fwd_plan(4096, 30, [256, 256, 256, 256], 132, [256, 256, 3])
    assert plan.rows < 128 and plan.smem_bytes <= tmk.MAX_SMEM_BYTES
    assert tmk.fwd_smem_bytes([256, 256, 256, 256], 128, 4, [256, 256, 3]) > tmk.MAX_SMEM_BYTES


def test_forward_shared_memory_by_hand():
    tab = 96  # the layer table
    # K2 at 128 rows: a_1 (160 wide) over a_0, the 5 x 192 aggregate, 4 row arrays and
    # two slabs of 16384 floats
    assert tmk.fwd_smem_bytes(FE, 128, 5) == 4 * (160 * 132 + 960 + 4 * 132 + tab + 2 * 16384)
    # K4: agg^T (192) beside the pass buffer (160): 352 rows, wider than fn's 256; the
    # least slabs
    assert tmk.fwd_smem_bytes(FE, 128, 4, FN30) == 4 * (352 * 132 + 4 * 132 + tab + 2 * 4096)
    # no hidden layer: the buffer holds a_0
    assert tmk.fwd_smem_bytes([96], 32, 4) == 4 * (96 * 36 + 384 + 4 * 36 + tab + 2 * 16384)
    # a pass buffer too narrow for the last layer's partial sums [2][16][256]: their own region
    assert tmk.fwd_smem_bytes([8, 256], 128, 5) == 4 * (8 * 132 + 1280 + 4 * 132 + tab + 8192
                                                        + 2 * 16384)
    # between: 12288 when 16384 does not fit, 8192 when 12288 does not
    assert tmk.fwd_smem_bytes([96, 192, 192], 128, 5) == 4 * (192 * 132 + 960 + 4 * 132 + tab
                                                              + 2 * 12288)
    assert tmk.fwd_smem_bytes([96, 256, 256], 128, 5) == 4 * (256 * 132 + 1280 + 4 * 132 + tab
                                                              + 2 * 8192)
    # the slab sizes the plans pass to the launcher
    assert tmk.fwd_slab_floats(FE, 128, 5) == 16384
    assert tmk.fwd_slab_floats(FE, 128, 4, FN30) == 4096
    assert tmk.fwd_slab_floats([96, 192, 192], 128, 5) == 12288


def test_forward_packed_weights_by_hand():
    # K, then M padded to the column threads (32 at 128 rows, 128 at 32)
    assert tmk.fwd_packed_floats(FE, 128) == 96 * 160 + 160 * 192
    assert tmk.fwd_packed_floats(FE, 128, FN30) == 96 * 160 + 160 * 192 + 224 * 256 + 256 * 256 \
        + 256 * 32
    assert tmk.fwd_packed_floats([30, 50, 7], 32) == 30 * 128 + 50 * 128
    assert tmk.fwd_packed_floats([96], 128) == 0
