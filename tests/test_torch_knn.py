"""The PyTorch port's knn message-passing layer against the JAX package.

- K1 on the knn pair ids: the port's ``_dropmul`` is bit identical to
  ``mp_pallas._dropmul``;
- the search: ``knn_select_reference`` against ``knn_pallas.knn_select``
  (interpret mode), ``idx`` equal except near-tie rows, which
  ``compare_neighbours`` counts and bounds;
- K5: ``knn_fused_layer_reference`` against ``knn_pallas.knn_fused_layer``
  (interpret mode), eval and with dropout 0.5, within rtol = atol = 1e-5 on the
  receiver rows whose neighbours agree;
- K6: ``knn_edge_aggregate_bwd_reference`` and the ``KnnFusedLayer`` Function
  against ``jax.grad`` of ``knn_pallas.knn_fused_layer`` within 1e-4;
- the knn ``mp_layer_apply``: the plain path against JAX
  ``use_pallas=False``, the kernel path against ``use_pallas=True`` (the
  Pallas kernels in interpret mode), eval and train;
- a knn generator, and the refusals.

Inputs come from numpy seeds; narrow widths, N in {13, 20}, k = 5 (interpret
mode is slow). Jets carry fewer real particles than N, some fewer than k + 1.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one thread a test worker: the suite runs in parallel workers

import jax
import jax.numpy as jnp

import mpgan_tpu.ops.knn_pallas as jknn
import mpgan_tpu.ops.mp_pallas as jmpp
from mpgan_tpu.models.mpgan import mp_generator_apply, mp_generator_init
from mpgan_tpu.ops import mp as jmp
from mpgan_tpu.training import config as jconfig
from mpgan_tpu_torch.ops import knn_kernels as tkk
from mpgan_tpu_torch.ops import mp as tmp
from mpgan_tpu_torch.ops import mp_kernels as tmk
from mpgan_tpu_torch.training import config as tconfig
from mpgan_tpu_torch.utils.weights import mlp_sd_from_jax, mp_generator_from_jax

from test_torch_ops import port_keys  # the port's keys of a JAX key

torch.backends.cuda.matmul.allow_tf32 = False
FWD_TOL = dict(rtol=1e-5, atol=1e-5)
BWD_TOL = dict(rtol=1e-4, atol=1e-4)
SEED = int(np.float32(123456789))
K = 5
# the share of receiver rows that may differ from the JAX search at a near-tie
MAX_DIFFERING_SHARE = 0.01


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _inputs(n, b=3, c=8, widths=(24, 16, 12), seed=1, masked=True):
    """Operands of the fused layer: jet 0 is full, the others hold fewer real
    particles than N, the last fewer than k + 1."""
    rng = np.random.RandomState(seed)
    f = lambda *s, scale=1.0: (rng.randn(*s) * scale).astype(np.float32)  # noqa: E731
    x = f(b, n, c, scale=0.3)
    counts = np.array([n, n // 2, 3][:b])
    mask = (np.arange(n)[None, :] < counts[:, None]).astype(np.float32)[..., None]
    if not masked:
        mask = np.ones_like(mask)
    xf = ((1 - 1e4) * mask + 1e4) * x
    h1 = widths[0]
    u1, u2 = f(b, n, h1, scale=0.5), f(b, n, h1, scale=0.5)
    u2m = np.concatenate([u2, mask], axis=-1)
    hidden = []
    for a, w in zip(widths[:-1], widths[1:]):
        hidden += [f(a, w, scale=a ** -0.5), f(w, scale=0.1)]
    return dict(xs=x, xf=xf.astype(np.float32), u1=u1, u2m=u2m, w_d=f(h1, scale=0.3),
                hidden=tuple(hidden), g=f(b, n, widths[-1]), mask=mask)


def _jax_fused(d, self_loops, want_dists, sum_agg, dropout_p, emit_idx=True):
    """The Pallas forward in interpret mode; ``idx``/``dists`` come back
    neighbour-major over padded receivers and are returned as ``[B, N, k]``."""
    b, n, _ = d["xs"].shape
    agg, idx_t, dists_t = jknn._fused_impl_v4(
        _j(d["xs"]), _j(d["xf"]), _j(d["u1"]), _j(d["u2m"]), _j(d["w_d"]) if want_dists else None,
        jknn._weights_list(tuple(map(_j, d["hidden"]))),
        jnp.float32(SEED) if dropout_p > 0 else None, k=K, self_loops=self_loops,
        want_dists=want_dists, alpha=0.2, sum_agg=sum_agg, dropout_p=dropout_p,
        emit_idx=emit_idx)
    np8 = (n + 7) // 8 * 8
    unpack = lambda t: np.swapaxes(np.asarray(t).reshape(b, K, np8)[:, :, :n], 1, 2)  # noqa: E731
    return (np.asarray(agg), None if idx_t is None else unpack(idx_t),
            None if dists_t is None else unpack(dists_t))


def _agreeing_rows(d, idx_t, idx_j):
    """Receiver rows whose neighbours agree with the JAX search, after the
    near-tie accounting: no differing row may be further than one bucket step,
    and the share of differing rows is bounded."""
    keys = tkk.knn_keys(_t(d["xs"]), _t(d["xf"]))
    agree, differing, bad = tkk.compare_neighbours(
        _t(np.asarray(idx_t)), _t(np.asarray(idx_j).astype(np.int32)), keys, _t(d["mask"]))
    assert bad == 0
    assert differing <= MAX_DIFFERING_SHARE * agree.numel()
    return agree.numpy()


# ---------------------------------------------------------------------------
# K1 on the knn ids, and the search
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [13, 20])
@pytest.mark.parametrize("salt", [0, 2])
def test_knn_dropmul_bit_identical_to_pallas(n, salt):
    b, cols, p = 3, 20, 0.5
    ids = tkk.knn_pair_ids(b, n, K, "cpu").reshape(-1, 1)
    assert ids[(1 * n + 2) * K + 3, 0].item() == 1 * n * K + 2 * K + 3
    t = tmk._dropmul(ids, cols, p, SEED, salt).numpy()
    j = jmpp._dropmul((ids.shape[0], cols), p, jnp.asarray(SEED, jnp.int32), salt, None,
                      ids=jnp.asarray(ids.numpy().astype(np.uint32)))
    np.testing.assert_array_equal(t, np.asarray(j))
    assert abs((t == 0).mean() - p) < 0.03


@pytest.mark.parametrize("self_loops", [True, False])
@pytest.mark.parametrize("n,c", [(13, 8), (20, 3), (150, 8)])
def test_knn_select_reference_matches_pallas_select(self_loops, n, c):
    d = _inputs(n, c=c, seed=n)
    idx_j = jknn.knn_select(_j(d["xs"]), _j(d["xf"]), K, self_loops)
    idx_t = tkk.knn_select_reference(_t(d["xs"]), _t(d["xf"]), K, self_loops)
    assert idx_t.dtype == torch.int32 and idx_t.shape == (3, n, K)
    agree = _agreeing_rows(d, idx_t, idx_j)
    assert agree.mean() >= 1 - MAX_DIFFERING_SHARE
    # in ascending key order: the extraction rank is part of the dropout id
    keys = tkk.knn_keys(_t(d["xs"]), _t(d["xf"]))
    picked = torch.gather(keys, 2, idx_t.long())
    assert (picked[..., 1:] > picked[..., :-1]).all()


def test_knn_keys_pack_the_sender_index_under_the_distance():
    d = _inputs(20)
    keys = tkk.knn_keys(_t(d["xs"]), _t(d["xf"]))
    assert tkk.key_bits(20) == 8 and tkk.key_bits(150) == 8 and tkk.key_bits(300) == 9
    assert torch.equal(keys & 255, torch.arange(20, dtype=torch.int32).expand(3, 20, 20))
    assert (keys >= 0).all()
    # an unmasked receiver is its own nearest sender; a masked one is not
    first = tkk.knn_select_reference(_t(d["xs"]), _t(d["xf"]), 1, True)[..., 0]
    real = _t(d["mask"])[..., 0] > 0
    own = torch.arange(20).expand(3, 20)
    assert torch.equal(first[real].long(), own[real])
    assert not (first[~real].long() == own[~real]).any()


def test_compare_neighbours_counts_and_bounds_swaps():
    d = _inputs(20)
    xs, xf, mask = _t(d["xs"]), _t(d["xf"]), _t(d["mask"])
    keys = tkk.knn_keys(xs, xf)
    idx = tkk.knn_select_reference(xs, xf, K, True)
    agree, differing, bad = tkk.compare_neighbours(idx, idx, keys, mask)
    assert agree.all() and differing == 0 and bad == 0
    far = idx.clone()
    far[0, 0, 0] = torch.argmax(keys[0, 0])  # the farthest sender: no near-tie
    agree, differing, bad = tkk.compare_neighbours(far, idx, keys, mask)
    assert differing == 1 and bad == 1 and not agree[0, 0] and agree[0, 1:].all()
    # masked senders picked in another order do not count (jet 2 has 3 real particles)
    masked = idx.clone()
    masked[2, 0, 3:] = idx[2, 0, 3:].flip(0)
    assert tkk.compare_neighbours(masked, idx, keys, mask)[1] == 0
    assert tkk.compare_neighbours(masked, idx, keys)[1] == 1


# ---------------------------------------------------------------------------
# K5 and K6: the plain versions against the Pallas kernels
# ---------------------------------------------------------------------------

CASES = [  # pos_diffs, self_loops, masked: tests/test_knn_pallas.py's three, and one more
    (False, True, True), (True, True, False), (True, False, True), (False, False, False),
]


@pytest.mark.parametrize("dropout_p", [0.0, 0.5])
@pytest.mark.parametrize("sum_agg", [True, False])
@pytest.mark.parametrize("pos_diffs,self_loops,masked", CASES)
@pytest.mark.parametrize("n", [13, 20])
def test_knn_fused_layer_reference_matches_pallas(n, pos_diffs, self_loops, masked, sum_agg,
                                                  dropout_p):
    d = _inputs(n, masked=masked, seed=n + 2)
    agg_j, idx_j, dists_j = _jax_fused(d, self_loops, pos_diffs, sum_agg, dropout_p)
    agg_t, idx_t, dists_t = tkk.knn_fused_layer_reference(
        _t(d["xs"]), _t(d["xf"]), _t(d["u1"]), _t(d["u2m"]), _t(d["w_d"]) if pos_diffs else None,
        tuple(map(_t, d["hidden"])), K, self_loops, pos_diffs, 0.2, sum_agg, dropout_p, SEED,
        emit_idx=True)
    rows = _agreeing_rows(d, idx_t, idx_j)
    np.testing.assert_allclose(agg_t.numpy()[rows], agg_j[rows], **FWD_TOL)
    if pos_diffs:
        live = (np.take_along_axis(d["mask"][:, None, :, 0].repeat(n, 1), idx_j, 2) > 0)
        live &= rows[..., None]
        np.testing.assert_allclose(dists_t.numpy()[live], dists_j[live], **FWD_TOL)
    else:
        assert dists_t is None and dists_j is None


def test_knn_fused_layer_reference_returns_no_residuals_unless_asked():
    d = _inputs(13)
    args = (_t(d["xs"]), _t(d["xf"]), _t(d["u1"]), _t(d["u2m"]), _t(d["w_d"]),
            tuple(map(_t, d["hidden"])), K, True, True, 0.2, True)
    agg, idx, dists = tkk.knn_fused_layer_reference(*args)
    assert idx is None and dists is None
    agg2, idx, dists = tkk.knn_fused_layer_reference(*args, emit_idx=True)
    assert torch.equal(agg, agg2) and idx.shape == dists.shape == (3, 13, K)


def _jax_grads(d, self_loops, want_dists, sum_agg, dropout_p, need_wgrads):
    def f(xs, xf, u1, u2m, w_d, hidden):
        out = jknn.knn_fused_layer(xs, xf, u1, u2m, w_d, hidden,
                                   jnp.float32(SEED) if dropout_p > 0 else None, K, self_loops,
                                   want_dists, 0.2, sum_agg, dropout_p, need_wgrads)
        return jnp.sum(out * jnp.asarray(d["g"]))

    argnums = (0, 1, 2, 3, 4, 5) if want_dists else (2, 3, 5)
    grads = jax.grad(f, argnums=argnums)(
        _j(d["xs"]), _j(d["xf"]), _j(d["u1"]), _j(d["u2m"]), _j(d["w_d"]) if want_dists else None,
        tuple(map(_j, d["hidden"])))
    if not want_dists:
        grads = (None, None, grads[0], grads[1], None, grads[2])
    return grads


@pytest.mark.parametrize("need_wgrads", [True, False])
@pytest.mark.parametrize("sum_agg", [True, False])
@pytest.mark.parametrize("dropout_p", [0.0, 0.5])
@pytest.mark.parametrize("pos_diffs,self_loops,masked", CASES[:3])
def test_knn_edge_aggregate_bwd_reference_matches_jax_grad(pos_diffs, self_loops, masked,
                                                           dropout_p, sum_agg, need_wgrads):
    """K6's plain version from the JAX forward's own ``idx``/``dists`` (no
    near-tie can come between them)."""
    n = 13
    d = _inputs(n, masked=masked, seed=5)
    _, idx_j, dists_j = _jax_fused(d, self_loops, pos_diffs, sum_agg, dropout_p)
    jg = _jax_grads(d, self_loops, pos_diffs, sum_agg, dropout_p, need_wgrads)
    du1, du2, dmask, ddists, dw_d, dhidden = tkk.knn_edge_aggregate_bwd_reference(
        _t(d["u1"]), _t(d["u2m"]), _t(idx_j.astype(np.int32)), _t(dists_j),
        _t(d["w_d"]) if pos_diffs else None, tuple(map(_t, d["hidden"])), _t(d["g"]), 0.2,
        sum_agg, dropout_p, SEED, need_wgrads)
    np.testing.assert_allclose(du1.numpy(), np.asarray(jg[2]), **BWD_TOL)
    np.testing.assert_allclose(torch.cat([du2, dmask], -1).numpy(), np.asarray(jg[3]), **BWD_TOL)
    for a, b in zip(dhidden, jg[5]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **BWD_TOL)
        if not need_wgrads:
            assert not a.any()
    if pos_diffs:
        assert ddists.shape == (3, n, K)
        np.testing.assert_allclose(dw_d.numpy(), np.asarray(jg[4]), **BWD_TOL)
    else:
        assert ddists is None and dw_d is None


def _function_grads(d, self_loops, want_dists, sum_agg, dropout_p, weights_grad=True):
    ts = [_t(d[k]).requires_grad_() for k in ("xs", "xf", "u1", "u2m")]
    w_d = _t(d["w_d"]).requires_grad_(weights_grad) if want_dists else None
    th = [_t(a).requires_grad_(weights_grad) for a in d["hidden"]]
    out = tkk.KnnFusedLayer.apply(*ts, w_d, K, self_loops, want_dists, 0.2, sum_agg, dropout_p,
                                  SEED, *th)
    (out * _t(d["g"])).sum().backward()
    return [t.grad for t in ts], None if w_d is None else w_d.grad, [t.grad for t in th]


@pytest.mark.parametrize("dropout_p", [0.0, 0.5])
@pytest.mark.parametrize("pos_diffs,self_loops,masked", CASES[:3])
def test_knn_fused_layer_function_grads_match_jax(pos_diffs, self_loops, masked, dropout_p):
    """Forward K5, backward K6 and the ddists -> dxs, dxf step, all through the
    Function, against jax.grad of the Pallas layer."""
    d = _inputs(20, masked=masked, seed=11)
    _, idx_j, _ = _jax_fused(d, self_loops, pos_diffs, True, dropout_p)
    idx_t = tkk.knn_select_reference(_t(d["xs"]), _t(d["xf"]), K, self_loops)
    if not _agreeing_rows(d, idx_t, idx_j).all():
        pytest.fail("this seed has a near-tie row; pick one without, gradients scatter")
    jg = _jax_grads(d, self_loops, pos_diffs, True, dropout_p, True)
    (dxs, dxf, du1, du2m), dw_d, dhidden = _function_grads(d, self_loops, pos_diffs, True,
                                                           dropout_p)
    np.testing.assert_allclose(du1.numpy(), np.asarray(jg[2]), **BWD_TOL)
    np.testing.assert_allclose(du2m.numpy(), np.asarray(jg[3]), **BWD_TOL)
    for a, b in zip(dhidden, jg[5]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **BWD_TOL)
    if pos_diffs:
        np.testing.assert_allclose(dw_d.numpy(), np.asarray(jg[4]), **BWD_TOL)
        np.testing.assert_allclose(dxs.numpy(), np.asarray(jg[0]), **BWD_TOL)
        # masked senders sit 1e4 out: their gradient is that much larger
        scale = np.maximum(1.0, np.abs(np.asarray(jg[1])))
        np.testing.assert_allclose(dxf.numpy() / scale, np.asarray(jg[1]) / scale, **BWD_TOL)
    else:
        assert dxs is None and dxf is None and dw_d is None


def test_knn_fused_layer_function_without_weight_grads():
    """Weights without ``requires_grad`` (the G step through D): K6 runs
    without the weight contractions; the inputs' gradients are unchanged."""
    d = _inputs(13)
    (_, _, du1, du2m), dw_d, _ = _function_grads(d, True, True, True, 0.5)
    (_, _, eu1, eu2m), ew_d, wgrads = _function_grads(d, True, True, True, 0.5,
                                                      weights_grad=False)
    assert ew_d is None and all(w is None for w in wgrads) and dw_d is not None
    torch.testing.assert_close(du1, eu1, rtol=0, atol=0)
    torch.testing.assert_close(du2m, eu2m, rtol=0, atol=0)
    assert set(tmk.launch_counts.values()) == {0}


def test_knn_aggregate_asks_for_residuals_only_for_a_backward(monkeypatch):
    d = _inputs(13)
    seen = []
    real = tkk.knn_fused_layer
    monkeypatch.setattr(tkk, "knn_fused_layer",
                        lambda *a: seen.append(a[-1]) or real(*a))
    args = [_t(d[k]) for k in ("xs", "xf", "u1", "u2m")]
    bias = torch.nn.Parameter(_t(d["hidden"][1]))  # a parameter: requires_grad under no_grad too
    hidden = (_t(d["hidden"][0]), bias, *map(_t, d["hidden"][2:]))
    tail = (None, hidden, K, True, False, 0.2, True)
    with torch.no_grad():
        plain = tkk.knn_aggregate(*args, *tail)
    with torch.inference_mode():
        tkk.knn_aggregate(*args, *tail)
    out = tkk.knn_aggregate(*args, *tail)
    assert seen == [False, False, True]
    assert not plain.requires_grad and out.requires_grad and torch.equal(plain, out)


def test_knn_fused_layer_function_is_once_differentiable():
    d = _inputs(13)
    u1 = _t(d["u1"]).requires_grad_()
    out = tkk.KnnFusedLayer.apply(_t(d["xs"]), _t(d["xf"]), u1, _t(d["u2m"]), None, K, True,
                                  False, 0.2, True, 0.0, 0, *map(_t, d["hidden"]))
    (gu,) = torch.autograd.grad(out.sum(), u1, create_graph=True)
    with pytest.raises(RuntimeError):
        gu.sum().backward()


def test_knn_wrappers_check_their_arguments():
    d = _inputs(13)
    xs, xf, u1, u2m, w_d, g = (_t(d[k]) for k in ("xs", "xf", "u1", "u2m", "w_d", "g"))
    hidden = tuple(map(_t, d["hidden"]))
    fwd = lambda **kw: tkk.knn_fused_layer(  # noqa: E731
        **{**dict(xs=xs, xf=xf, u1=u1, u2m=u2m, w_d=None, hidden_flat=hidden, k=K,
                  self_loops=True, want_dists=False, alpha=0.2, sum_agg=True), **kw})
    out, idx, dists = fwd()
    ref, _, _ = tkk.knn_fused_layer_reference(xs, xf, u1, u2m, None, hidden, K, True, False,
                                              0.2, True)
    assert torch.equal(out, ref) and idx is None and dists is None
    with pytest.raises(ValueError, match="exceeds the 13 available senders"):
        fwd(k=14)
    with pytest.raises(ValueError, match="exceeds the 13 available senders"):
        fwd(k=13, self_loops=False)
    with pytest.raises(ValueError, match=r"\[u2 \| mask\]"):
        fwd(u2m=u2m[..., :-1])
    with pytest.raises(ValueError, match="w_d"):
        fwd(want_dists=True)
    with pytest.raises(ValueError, match="do not chain"):
        fwd(hidden_flat=hidden[2:] + hidden[:2])
    with pytest.raises(ValueError, match="outside"):
        fwd(dropout_p=1.0)
    with pytest.raises(ValueError, match="no kernel for device"):
        meta = lambda t: torch.empty(t.shape, device="meta")  # noqa: E731
        fwd(xs=meta(xs), xf=meta(xf), u1=meta(u1), u2m=meta(u2m),
            hidden_flat=tuple(map(meta, hidden)))
    idx = tkk.knn_select_reference(xs, xf, K, True)
    bwd = lambda **kw: tkk.knn_edge_aggregate_bwd(  # noqa: E731
        **{**dict(u1=u1, u2m=u2m, idx=idx, dists=None, w_d=None, hidden_flat=hidden, g=g,
                  alpha=0.2, sum_agg=True), **kw})
    assert len(bwd()) == 6
    with pytest.raises(ValueError, match="int32"):
        bwd(idx=idx.long())
    with pytest.raises(ValueError, match="g .* must be"):
        bwd(g=g[..., :-1])
    with pytest.raises(ValueError, match="dists .* must be"):
        bwd(dists=torch.zeros(3, 13, K + 1), w_d=w_d)
    with pytest.raises(ValueError, match="seed"):
        bwd(dropout_p=0.5, seed=-1)
    assert set(tmk.launch_counts.values()) == {0}


# ---------------------------------------------------------------------------
# the knn layer
# ---------------------------------------------------------------------------


def _layer(node, fe, fn, out, linear_args=None, **mp_args):
    mp_args = dict(fully_connected=False, num_knn=K, **mp_args)
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


def _layer_inputs(n, node=8, b=3, seed=0):
    rng = np.random.RandomState(seed)
    x = (rng.randn(b, n, node) * 0.3).astype(np.float32)
    counts = np.array([n, n // 2 + 1, K + 2][:b])
    mask = (np.arange(n)[None, :] < counts[:, None]).astype(np.float32)[..., None]
    labels = rng.rand(b, 3).astype(np.float32)
    njp = counts.astype(np.float32) / n
    return x, mask, labels, njp


LAYER_CASES = [
    ({}, True),
    ({"pos_diffs": True, "all_ef": True}, False),
    ({"pos_diffs": True, "all_ef": True, "self_loops": False}, True),
    ({"pos_diffs": True, "delta_r": True, "sum_agg": False}, True),  # distances on 2 coords
    ({"clabels": 2, "mask_fne_np": True, "self_loops": False, "sum_agg": False}, True),
]


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("mp_args,masked", LAYER_CASES)
@pytest.mark.parametrize("n", [13, 20])
def test_knn_layer_eval_matches_jax(n, mp_args, masked, use_pallas):
    jcfg, params, state, layer = _layer(8, [24, 16], [32], 8, **mp_args)
    x, mask, labels, njp = _layer_inputs(n)
    m = mask if masked else None
    yj, _ = jmp.mp_layer_apply(jcfg, params, state, _j(x), mask=_j(m), labels=_j(labels),
                               num_jet_particles=_j(njp), use_pallas=use_pallas)
    yt = tmp.mp_layer_apply(layer, _t(x), mask=_t(m), labels=_t(labels),
                            num_jet_particles=_t(njp), use_kernels=use_pallas)
    np.testing.assert_allclose(yt.detach().numpy(), np.asarray(yj), **FWD_TOL)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("mp_args", [
    {}, {"pos_diffs": True, "all_ef": True}, {"self_loops": False, "sum_agg": False},
])
def test_knn_layer_train_matches_jax(mp_args, use_pallas):
    """Output and input/weight gradients of one train-mode knn layer with
    dropout 0.5; under ``pos_diffs`` the gradient also flows through the
    distances (both paths) into ``x``."""
    jcfg, params, state, layer = _layer(8, [24, 16], [32], 8, {"dropout_p": 0.5}, **mp_args)
    n = 13
    x, mask, _, _ = _layer_inputs(n, seed=2)
    key = jax.random.PRNGKey(7)

    def jf(params, x):
        y, _ = jmp.mp_layer_apply(jcfg, params, state, x, mask=_j(mask), train=True, rng=key,
                                  use_pallas=use_pallas)
        return jnp.sum(jnp.sin(y)), y

    (_, yj), (jgp, jgx) = jax.value_and_grad(jf, argnums=(0, 1), has_aux=True)(params, _j(x))
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


def test_knn_layer_kernel_path_with_spectral_norm_matches_jax():
    jcfg, params, state, layer = _layer(8, [16, 12], [16], 8, {"spectral_norm": True})
    x, mask, _, _ = _layer_inputs(13)
    yj, _ = jmp.mp_layer_apply(jcfg, params, state, _j(x), mask=_j(mask), use_pallas=True)
    yt = tmp.mp_layer_apply(layer, _t(x), mask=_t(mask), use_kernels=True)
    np.testing.assert_allclose(yt.detach().numpy(), np.asarray(yj), **FWD_TOL)


def test_knn_layer_with_fe_batch_norm_takes_the_plain_path():
    jcfg, params, state, layer = _layer(8, [16, 12], [16], 8, {"batch_norm": True})
    x, mask, _, _ = _layer_inputs(13)
    yj, _ = jmp.mp_layer_apply(jcfg, params, state, _j(x), mask=_j(mask), use_pallas=True)
    yt = tmp.mp_layer_apply(layer, _t(x), mask=_t(mask), use_kernels=True)
    np.testing.assert_allclose(yt.detach().numpy(), np.asarray(yj), **FWD_TOL)


def test_decompose_first_layer_extracts_the_dists_column():
    _, _, _, layer = _layer(8, [24, 16], [32], 8, pos_diffs=True, all_ef=True, clabels=2)
    cfg = layer.cfg
    x, _, labels, _ = _layer_inputs(13)
    weights = [(lin.weight, lin.bias) for lin in layer.fe.net]
    u1, u2, w_d = tmp._decompose_first_layer(cfg, weights, _t(x), _t(labels), None,
                                             extract_wd=True)
    w1, b1 = weights[0]
    assert torch.equal(w_d, w1[:, 16])
    want = _t(x) @ w1[:, 8:16].t() + b1 + (_t(labels)[:, :2] @ w1[:, 17:19].t())[:, None, :]
    torch.testing.assert_close(u2, want, rtol=1e-6, atol=1e-6)
    assert tmp._decompose_first_layer(cfg, weights, _t(x), _t(labels), None)[2] is None


@pytest.mark.parametrize("use_kernels", [False, True])
def test_knn_layer_refuses_more_neighbours_than_senders(use_kernels):
    _, _, _, layer = _layer(4, [8], [8], 4, self_loops=False)
    with pytest.raises(ValueError, match=r"num_knn=5 \(\+1 dropped self\) exceeds the 5"):
        tmp.mp_layer_apply(layer, torch.zeros(1, 5, 4), use_kernels=use_kernels)
    assert tmp.mp_layer_apply(layer, torch.zeros(1, 6, 4), use_kernels=use_kernels).shape == \
        (1, 6, 4)


# ---------------------------------------------------------------------------
# a knn generator
# ---------------------------------------------------------------------------

KNN_CARD = {"model": "mpgan", "num_hits": 12, "hidden_node_size": 8, "fe": [12, 16], "fn": [16],
            "fully_connected": False, "num_knn": K}


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("extra", [{}, {"pos_diffs": True, "deltar": True, "self_loops": False}])
def test_knn_generator_matches_jax(extra, use_pallas):
    card = dict(KNN_CARD, use_pallas=use_pallas, **extra)
    jcfg = jconfig.build_mpgan_generator(jconfig.from_args_dict(card))
    tcfg = tconfig.build_mpgan_generator(tconfig.from_args_dict(card))
    assert all(not c.fully_connected and c.num_knn == K for c in tcfg.layers)
    assert [dataclass_dict(c) for c in tcfg.layers] == [dataclass_dict(c) for c in jcfg.layers]
    params, state = mp_generator_init(jax.random.PRNGKey(1), jcfg)
    g = mp_generator_from_jax(jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, state),
                              tcfg)
    rng = np.random.RandomState(3)
    noise = (rng.randn(4, 12, 8) * 0.2).astype(np.float32)
    labels = np.array([[1.0], [0.5], [0.75], [0.25]], np.float32)
    yj, _ = mp_generator_apply(jcfg, params, state, _j(noise), _j(labels))
    with torch.inference_mode():
        yt = g(_t(noise), _t(labels))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(yt.numpy()[..., -1], np.asarray(yj)[..., -1])


def dataclass_dict(layer_cfg):
    """The fields both packages' ``MPLayerConfig`` share, MLP configs as tuples of sizes."""
    keys = ("input_node_size", "output_node_size", "pos_diffs", "all_ef", "coords",
            "delta_coords", "delta_r", "clabels", "mask_fne_np", "fully_connected", "num_knn",
            "self_loops", "sum_agg")
    return {**{k: getattr(layer_cfg, k) for k in keys},
            "fe": tuple(layer_cfg.fe.sizes), "fn": tuple(layer_cfg.fn.sizes)}
