"""The split knn route of the port (search kernel K7, aggregate kernel K8 fed
with ``idx``, backward K6) against the same route of the JAX package on the CPU.

Both packages pick the route from ``MPGAN_TPU_KNN_KERNEL`` (``4`` fused, the
default; ``3``, ``2``, ``1`` the older split generations) and
``MPGAN_TPU_KNN_SELECT`` (``0``: the plain search feeds the aggregate kernel).
The JAX package reads them when it traces, so its *unjitted* ``mp_layer_apply``
is called under ``monkeypatch.setenv``; its Pallas kernels run in interpret
mode, the port runs its kernels' plain versions. ``N=12 k=3 B=2``, float32:
forward 1e-5, gradients 1e-4. Neighbour lists are compared under the near-tie
rule of ``test_torch_knn.py`` (``compare_neighbours``).
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one thread a test worker: the suite runs in parallel workers

import jax
import jax.numpy as jnp

import mpgan_tpu.ops.knn_pallas as jknn
from mpgan_tpu.ops import mp as jmp
from mpgan_tpu_torch.ops import knn_kernels as tkk
from mpgan_tpu_torch.ops import mp as tmp
from mpgan_tpu_torch.ops import mp_kernels as tmk
from mpgan_tpu_torch.utils.weights import mlp_sd_from_jax

from test_torch_ops import port_keys  # the port's keys of a JAX key

FWD_TOL = dict(rtol=1e-5, atol=1e-5)
BWD_TOL = dict(rtol=1e-4, atol=1e-4)
N, K, B = 12, 3, 2
# (MPGAN_TPU_KNN_KERNEL, MPGAN_TPU_KNN_SELECT); None leaves the variable unset
ROUTES = [pytest.param("3", None, id="v3"), pytest.param("2", None, id="v2"),
          pytest.param("1", None, id="v1"), pytest.param(None, "0", id="select0"),
          pytest.param("2", "0", id="v2-select0")]
LAYERS = [
    pytest.param({}, id="plain"),
    pytest.param({"pos_diffs": True, "all_ef": True, "self_loops": False}, id="dists-noself"),
    pytest.param({"pos_diffs": True, "delta_r": True, "sum_agg": False, "clabels": 2,
                  "mask_fne_np": True}, id="dists2-mean-cond"),
]


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _set_route(monkeypatch, kernel, select):
    for name, value in (("MPGAN_TPU_KNN_KERNEL", kernel), ("MPGAN_TPU_KNN_SELECT", select)):
        if value is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, value)


def _layer(linear_args=None, **mp_args):
    mp_args = dict(fully_connected=False, num_knn=K, **mp_args)
    jcfg = jmp.MPLayerConfig.build(8, [24, 16], [32], 8, linear_args=linear_args, **mp_args)
    tcfg = tmp.MPLayerConfig.build(8, [24, 16], [32], 8, linear_args=linear_args, **mp_args)
    params, state = jmp.mp_layer_init(jax.random.PRNGKey(0), jcfg)
    params_np, state_np = (jax.tree.map(np.asarray, t) for t in (params, state))
    layer = tmp.MPLayer(tcfg)
    layer.load_state_dict({**mlp_sd_from_jax("fe.", tcfg.fe, params_np["fe"], state_np["fe"]),
                           **mlp_sd_from_jax("fn.", tcfg.fn, params_np["fn"], state_np["fn"])},
                          strict=True)
    return jcfg, params, state, layer


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    x = (rng.randn(B, N, 8) * 0.3).astype(np.float32)
    counts = np.array([N, K + 3])
    mask = (np.arange(N)[None, :] < counts[:, None]).astype(np.float32)[..., None]
    labels = rng.rand(B, 3).astype(np.float32)
    return x, mask, labels, counts.astype(np.float32) / N


def test_route_switch_reads_the_environment_at_call_time(monkeypatch):
    _set_route(monkeypatch, None, None)
    assert tmp.knn_route() == ("4", True)
    for kernel in ("3", "2", "1"):
        _set_route(monkeypatch, kernel, None)
        assert tmp.knn_route() == (kernel, True)
    _set_route(monkeypatch, None, "0")
    assert tmp.knn_route() == ("3", False)  # the fused kernel is the search kernel
    _set_route(monkeypatch, "1", "0")
    assert tmp.knn_route() == ("1", False)
    _set_route(monkeypatch, "5", None)
    with pytest.raises(ValueError, match="MPGAN_TPU_KNN_KERNEL"):
        tmp.knn_route()


@pytest.mark.parametrize("mp_args", LAYERS)
@pytest.mark.parametrize("kernel, select", ROUTES)
def test_knn_layer_route_eval_matches_jax(monkeypatch, kernel, select, mp_args):
    _set_route(monkeypatch, kernel, select)
    jcfg, params, state, layer = _layer(**mp_args)
    x, mask, labels, njp = _inputs()
    yj, _ = jmp.mp_layer_apply(jcfg, params, state, _j(x), mask=_j(mask), labels=_j(labels),
                               num_jet_particles=_j(njp), use_pallas=True)
    tmk.reset_launch_counts()
    yt = tmp.mp_layer_apply(layer, _t(x), mask=_t(mask), labels=_t(labels),
                            num_jet_particles=_t(njp), use_kernels=True)
    assert not any(tmk.launch_counts.values())  # plain versions on the CPU
    np.testing.assert_allclose(yt.detach().numpy(), np.asarray(yj), **FWD_TOL)


@pytest.mark.parametrize("mp_args", LAYERS[:2])
@pytest.mark.parametrize("kernel, select", ROUTES[:4])
def test_knn_layer_route_train_matches_jax(monkeypatch, kernel, select, mp_args):
    """Output and gradients of a train-mode layer with dropout 0.5 under
    replayed keys: every route keys the mask on the edge id, so the masks agree
    with the JAX package's on each of them."""
    _set_route(monkeypatch, kernel, select)
    jcfg, params, state, layer = _layer({"dropout_p": 0.5}, **mp_args)
    x, mask, _, _ = _inputs(seed=2)
    key = jax.random.PRNGKey(7)

    def jf(params, x):
        y, _ = jmp.mp_layer_apply(jcfg, params, state, x, mask=_j(mask), train=True, rng=key,
                                  use_pallas=True)
        return jnp.sum(jnp.sin(y)), y

    (_, yj), (jgp, jgx) = jax.value_and_grad(jf, argnums=(0, 1), has_aux=True)(params, _j(x))
    tx = _t(x).requires_grad_()
    yt = tmp.mp_layer_apply(layer, tx, mask=_t(mask), train=True, rng=port_keys(key),
                            use_kernels=True)
    torch.sin(yt).sum().backward()
    np.testing.assert_allclose(yt.detach().numpy(), np.asarray(yj), **FWD_TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), **BWD_TOL)
    for part in ("fe", "fn"):
        for k, lin in enumerate(getattr(layer, part).net):
            np.testing.assert_allclose(lin.weight.grad.numpy(),
                                       np.asarray(jgp[part]["layers"][k]["w"]), **BWD_TOL)
            np.testing.assert_allclose(lin.bias.grad.numpy(),
                                       np.asarray(jgp[part]["layers"][k]["b"]), **BWD_TOL)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("mp_args", LAYERS)
def test_the_ports_routes_equal_each_other(monkeypatch, mp_args, train):
    """Routes 4, 3, 2 and 1 run the same plain functions on the CPU (bit for
    bit); the plain search ranks exact distances and gives the same neighbours
    away from ties."""
    _, _, _, layer = _layer({"dropout_p": 0.5}, **mp_args)
    x, mask, labels, njp = _inputs(seed=3)
    outs, grads = {}, {}
    for name, (kernel, select) in {"4": (None, None), "3": ("3", None), "2": ("2", None),
                                   "1": ("1", None), "select0": ("3", "0")}.items():
        _set_route(monkeypatch, kernel, select)
        tx = _t(x).requires_grad_()
        y = tmp.mp_layer_apply(layer, tx, mask=_t(mask), labels=_t(labels),
                               num_jet_particles=_t(njp), train=train,
                               rng=port_keys(jax.random.PRNGKey(1)) if train else None,
                               use_kernels=True)
        torch.sin(y).sum().backward()
        outs[name], grads[name] = y.detach(), tx.grad
    for name in ("3", "2", "1"):
        assert torch.equal(outs[name], outs["4"]) and torch.equal(grads[name], grads["4"])
    np.testing.assert_allclose(outs["select0"].numpy(), outs["4"].numpy(), **FWD_TOL)
    np.testing.assert_allclose(grads["select0"].numpy(), grads["4"].numpy(), **BWD_TOL)


# ---------------------------------------------------------------------------
# K7 and K8 on their own
# ---------------------------------------------------------------------------


def _search_inputs(n, c, b=3, seed=1):
    rng = np.random.RandomState(seed)
    xs = (rng.randn(b, n, c) * 0.3).astype(np.float32)
    counts = np.array([n, n // 2 + 1, K + 2][:b])
    mask = (np.arange(n)[None, :] < counts[:, None]).astype(np.float32)[..., None]
    return xs, (((1 - 1e4) * mask + 1e4) * xs).astype(np.float32), mask


def _check_idx(idx_t, idx_j, xs, xf, mask):
    keys = tkk.knn_keys(_t(xs), _t(xf))
    agree, differing, far = tkk.compare_neighbours(idx_t, _t(np.asarray(idx_j)), keys, _t(mask))
    assert far == 0 and differing <= 0.01 * agree.numel() + 1
    return agree


@pytest.mark.parametrize("self_loops", [True, False])
@pytest.mark.parametrize("n, c", [(12, 8), (20, 3)])
def test_knn_search_matches_pallas_select(n, c, self_loops):
    """K7's plain version against ``knn_select`` (idx) and ``knn_select_nm``
    (idx and distances, neighbour-major there, ``[B, N, k]`` here)."""
    xs, xf, mask = _search_inputs(n, c)
    idx_t, dists_t = tkk.knn_search(_t(xs), _t(xf), K, self_loops, want_dists=True)
    assert idx_t.dtype == torch.int32 and idx_t.shape == dists_t.shape == (3, n, K)
    idx_only, none = tkk.knn_search(_t(xs), _t(xf), K, self_loops)
    assert none is None and torch.equal(idx_only, idx_t)
    idx_j = jknn.knn_select(_j(xs), _j(xf), K, self_loops)
    _check_idx(idx_t, idx_j, xs, xf, mask)
    idx_nm, dists_nm = jknn.knn_select_nm(_j(xs), _j(xf), K, self_loops, True)
    np8 = idx_nm.shape[1] // K
    to_rows = lambda a: np.swapaxes(np.asarray(a).reshape(3, K, np8)[:, :, :n], 1, 2)  # noqa: E731
    agree = _check_idx(idx_t, to_rows(idx_nm), xs, xf, mask)
    live = (np.take_along_axis(np.broadcast_to(mask[:, None, :, 0], (3, n, n)),
                               idx_t.numpy().astype(np.int64), axis=2) > 0)
    live &= agree.numpy()[..., None]
    np.testing.assert_allclose(dists_t.numpy()[live], to_rows(dists_nm)[live], **FWD_TOL)


@pytest.mark.parametrize("dropout_p", [0.0, 0.5])
@pytest.mark.parametrize("want_dists", [False, True])
def test_split_route_equals_the_fused_layer_and_its_gradients(want_dists, dropout_p):
    """K7 -> K8 (-> K6) against K5 (-> K6) through their autograd Functions:
    the same plain functions, so bit for bit on the CPU."""
    rng = np.random.RandomState(4)
    xs, xf, mask = _search_inputs(N, 8, seed=4)
    widths = (24, 16, 12)
    r = lambda *s: torch.from_numpy((rng.randn(*s) * 0.4).astype(np.float32))  # noqa: E731
    base = dict(u1=r(3, N, 24), u2=r(3, N, 24), w_d=r(24))
    hidden = [t for a, w in zip(widths[:-1], widths[1:]) for t in (r(a, w), r(w))]
    res = {}
    for name, fn in (("fused", tkk.knn_aggregate), ("split", tkk.knn_aggregate_split)):
        leaves = {k: v.clone().requires_grad_() for k, v in base.items()}
        hid = [t.clone().requires_grad_() for t in hidden]
        txs = _t(xs).clone().requires_grad_()
        txf = txs * _t(((1 - 1e4) * mask + 1e4).astype(np.float32))
        u2m = torch.cat([leaves["u2"], _t(mask)], dim=-1)
        out = fn(txs, txf, leaves["u1"], u2m, leaves["w_d"], hid, K, False, want_dists, 0.2,
                 True, dropout_p, 12345)
        torch.sin(out).sum().backward()
        res[name] = [out.detach(), txs.grad, leaves["u1"].grad, leaves["u2"].grad,
                     leaves["w_d"].grad, *[t.grad for t in hid]]
    for a, b in zip(res["fused"], res["split"]):
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(a, b)
    assert (res["split"][1] is not None) == want_dists  # x gets a gradient through dists only


def test_knn_edge_aggregate_without_a_gradient_skips_the_function(monkeypatch):
    calls = []
    real = tkk.knn_edge_aggregate
    monkeypatch.setattr(tkk, "knn_edge_aggregate",
                        lambda *a, **k: calls.append("fwd") or real(*a, **k))
    monkeypatch.setattr(tkk.KnnEdgeAggregate, "apply",
                        lambda *a, **k: pytest.fail("Function used without a gradient"))
    xs, xf, mask = _search_inputs(N, 8)
    u1 = torch.zeros(3, N, 6)
    u2m = torch.cat([torch.zeros(3, N, 6), _t(mask)], dim=-1)
    out = tkk.knn_aggregate_split(_t(xs), _t(xf), u1, u2m, None, (), K, True, False, 0.2, True)
    assert calls == ["fwd"] and out.shape == (3, N, 6)


def test_split_wrappers_check_their_arguments():
    xs, xf, mask = _search_inputs(N, 8)
    with pytest.raises(ValueError, match="exceeds"):
        tkk.knn_search(_t(xs), _t(xf), N, False)
    with pytest.raises(ValueError, match=r"\[B, N, C\]"):
        tkk.knn_search(_t(xs), _t(xf)[:, :-1], K, True)
    u1 = torch.zeros(3, N, 6)
    u2m = torch.zeros(3, N, 7)
    idx = torch.zeros(3, N, K, dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        tkk.knn_edge_aggregate(u1, u2m, idx.long(), None, None, (), 0.2, True)
    with pytest.raises(ValueError, match="dists"):
        tkk.knn_edge_aggregate(u1, u2m, idx, torch.zeros(3, N, K + 1), torch.zeros(6), (), 0.2,
                               True)
    with pytest.raises(ValueError, match="u2m"):
        tkk.knn_edge_aggregate(u1, u2m[..., :-1], idx, None, None, (), 0.2, True)
    out = tkk.knn_edge_aggregate(u1, u2m, idx, None, None, (), 0.2, False)
    assert out.shape == (3, N, 6)
