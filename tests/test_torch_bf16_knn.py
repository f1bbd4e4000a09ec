"""bf16 training of the knn message-passing layer (``--compute-dtype bfloat16``
with ``--no-fully-connected``) in the port against the JAX package on the CPU.

- K5: the bf16 plain version against ``knn_pallas._fused_impl_v4`` called with
  bf16 arrays (interpret mode), eval and dropout 0.5, sum and mean, with and
  without self loops and distances, within rtol = atol = 1e-2 on the receiver
  rows whose neighbours agree (``idx`` under the near-tie rule of
  ``compare_neighbours``); ``idx`` int32 and ``dists`` float32;
- K6 (and the distance glue): the ``KnnFusedLayer`` Function's gradients and
  the plain backward without weight gradients against ``jax.grad`` of
  ``knn_pallas.knn_fused_layer``'s custom VJP, within 1e-2 of max(1, max|ref|)
  (a pre-activation within rounding of zero may take the other LeakyReLU
  slope);
- K8 against route 3's ``knn_edge_aggregate_v3`` and K7 against
  ``knn_select_nm``;
- the bf16 D and G steps of the knn MPGAN pair (kernel and plain path) and of
  the legacy knn pair against JAX's (its steps under ``jax.jit``), at
  ``test_torch_bf16_steps``' bounds; a mix of dtypes raises; a tiny bf16 run
  of the train CLI with a resume.

Widths are no multiples of 16 (K) or 8 (M); B = 2, N = 13, k = 5.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one thread a test worker: the suite runs in parallel workers

import jax
import jax.numpy as jnp

import mpgan_tpu.ops.knn_pallas as jknn
from mpgan_tpu_torch.cli import train as ttrain_cli
from mpgan_tpu_torch.ops import knn_kernels as tkk

from mpgan_tpu.training import train_step as jts
from mpgan_tpu_torch.training import train_step as tts

from test_torch_bf16_steps import GRAD_SHARE, LOSS_TOL, _check_grads, _Pair, _port_grads
from test_torch_ops import port_keys  # the port's keys of a JAX key
from test_torch_zoo import _card

BF16_TOL = dict(rtol=1e-2, atol=1e-2)
SEED = int(np.float32(123456789))
K = 5
N = 13
WIDTHS = (20, 13, 12)  # no multiple of 16 (K) or of 8 (M)
MAX_DIFFERING_SHARE = 0.05  # bf16 coordinates tie more often than float32 ones


def _inputs(n=N, b=2, c=3, seed=1):
    """Operands of the knn layer: jet 0 is full, jet 1 holds 8 real particles."""
    rng = np.random.RandomState(seed)
    f = lambda *s, scale=1.0: (rng.randn(*s) * scale).astype(np.float32)  # noqa: E731
    x = f(b, n, c, scale=0.3)
    mask = (np.arange(n)[None, :] < np.array([n, 8])[:b, None]).astype(np.float32)[..., None]
    u1, u2 = f(b, n, WIDTHS[0], scale=0.5), f(b, n, WIDTHS[0], scale=0.5)
    hidden = []
    for a, w in zip(WIDTHS[:-1], WIDTHS[1:]):
        hidden += [f(a, w, scale=a ** -0.5), f(w, scale=0.1)]
    return dict(xs=x, xf=(((1 - 1e4) * mask + 1e4) * x).astype(np.float32), u1=u1,
                u2m=np.concatenate([u2, mask], axis=-1), w_d=f(WIDTHS[0], scale=0.3),
                hidden=tuple(hidden), g=f(b, n, WIDTHS[-1]), mask=mask)


def _tb(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a)).to(torch.bfloat16)


def _jb(a):
    return None if a is None else jnp.asarray(a).astype(jnp.bfloat16)


def _bf(d, key):
    """The bf16 value of an input, as float32 numpy (what both sides see)."""
    return _tb(d[key]).float().numpy()


def _unpack(t, b, n):
    """A neighbour-major ``[B, k * NP8, 1]`` JAX residual as ``[B, N, k]``."""
    np8 = (n + 7) // 8 * 8
    return np.swapaxes(np.asarray(t).reshape(b, K, np8)[:, :, :n], 1, 2)


def _agreeing_rows(d, idx_t, idx_j):
    """The rows whose neighbours agree, after the near-tie accounting on the
    keys of the inputs' bf16 values."""
    keys = tkk.knn_keys(torch.from_numpy(_bf(d, "xs")), torch.from_numpy(_bf(d, "xf")))
    agree, differing, bad = tkk.compare_neighbours(
        idx_t, torch.from_numpy(np.asarray(idx_j).astype(np.int32)), keys,
        torch.from_numpy(d["mask"]))
    assert bad == 0
    assert differing <= MAX_DIFFERING_SHARE * agree.numel()
    return agree.numpy()


def _close(t, j, rows=None, scaled=False):
    """A port tensor against a JAX array in the same dtype at BF16_TOL, on
    ``rows`` ([B, N] bool) when given; ``scaled``: on the scale of the largest
    of ``j``."""
    assert str(t.dtype).split(".")[-1] == str(j.dtype)
    t, j = t.float().numpy(), np.asarray(j.astype(jnp.float32))
    if rows is not None:
        t, j = t[rows], j[rows]
    bound = max(1.0, np.abs(j).max()) if scaled else 1.0
    np.testing.assert_allclose(t / bound, j / bound, **BF16_TOL)


# ---------------------------------------------------------------------------
# K5, K7, K8: the bf16 plain versions against the Pallas kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("self_loops,want_dists,sum_agg,dropout_p", [
    (False, True, True, 0.0), (True, False, False, 0.5), (False, True, False, 0.5)])
def test_knn_fused_bf16_reference_matches_pallas(self_loops, want_dists, sum_agg, dropout_p):
    d = _inputs()
    agg_j, idx_j, dists_j = jknn._fused_impl_v4(
        _jb(d["xs"]), _jb(d["xf"]), _jb(d["u1"]), _jb(d["u2m"]),
        _jb(d["w_d"]) if want_dists else None, jknn._weights_list(tuple(map(_jb, d["hidden"]))),
        jnp.float32(SEED) if dropout_p > 0 else None, k=K, self_loops=self_loops,
        want_dists=want_dists, alpha=0.2, sum_agg=sum_agg, dropout_p=dropout_p, emit_idx=True)
    agg, idx, dists = tkk.knn_fused_layer(
        _tb(d["xs"]), _tb(d["xf"]), _tb(d["u1"]), _tb(d["u2m"]), _tb(d["w_d"]),
        tuple(map(_tb, d["hidden"])), K, self_loops, want_dists, 0.2, sum_agg, dropout_p, SEED,
        emit_idx=True)
    assert agg.dtype == torch.bfloat16 and idx.dtype == torch.int32
    rows = _agreeing_rows(d, idx, _unpack(idx_j, 2, N))
    _close(agg, agg_j, rows)
    if want_dists:
        assert dists.dtype == torch.float32 and dists_j.dtype == jnp.float32
        np.testing.assert_allclose(dists.numpy()[rows], _unpack(dists_j, 2, N)[rows],
                                   rtol=1e-5, atol=1e-6)
    else:
        assert dists is None


@pytest.mark.parametrize("want_dists", [True, False])
def test_knn_search_bf16_reference_matches_select_nm(want_dists):
    """K7: bf16 inputs widened in the search; int32 ``idx``, float32 distances."""
    d = _inputs(seed=2)
    idx_j, dists_j = jknn.knn_select_nm(_jb(d["xs"]), _jb(d["xf"]), K, False, want_dists)
    idx, dists = tkk.knn_search(_tb(d["xs"]), _tb(d["xf"]), K, False, want_dists)
    assert idx.dtype == torch.int32
    rows = _agreeing_rows(d, idx, _unpack(idx_j, 2, N))
    assert rows.mean() >= 1 - MAX_DIFFERING_SHARE
    if want_dists:
        assert dists.dtype == torch.float32 and dists_j.dtype == jnp.float32
        np.testing.assert_allclose(dists.numpy()[rows], _unpack(dists_j, 2, N)[rows],
                                   rtol=1e-5, atol=1e-6)
    else:
        assert dists is None and dists_j is None


@pytest.mark.parametrize("want_dists,dropout_p", [(True, 0.5), (False, 0.0)])
def test_knn_edge_aggregate_bf16_reference_matches_v3(want_dists, dropout_p):
    """K8 from one ``idx`` and float32 ``dists`` against route 3's
    ``_fwd_impl_v3`` on bf16 operands."""
    d = _inputs(seed=3)
    idx, dists = tkk.knn_search(_tb(d["xs"]), _tb(d["xf"]), K, False, want_dists)
    j = jknn.knn_edge_aggregate_v3(
        _jb(d["u1"]), _jb(d["u2m"]), jnp.asarray(idx.numpy()),
        None if dists is None else jnp.asarray(dists.numpy()),
        _jb(d["w_d"]) if want_dists else None, tuple(map(_jb, d["hidden"])),
        jnp.float32(SEED) if dropout_p > 0 else None, 0.2, True, dropout_p, True, False)
    t = tkk.knn_edge_aggregate(_tb(d["u1"]), _tb(d["u2m"]), idx, dists,
                               _tb(d["w_d"]) if want_dists else None,
                               tuple(map(_tb, d["hidden"])), 0.2, True, dropout_p, SEED)
    _close(t, j)


# ---------------------------------------------------------------------------
# K6 and the distance glue: gradients against jax.grad
# ---------------------------------------------------------------------------


def _jax_grads(d, want_dists, dropout_p, need_wgrads):
    g = _jb(d["g"]).astype(jnp.float32)

    def f(xs, xf, u1, u2m, w_d, hidden):
        out = jknn.knn_fused_layer(xs, xf, u1, u2m, w_d, hidden,
                                   jnp.float32(SEED) if dropout_p > 0 else None, K, False,
                                   want_dists, 0.2, True, dropout_p, need_wgrads)
        return jnp.sum(out.astype(jnp.float32) * g)

    return jax.grad(f, argnums=(0, 1, 2, 3, 4, 5))(
        _jb(d["xs"]), _jb(d["xf"]), _jb(d["u1"]), _jb(d["u2m"]),
        _jb(d["w_d"]) if want_dists else None, tuple(map(_jb, d["hidden"])))


@pytest.mark.parametrize("want_dists,dropout_p,need_wgrads", [
    (True, 0.5, True), (True, 0.0, False), (False, 0.5, True)])
def test_knn_grads_bf16_match_jax_grad(want_dists, dropout_p, need_wgrads):
    """With weight gradients, the ``KnnFusedLayer`` Function (K5 forward, K6
    backward and the distance glue into ``xs`` and ``xf``) on every input;
    without them, the K6 plain version's own outputs. Every gradient in its
    primal's dtype (bf16)."""
    d = _inputs(seed=4)
    jg = _jax_grads(d, want_dists, dropout_p, need_wgrads)
    g = _tb(d["g"])
    if need_wgrads:
        ins = [_tb(d[k]).requires_grad_() for k in ("xs", "xf", "u1", "u2m")]
        w_d = _tb(d["w_d"]).requires_grad_() if want_dists else None
        hidden = [_tb(a).requires_grad_() for a in d["hidden"]]
        out = tkk.knn_aggregate(*ins, w_d, hidden, K, False, want_dists, 0.2, True, dropout_p,
                                SEED)
        (out.float() * g.float()).sum().backward()
        grads = [t.grad for t in ins] + [None if w_d is None else w_d.grad] + \
            [t.grad for t in hidden]
        refs = list(jg[:5]) + list(jg[5])
        if not want_dists:  # no gradient reaches xs, xf (the JAX VJP returns zeros)
            assert all(t is None for t in grads[:2])
            grads, refs = grads[2:], refs[2:]
    else:
        agg, idx, dists = tkk.knn_fused_layer(
            _tb(d["xs"]), _tb(d["xf"]), _tb(d["u1"]), _tb(d["u2m"]), _tb(d["w_d"]),
            tuple(map(_tb, d["hidden"])), K, False, True, 0.2, True, dropout_p, SEED, True)
        du1, du2, dmask, ddists, dw_d, dhidden = tkk.knn_edge_aggregate_bwd(
            _tb(d["u1"]), _tb(d["u2m"]), idx, dists, _tb(d["w_d"]),
            tuple(map(_tb, d["hidden"])), g, 0.2, True, dropout_p, SEED, need_wgrads=False)
        assert ddists.dtype == torch.float32
        assert not any(t.any() for t in dhidden) and not dw_d.any()
        grads, refs = [du1, torch.cat([du2, dmask], dim=-1)], list(jg[2:4])
    for t, j in zip(grads, refs):
        if j is None:
            assert t is None
            continue
        _close(t, j, scaled=True)


def test_knn_wrappers_refuse_a_mix_of_dtypes():
    d = _inputs()
    f32 = lambda a: torch.from_numpy(a)  # noqa: E731
    hidden = tuple(map(_tb, d["hidden"]))
    with pytest.raises(TypeError, match="all-float32 or all-bfloat16"):
        tkk.knn_fused_layer(_tb(d["xs"]), _tb(d["xf"]), f32(d["u1"]), _tb(d["u2m"]), None,
                            hidden, K, False, False, 0.2, True)
    with pytest.raises(TypeError, match="all-float32 or all-bfloat16"):
        tkk.knn_search(_tb(d["xs"]), f32(d["xf"]), K, False)
    idx, dists = tkk.knn_search(_tb(d["xs"]), _tb(d["xf"]), K, False, True)
    with pytest.raises(TypeError, match="dists must be float32"):
        tkk.knn_edge_aggregate(_tb(d["u1"]), _tb(d["u2m"]), idx, dists.bfloat16(), _tb(d["w_d"]),
                               hidden, 0.2, True)
    with pytest.raises(TypeError, match="all-float32 or all-bfloat16"):
        tkk.knn_edge_aggregate_bwd(_tb(d["u1"]), _tb(d["u2m"]), idx, dists, f32(d["w_d"]),
                                   hidden, _tb(d["g"]), 0.2, True)


# ---------------------------------------------------------------------------
# the bf16 steps, and the train CLI
# ---------------------------------------------------------------------------

KNN = dict(fully_connected=False, num_knn=3)


def jit_steps(pair, with_g=True, **flags):
    """``test_torch_bf16_steps._steps`` with the JAX D (and G) step under one
    ``jax.jit``, as the JAX loop runs them (a third of the eager steps' compile
    time here): the loss parts and the D and G gradients of both packages from
    the pair's states on the same batch and replayed draws."""
    jcfg, tcfg = pair.step_cfgs(**flags)
    js, ts = pair.jsuite, pair.tsuite
    data, labels = pair.batch()
    jargs_ = (jnp.asarray(data),) + ((jnp.asarray(labels),) if labels is not None else ())
    td = torch.from_numpy(data)
    tl = torch.from_numpy(labels) if labels is not None else None
    d_step, g_step = jts.make_train_steps(
        step_cfg=jcfg, g_apply=js.g_apply, d_apply=js.d_apply, g_cfg=js.g_cfg, d_cfg=js.d_cfg,
        spec=js.noise, g_opt=pair.g_opt, d_opt=pair.d_opt, use_labels=pair.use_labels,
        encode_real=js.encode_real, post_gen=js.post_gen)

    def steps(state, *args):
        # the recording optimizers keep this trace's gradients, returned as outputs
        s1, md = d_step(state, *args)
        out = (s1, md, pair.grads["d"])
        if with_g:
            s2, mg = g_step(s1, *args)
            out += (s2, mg, pair.grads["g"])
        return out

    j = jax.jit(steps)(pair.jstate, *jargs_)
    j0 = pair.jstate
    _, k_noise, k_real, k_fake, k_gp_drop, k_gp, *_ = jax.random.split(j0.rng, 9)
    noise, _ = js.noise.sample(k_noise, len(data))
    alpha = jax.random.uniform(k_gp, (len(data),) + (1,) * (data.ndim - 1))
    td_parts = tts.d_step(pair.tstate, tcfg, ts.noise, td, tl, draws=tts.DDraws(
        torch.from_numpy(np.array(noise)), port_keys(k_real), port_keys(k_fake), None,
        port_keys(k_gp_drop), torch.from_numpy(np.array(alpha))), post_gen=ts.post_gen)
    out = {"d": (j[1], td_parts, j[2], _port_grads(pair.tstate.d))}
    if with_g:
        _, k_noise, k_g, k_d, _ = jax.random.split(j[0].rng, 5)
        noise, _ = js.noise.sample(k_noise, len(data))
        tg = tts.g_step(pair.tstate, tcfg, ts.noise, td, tl, draws=tts.GDraws(
            torch.from_numpy(np.array(noise)), port_keys(k_g), port_keys(k_d)), post_gen=ts.post_gen)
        out["g"] = (j[4], tg, j[5], _port_grads(pair.tstate.g))
    return out


def check_bf16_steps(out):
    """The loss parts within LOSS_TOL and every gradient within GRAD_SHARE of
    its largest, D's and G's; the master parameters float32."""
    for part in ("d", "g"):
        if part not in out:
            continue
        jl, tl, jgrads, tgrads = out[part]
        assert set(tl) == set(jl)
        for k in jl:
            np.testing.assert_allclose(tl[k].numpy(), np.asarray(jl[k]), **LOSS_TOL)
        _check_grads(tgrads, jgrads, GRAD_SHARE)


@pytest.mark.parametrize("family,use_pallas", [("mp", True), ("mp", False), ("mplfc", None)],
                         ids=["mp-kernels", "mp-plain", "mplfc"])
def test_bf16_knn_steps_match_jax(family, use_pallas):
    """The knn MPGAN pair on the kernel path (the K5 and K6 plain versions
    against the Pallas kernels in interpret mode) and on the plain path, and
    the legacy knn pair: one bf16 D and G step of each package from the same
    weights and draws."""
    card, post = _card(family)
    card = dict(card, **KNN)
    if use_pallas is not None:
        card = dict(card, use_pallas=use_pallas)
    pair = _Pair(card, post)
    check_bf16_steps(jit_steps(pair, bf16=True))
    for m in (pair.tstate.g, pair.tstate.d):
        assert all(p.dtype == torch.float32 for p in m.parameters())


def test_train_cli_bf16_knn_trains_and_resumes(tmp_path):
    argv = ["--device", "cpu", "--name", "bk", "--dir-path", str(tmp_path), "--model", "mpgan",
            "--jets", "g", "--num-hits", "8", "--hidden-node-size", "8", "--fe", "12", "16",
            "--fn", "16", "--no-fully-connected", "--num-knn", "3", "--batch-size", "16",
            "--num-samples", "100", "--eval-tot-samples", "64", "--w1-num-samples", "50",
            "--save-epochs", "2", "--save-model-epochs", "1", "--compute-dtype", "bfloat16"]
    t = ttrain_cli.main(argv + ["--num-epochs", "2"])
    assert t.step_cfg.bf16 and np.isfinite(t.losses["G"]).all()
    t3 = ttrain_cli.main(argv + ["--num-epochs", "3"])
    assert t3.start_epoch == 2 and len(t3.losses["G"]) == 3
    assert t3.losses["G"][:2] == t.losses["G"]
    assert all(p.dtype == torch.float32 for p in t3.state.g.parameters())
