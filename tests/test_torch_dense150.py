"""The 150-particle dense paths that ``bench.py`` times, in the port against the
JAX package on the CPU, and the float64 model of K3's bf16 mode.

- the ``--fe 128 256`` 150-particle generator (``bench.py``'s headline) at B=2:
  the port's kernel path (the kernels' plain versions) and plain path against
  ``mp_generator_apply`` on its jnp path, the JAX weights carried across by
  ``utils.weights.mp_generator_from_jax``; rtol = atol = 1e-4, the mask column
  bit-identical;
- the 150-particle dense D+G step at B=2 with narrow fe widths
  (:func:`step_matches_jax`, run by ``test_torch_dense150_step.py`` and
  ``test_torch_dense150_step_bf16.py``), both packages
  from one JAX TrainState (``utils.weights.load_jax_trees``) and the same
  draws, D's last layer scaled in both so that every gradient is live: the
  port's kernel path (the kernels' plain versions) against JAX's jnp path,
  losses and every gradient at 1e-4 in FP32; the port's bf16 step against
  JAX's float32 one at JAX's bf16 tolerances (losses 2e-2, gradients 0.15
  of the tensor's largest). D's
  dropout is 0: the kernel path's hash ids and the jnp path's differ, as in
  JAX, and JAX's Pallas path in interpret mode, which draws the kernel
  path's masks, takes 35 s more a step at N=150 (the lattice tests hold the
  masks at small N);
- ``chip_smoke.edge_model64`` (the float64 model of a K2 or K3 call in the
  bf16 mode, autograd over its own forward) in the FP32 mode on float64
  inputs against the plain versions run in float64, to 1e-12; in the bf16
  mode within a bf16 step of the plain versions;
- ``chip_smoke.py`` phase 33's rule for a dense bf16 ``x`` gradient
  (``lattice_x_call_over``) on the ``k4`` and ``cond1`` recipes (their
  configurations, seeds and inputs at B=4): the plain versions' K3 calls
  lie within their envelopes of the model.
"""

from __future__ import annotations

import dataclasses
import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one thread a test worker: the suite runs in parallel workers

import jax.numpy as jnp  # noqa: E402

from mpgan_tpu.models.mpgan import mp_generator_apply  # noqa: E402
from mpgan_tpu_torch.ops import mp_kernels as mk  # noqa: E402
from mpgan_tpu_torch.utils.weights import load_jax_trees  # noqa: E402

from test_torch_bf16_steps import _np, _Pair, _check_grads, _steps, tree_leaves  # noqa: E402
from test_torch_generator import _inputs, _pair  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (phase 33's recipes and its x-gradient rule)

torch.backends.cuda.matmul.allow_tf32 = False
TOL = dict(rtol=1e-4, atol=1e-4)
BF16_LOSS_TOL = dict(rtol=2e-2, atol=2e-2)
BF16_GRAD_SHARE = 0.15
# the D+G step's card: 150 particles, dense, the flagship's flags at narrow widths and
# one MP iteration (the JAX side's compile is most of the test's time)
STEP_CARD = {"model": "mpgan", "jets": "g", "num_hits": 150, "hidden_node_size": 8,
             "fe": [12, 16], "fn": [16], "mp_iters": 1, "use_pallas": False,
             "disc_dropout": 0.0}


@pytest.mark.parametrize("use_kernels", [True, False])
def test_fe128_256_generator_matches_jax(use_kernels):
    """``bench.py``'s headline generator: 150 particles, fe [128, 256]."""
    jcfg, params, state, g = _pair({"model": "mpgan", "jets": "g", "num_hits": 150,
                                    "fe": [128, 256]})
    assert [layer.fe.sizes[1:] for layer in g.cfg.layers] == [(128, 256)] * 2
    noise, labels = _inputs(jcfg, 2)
    yj, _ = mp_generator_apply(dataclasses.replace(jcfg, use_pallas=False), params, state,
                               jnp.asarray(noise), jnp.asarray(labels))
    g.cfg = dataclasses.replace(g.cfg, use_kernels=use_kernels)
    with torch.inference_mode():
        yt = g(torch.from_numpy(noise), torch.from_numpy(labels)).numpy()
    yj = np.asarray(yj)
    assert yt.shape == yj.shape == (2, 150, 4)
    np.testing.assert_allclose(yt, yj, **TOL)
    np.testing.assert_array_equal(yt[..., -1], yj[..., -1])
    np.testing.assert_array_equal((yt[..., -1] + 0.5).sum(1), np.round(labels[:, 0] * 150))


class _Pair2(_Pair):
    """Both packages' 150-particle dense suites and states, batches of 2 jets,
    D's last layer scaled by ``chip_smoke.UNSATURATE`` in both: unscaled, the
    untrained D's logits at 150 particles saturate float32's sigmoid and every
    gradient of the step is 0 (``chip_smoke.unsaturated``)."""

    def __init__(self, card):
        super().__init__(card)
        last = self.jstate.d_params["fnd"]["layers"]
        last[-1] = {k: v * chip_smoke.UNSATURATE for k, v in last[-1].items()}
        load_jax_trees(self.tstate.d, _np(self.jstate.d_params), _np(self.jstate.d_state))

    def batch(self, b=2):
        return super().batch(b)

    def step_cfgs(self, bf16=False):
        """JAX's step in float32, the port's in bf16 where asked: JAX's bf16
        rule holds a bf16 step to the float32 one. (JAX's own jnp path in
        bf16 lies 36-81% of the tensor's largest from its float32 gradients
        in D's fe biases here, sums over 45,000 edges.)"""
        return super().step_cfgs()[0], super().step_cfgs(bf16=bf16)[1]


def step_matches_jax(bf16: bool) -> None:
    """One D step and one G step of both packages from one state and the same
    draws, every model's gradient nonzero: the port's kernel path (in bf16
    where asked) against JAX's jnp path in float32 (the test of
    ``test_torch_dense150_step.py`` and ``test_torch_dense150_step_bf16.py``,
    a file each: the JAX side's compiles take about 45 s a case)."""
    pair = _Pair2(STEP_CARD)
    for model in (pair.tstate.g, pair.tstate.d):
        assert all(layer.fully_connected for layer in model.cfg.layers)
        model.cfg = dataclasses.replace(model.cfg, use_kernels=True)
    out = _steps(pair, bf16=bf16)
    (jd, td, jd_grads, td_grads), (jg, tg, jg_grads, tg_grads) = out["d"], out["g"]
    for name, grads in (("D", jd_grads), ("G", jg_grads)):  # a live step, not a vacuous one
        assert any(np.abs(g).max() > 0 for g in tree_leaves(_np(grads))), \
            f"every gradient of JAX's {name} step is 0"
    assert set(td) == set(jd)
    loss_tol = BF16_LOSS_TOL if bf16 else TOL
    for k in jd:
        np.testing.assert_allclose(td[k].numpy(), np.asarray(jd[k]), **loss_tol)
    np.testing.assert_allclose(tg["G"].numpy(), np.asarray(jg["G"]), **loss_tol)
    for ours, theirs in ((td_grads, jd_grads), (tg_grads, jg_grads)):
        _check_grads(ours, theirs, BF16_GRAD_SHARE if bf16 else TOL["atol"])


def _edge_inputs(dtype, seed=0, b=2, n=11, widths=(12, 16, 8)):
    """A K2/K3 call's inputs and the gradient of its aggregate, from ``seed``."""
    rng = np.random.RandomState(seed)

    def t(*shape, scale=1.0):
        return torch.from_numpy(rng.randn(*shape) * scale).to(dtype)

    hidden = []
    for a, c in zip(widths[:-1], widths[1:]):
        hidden += [t(a, c, scale=a ** -0.5), t(c, scale=0.1)]
    mask = torch.from_numpy((rng.rand(b, n, 1) > 0.3).astype(np.float64)).to(dtype)
    return dict(u1=t(b, n, widths[0], scale=0.5), u2=t(b, n, widths[0], scale=0.5), mask=mask,
                hidden=hidden, g=t(b, n, widths[-1]))


def _call(d, sum_agg, dropout_p, seed, g=True):
    """A K2 call (a K3 call with ``g``) as ``chip_smoke.lattice_x_calls`` records it."""
    c = dict(u1=d["u1"], u2=d["u2"], m=d["mask"], hidden=d["hidden"], alpha=0.2,
             sum_agg=sum_agg, p=dropout_p, seed=seed)
    return {**c, "g": d["g"]} if g else c


@pytest.mark.parametrize("sum_agg,dropout_p", [(True, 0.0), (False, 0.0), (True, 0.5)])
def test_edge_model64_is_the_plain_version_in_float64(sum_agg, dropout_p):
    """On float64 inputs (the FP32 mode) the model, autograd over its own
    forward, equals the plain versions of K2 and K3 run in float64."""
    d = _edge_inputs(torch.float64)
    args = (d["u1"], d["u2"], d["mask"], d["hidden"])
    agg = chip_smoke.edge_model64(_call(d, sum_agg, dropout_p, 7, g=False))
    want = mk.edge_aggregate_reference(*args, 0.2, sum_agg, dropout_p, 7)
    assert agg.dtype == want.dtype == torch.float64
    torch.testing.assert_close(agg, want, rtol=1e-12, atol=1e-12)
    du = chip_smoke.edge_model64(_call(d, sum_agg, dropout_p, 7))
    want = mk.edge_aggregate_bwd_reference(*args, d["g"], 0.2, sum_agg, dropout_p, 7)
    for a, b in zip(du, want[:2]):
        assert a.dtype == b.dtype == torch.float64
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)


def test_edge_model64_bf16_rounds_as_the_plain_version():
    """In the bf16 mode the model's aggregate, du1 and du2 are bf16 values
    within a bf16 step of the plain versions' largest, and a jittered model
    (a float32 implementation that sums in another order) stays as close."""
    d = _edge_inputs(torch.bfloat16, seed=2)
    args = (d["u1"], d["u2"], d["mask"], d["hidden"])
    plain = (mk.edge_aggregate_reference(*args, 0.2, True, 0.5, 9),
             *mk.edge_aggregate_bwd_reference(*args, d["g"], 0.2, True, 0.5, 9)[:2])
    for jitter in (None, torch.Generator().manual_seed(0)):
        model = (chip_smoke.edge_model64(_call(d, True, 0.5, 9, g=False), jitter),
                 *chip_smoke.edge_model64(_call(d, True, 0.5, 9), jitter))
        for a, b in zip(model, plain):
            assert a.dtype == torch.float64
            assert torch.equal(chip_smoke.bf16_round(a), a)
            scale = b.double().abs().max()
            assert (a - b.double()).abs().max() <= 2 * chip_smoke.bf16_ulp(scale)


@pytest.mark.parametrize("case", ["k4", "cond1"])
def test_lattice_x_envelope_holds_the_plain_versions(case):
    """Phase 33's rule on the ``k4`` (the K4 route: K3 on the gradient fn
    hands the recomputed aggregate) and ``cond1`` (K2 and K3 with dropout,
    conditioned) recipes at B=4: each K3 call of the plain versions, carried
    to ``x``, lies within its envelope of the float64 model, the envelope one
    bf16 ulp of du carried through ``|W1|`` or more at every element."""
    s = {**next(p for p in chip_smoke.lattice_points() if p["case"] == case), "b": 4}
    d = chip_smoke.lattice_inputs(s, "cpu")
    layer, _ = chip_smoke.lattice_layer(chip_smoke.lattice_cfg(s, s["dropout_p"]), s, "cpu")
    rec = {}
    chip_smoke.lattice_run(layer, d, True, torch.bfloat16, parts=rec)
    assert len(rec["k2"]) == len(rec["k3"]) == 1
    over = chip_smoke.lattice_x_call_over(rec["k3"][0], rec["w1"], rec["f"])
    assert over["x"].shape == d["x"][..., :rec["f"]].shape
    assert (over["x"] <= 1.0).all()
