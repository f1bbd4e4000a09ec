"""bf16 mixed-precision training steps (``StepConfig.bf16``) and the batched
real+fake D pass (``StepConfig.batched_d``) in the port against the JAX
package on the CPU.

- the bf16 D and G steps of the mpgan pair (plain and kernel path), the legacy
  pair and the rGAN/PointNet pair against JAX's from the same weights and
  draws: loss parts within rtol = atol = 2e-2 (a D output rounded to bf16
  moves by 2^-8 of itself), every gradient within 0.15 of the tensor's largest
  (the two frameworks round each op's bf16 result at other points: XLA keeps
  float32 inside its fusions, PyTorch rounds after each op);
- every family of the reference's ``trained_models/`` takes a bf16 D and G
  step (finite losses, float32 master state);
- ``bf16_apply`` runs a module on bf16 copies and moves its buffers;
- three D+G steps in bf16 track the float32 steps (losses within 5%, the JAX
  package's own bound) and keep every master tensor float32;
- the batched real+fake D pass against JAX's for a GAPT pair and an MPGAN pair
  without BN or SN, within 1e-4.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one thread a test worker: the suite runs in parallel workers

import jax
import jax.numpy as jnp

from mpgan_tpu.models import registry as jregistry
from mpgan_tpu.training import config as jconfig
from mpgan_tpu.training import train_step as jts
from mpgan_tpu_torch.ops import prng
from mpgan_tpu_torch.data.jetnet import JetNetDataset
from mpgan_tpu_torch.models import registry as tregistry
from mpgan_tpu_torch.ops.linear import MLP, MLPConfig
from mpgan_tpu_torch.training import config as tconfig
from mpgan_tpu_torch.training import optimizers as topt
from mpgan_tpu_torch.training import train_step as tts
from mpgan_tpu_torch.utils.weights import jax_leaves, load_jax_trees, tree_leaves

from test_torch_ops import port_keys  # the port's keys of a JAX key
from test_torch_zoo import FAMILIES, _args, _card, _Family, _jax_opt, _np
from test_torch_zoo import pcgan_dir  # noqa: F401  (a fixture)

LOSS_TOL = dict(rtol=2e-2, atol=2e-2)
GRAD_SHARE = 0.15
STEP_TOL = dict(rtol=1e-4, atol=1e-4)
GAPT_CARD = {"model": "gapt", "jets": "g", "num_hits": 8, "gapt_embed_dim": 16,
             "num_heads": 2, "sab_layers_gen": 2, "sab_layers_disc": 1}


class _Pair(_Family):
    """Both packages' suites and states from one card (``_Family`` for any card)."""

    def __init__(self, card, post=None):
        self.jargs, self.targs = jconfig.from_args_dict(card), tconfig.from_args_dict(card)
        for a in (self.jargs, self.targs):
            for key, value in (post or {}).items():
                setattr(a, key, value)
        self.jsuite, self.tsuite = jregistry.build_suite(self.jargs), tregistry.build_suite(
            self.targs)
        self.grads = {}
        self.g_opt = self._recording(_jax_opt(self.jargs, self.jargs.lr_gen), "g")
        self.d_opt = self._recording(_jax_opt(self.jargs, self.jargs.lr_disc), "d")
        js = self.jsuite
        self.jstate = jts.init_train_state(jax.random.PRNGKey(0), js.g_init, js.d_init,
                                           js.g_cfg, js.d_cfg, self.g_opt, self.d_opt)
        self.tstate = self.port_state()
        load_jax_trees(self.tstate.g, _np(self.jstate.g_params), _np(self.jstate.g_state))
        load_jax_trees(self.tstate.d, _np(self.jstate.d_params), _np(self.jstate.d_state))
        self.use_labels = bool(self.jargs.get("mask_c") or self.jargs.clabels
                               or self.jargs.get("gapt_mask"))

    def step_cfgs(self, **flags):
        a = self.jargs
        return (jts.StepConfig(loss=a.loss, gp_lambda=a.gp, **flags),
                tts.StepConfig(loss=a.loss, gp_lambda=a.gp, **flags))


def _steps(pair, with_g=True, **flags):
    """One D step (and a G step) of both packages from the pair's states on the
    same batch and replayed draws; returns the loss parts and the D and G
    gradients of both (port gradients as float32 numpy)."""
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
    j0 = pair.jstate
    _, k_noise, k_real, k_fake, k_gp_drop, k_gp, *_ = jax.random.split(j0.rng, 9)
    noise, _ = js.noise.sample(k_noise, len(data))
    alpha = jax.random.uniform(k_gp, (len(data),) + (1,) * (data.ndim - 1))
    j1, jd = d_step(j0, *jargs_)
    td_parts = tts.d_step(pair.tstate, tcfg, ts.noise, td, tl, draws=tts.DDraws(
        torch.from_numpy(np.array(noise)), port_keys(k_real), port_keys(k_fake), None,
        port_keys(k_gp_drop), torch.from_numpy(np.array(alpha))), post_gen=ts.post_gen)
    out = {"d": (jd, td_parts, pair.grads["d"], _port_grads(pair.tstate.d))}
    if with_g:
        _, k_noise, k_g, k_d, _ = jax.random.split(j1.rng, 5)
        noise, _ = js.noise.sample(k_noise, len(data))
        j2, jg = g_step(j1, *jargs_)
        tg = tts.g_step(pair.tstate, tcfg, ts.noise, td, tl, draws=tts.GDraws(
            torch.from_numpy(np.array(noise)), port_keys(k_g), port_keys(k_d)), post_gen=ts.post_gen)
        out["g"] = (jg, tg, pair.grads["g"], _port_grads(pair.tstate.g))
        out["state"] = (j2, pair.tstate)
    return out


def _port_grads(module):
    return [None if p.grad is None else p.grad.numpy() for p in jax_leaves(module, True)]


def _check_grads(ours, theirs, share):
    theirs = tree_leaves(_np(theirs))
    assert len(ours) == len(theirs)
    for t, g in zip(ours, theirs):
        t = np.zeros_like(g) if t is None else t
        assert t.dtype == np.float32
        assert np.abs(t - g).max() <= share * max(np.abs(g).max(), 1e-6)


@pytest.mark.parametrize("family,use_pallas", [("mp", True), ("mp", False), ("mplfc", None),
                                               ("fcpnet", None)])
def test_bf16_steps_match_jax(family, use_pallas):
    """The mpgan pair on both paths (the kernel path: the K2/K3/K4 plain
    versions against the Pallas kernels in interpret mode), the legacy pair and
    the rGAN G / PointNet D pair with WGAN-GP (a bf16 double backward)."""
    card, post = _card(family)
    if use_pallas is not None:
        card = dict(card, use_pallas=use_pallas)
    pair = _Pair(card, post)
    out = _steps(pair, bf16=True)
    jd, td, jgrads, tgrads = out["d"]
    assert set(td) == set(jd)
    for k in jd:
        np.testing.assert_allclose(td[k].numpy(), np.asarray(jd[k]), **LOSS_TOL)
    _check_grads(tgrads, jgrads, GRAD_SHARE)
    jg, tg, jgrads, tgrads = out["g"]
    np.testing.assert_allclose(tg["G"].numpy(), np.asarray(jg["G"]), **LOSS_TOL)
    _check_grads(tgrads, jgrads, GRAD_SHARE)
    # the master state stays float32, BN and SN state included
    j2, st = out["state"]
    for t, leaf in zip(jax_leaves(st.g, False) + jax_leaves(st.d, False),
                       tree_leaves(_np(j2.g_state)) + tree_leaves(_np(j2.d_state))):
        assert t.dtype == torch.float32 and leaf.dtype == np.float32
        np.testing.assert_allclose(t.numpy(), leaf, **LOSS_TOL)
    for m in (st.g, st.d):
        assert all(p.dtype == torch.float32 for p in m.parameters())


@pytest.mark.parametrize("family", list(FAMILIES))
def test_every_zoo_family_takes_bf16_steps(family, pcgan_dir):  # noqa: F811
    """The ext families on plain PyTorch, the legacy and MPGAN Gs and Ds (on
    the CPU, the kernels' plain versions) in every pair the zoo trains."""
    weights = pcgan_dir if family == "pcgan" else None
    args = _args(tconfig, family, pcgan_dir if family == "pcgan" else "")
    suite = tregistry.build_suite(args, pcgan_weights_dir=weights)
    kg, kd = prng.split(prng.PRNGKey(0))
    g, d = suite.generator(kg), suite.discriminator(kd)
    opt = lambda m, lr: topt.build_optimizer(args.optimizer, m.parameters(), lr,  # noqa: E731
                                             beta1=args.beta1, beta2=args.beta2)
    st = tts.TrainState(g, d, opt(g, args.lr_gen), opt(d, args.lr_disc), prng.PRNGKey(0))
    ds = JetNetDataset("g", num_particles=args.num_hits, synthetic_num_jets=50,
                       mask_feature=bool(args.get("mask")))
    td = torch.from_numpy(ds.particle_data[:4])
    tl = torch.from_numpy(ds.jet_data[:4]) if args.get("mask_c") or args.clabels else None
    cfg = tts.StepConfig(loss=args.loss, gp_lambda=args.gp, bf16=True)
    parts = tts.d_step(st, cfg, suite.noise, td, tl, post_gen=suite.post_gen,
                       encode_real=suite.encode_real)
    parts.update(tts.g_step(st, cfg, suite.noise, td, tl, post_gen=suite.post_gen))
    assert all(np.isfinite(v.item()) for v in parts.values())
    for m in (st.g, st.d):
        assert all(t.dtype == torch.float32 for t in m.state_dict().values()
                   if t.is_floating_point())
        assert all(p.grad is None or p.grad.dtype == torch.float32 for p in m.parameters())


def test_bf16_apply_runs_the_module_in_bf16_and_moves_its_buffers():
    """``bf16_apply`` runs every layer on bf16 copies, returns float32 and
    copies the BN running statistics back (each passing through bf16)."""
    mlp = MLP(MLPConfig((5, 7, 3), batch_norm=True), prng.PRNGKey(0))
    seen = []
    mlp.register_forward_pre_hook(lambda m, a: seen.append((a[0].dtype, m.net[1].weight.dtype)))
    x = torch.randn(6, 5, generator=torch.Generator().manual_seed(1))

    class Wrap(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.mlp = mlp

        def forward(self, x, labels, train=False):
            return self.mlp(x, train=train)

    before = mlp.bn[0].running_mean.clone()
    out = tts.bf16_apply(Wrap(), x, None, train=True)
    assert out.dtype == torch.float32 and seen == [(torch.bfloat16, torch.bfloat16)]
    bn = mlp.bn[0]
    assert bn.running_mean.dtype == torch.float32 and not torch.equal(bn.running_mean, before)
    assert torch.equal(bn.running_mean, bn.running_mean.to(torch.bfloat16).float())
    assert all(p.dtype == torch.float32 and p.grad is None for p in mlp.parameters())
    out.sum().backward()
    assert all(p.grad is not None and p.grad.dtype == torch.float32 for p in mlp.parameters())


def test_three_bf16_steps_track_the_float32_steps():
    """The counterpart of ``tests/test_training.py:417-458``: three D+G steps
    from one state and one seed of draws, float32 and bf16: losses within 5%
    (the JAX package's bound), every master tensor float32, the first fe
    weight of G within rtol 0.1, atol 1e-4."""
    card = {"model": "mpgan", "jets": "g", "num_hits": 10, "hidden_node_size": 8, "fe": [12],
            "fn": [16], "gen_dropout": 0.0, "disc_dropout": 0.0}
    results = {}
    for bf16 in (False, True):
        pair = _Pair(card)  # the same JAX-initialised weights and seed of draws for both
        st = pair.tstate
        data, labels = pair.batch(16)
        td, tl = torch.from_numpy(data), torch.from_numpy(labels)
        cfg = tts.StepConfig(loss="ls", bf16=bf16)
        for _ in range(3):
            dm = tts.d_step(st, cfg, pair.tsuite.noise, td, tl)
            gm = tts.g_step(st, cfg, pair.tsuite.noise, td, tl)
        results[bf16] = (dm["D"].item(), gm["G"].item(), st)
    for i in (0, 1):
        np.testing.assert_allclose(results[True][i], results[False][i], rtol=0.05)
    st32, st16 = results[False][2], results[True][2]
    for m, opt in ((st16.g, st16.g_opt), (st16.d, st16.d_opt)):
        assert all(t.dtype == torch.float32 for t in m.state_dict().values()
                   if t.is_floating_point())
        assert all(v.dtype == torch.float32 for s in opt.state.values() for k, v in s.items()
                   if k != "step")
    w32 = st32.g.mp_layers[0].fe.net[0].weight.detach().numpy()
    w16 = st16.g.mp_layers[0].fe.net[0].weight.detach().numpy()
    np.testing.assert_allclose(w16, w32, rtol=0.1, atol=1e-4)
    assert not np.array_equal(w16, w32)


# ---------------------------------------------------------------------------
# the batched real+fake D pass
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("card", [GAPT_CARD, {"model": "mpgan", "jets": "g", "num_hits": 8,
                                              "hidden_node_size": 8, "fe": [8, 8], "fn": [8]}],
                         ids=["gapt", "mpgan"])
def test_batched_d_step_matches_jax(card):
    """One D step over [real | fake] with the real pass's keys, labels doubled,
    the output split at B: losses and D's gradients within 1e-4."""
    pair = _Pair(card)
    assert not pair.jargs.get("batch_norm_disc") and not pair.jargs.get("spectral_norm_disc")
    out = _steps(pair, with_g=False, batched_d=True)
    jd, td, jgrads, tgrads = out["d"]
    for k in jd:
        np.testing.assert_allclose(td[k].numpy(), np.asarray(jd[k]), **STEP_TOL)
    for t, g in zip(tgrads, tree_leaves(_np(jgrads))):
        np.testing.assert_allclose(np.zeros_like(g) if t is None else t, g, **STEP_TOL)
