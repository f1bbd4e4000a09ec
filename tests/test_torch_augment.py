"""The PyTorch port's augmentation and augmented train steps against the JAX package.

- each transform and the composed ``augment`` on JAX's own draws (the uniforms
  and normals of its split keys, handed to the port), within 1e-6;
- the JAX package raises on a cloud with a fourth feature (a masked jet), and
  the port transforms the first two columns only: the same function on the
  first three, the rest untouched;
- one D step and one G step with all four ``--aug-*`` flags, ``aug_prob`` 0.5,
  dropout 0.5 and WGAN-GP (10) on a narrow dense card, from the same state and
  draws (the JAX key splits of ``train_step.py:182-183, 261-262`` and of
  ``augment``, replayed): losses and gradients within 1e-4;
- the real pass sees unaugmented data: the port's Dr equals JAX's and differs
  from D on the augmented real batch.

:class:`StepPair` (both packages' suites, a JAX-initialised TrainState and the
port's holding its weights, one replayed D and G step) is shared with
``test_torch_mnist.py``.
"""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one thread a test worker: the suite runs in parallel workers

import jax
import jax.numpy as jnp

from mpgan_tpu.models import registry as jregistry
from mpgan_tpu.ops import augment as jaug
from mpgan_tpu.training import config as jconfig
from mpgan_tpu.training import optimizers as jopt
from mpgan_tpu.training import train_step as jts
from mpgan_tpu_torch.ops import prng
from mpgan_tpu_torch.data.jetnet import JetNetDataset
from mpgan_tpu_torch.models import registry as tregistry
from mpgan_tpu_torch.ops import augment as taug
from mpgan_tpu_torch.training import config as tconfig
from mpgan_tpu_torch.training import optimizers as topt
from mpgan_tpu_torch.training import train_step as tts
from mpgan_tpu_torch.utils.weights import jax_leaves, load_jax_trees, tree_leaves

from test_torch_ops import port_keys  # the port's keys of a JAX key

torch.backends.cuda.matmul.allow_tf32 = False
AUG_TOL = dict(rtol=1e-6, atol=1e-6)
STEP_TOL = dict(rtol=1e-4, atol=1e-4)
ALL = dict(aug_t=True, aug_f=True, aug_r90=True, aug_s=True)
# a narrow dense card without masks (3 features, as the JAX augmentation needs)
AUG_CARD = {"model": "mpgan", "jets": "g", "num_hits": 10, "hidden_node_size": 8,
            "fe": [12, 16], "fn": [16], "mask_c": False, "loss": "w", "gp": 10.0,
            "disc_dropout": 0.5, "aug_prob": 0.5, **ALL}


def _clouds(b=5, n=7, f=3, seed=0):
    return np.random.default_rng(seed).normal(size=(b, n, f)).astype(np.float32)


def jax_draws(cfg, rng, b) -> taug.AugmentDraws:
    """The uniforms and normals ``mpgan_tpu.ops.augment.augment`` draws from ``rng``."""
    k = jax.random.split(rng, 8)
    u = lambda key, *s: torch.from_numpy(np.array(jax.random.uniform(key, (b,) + s)))  # noqa
    draws = taug.AugmentDraws()
    if cfg.aug_r90:
        draws.r90 = (u(k[0], 1, 1), u(k[1], 1, 1))
    if cfg.aug_f:
        draws.flip = (u(k[2], 1, 1), u(k[3], 1, 2))
    if cfg.aug_t:
        draws.translate = (u(k[4], 1, 1), u(k[5], 1, 2))
    if cfg.aug_s:
        draws.scale = (u(k[6], 1, 1),
                       torch.from_numpy(np.array(jax.random.normal(k[7], (b, 1, 1)))))
    return draws


@pytest.mark.parametrize("which", ["flip", "r90", "translate", "scale", "mix"])
def test_each_transform_matches_jax(which):
    x = _clouds()
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    key = jax.random.PRNGKey(3)
    if which == "flip":
        j = jaug._rand_flip(key, jx)
        t = taug._rand_flip(torch.from_numpy(np.array(jax.random.uniform(key, (5, 1, 2)))), tx)
    elif which == "r90":
        j = jaug._rand_90_rotation(key, jx)
        t = taug._rand_90_rotation(
            torch.from_numpy(np.array(jax.random.uniform(key, (5, 1, 1)))), tx)
    elif which == "translate":
        j = jaug._rand_translate(key, jx, 0.125)
        t = taug._rand_translate(
            torch.from_numpy(np.array(jax.random.uniform(key, (5, 1, 2)))), tx, 0.125)
    elif which == "scale":
        j = jaug._rand_scale(key, jx, 0.125)
        t = taug._rand_scale(
            torch.from_numpy(np.array(jax.random.normal(key, (5, 1, 1)))), tx, 0.125)
    else:
        y = _clouds(seed=1)
        j = jaug._rand_mix(key, jx, jnp.asarray(y), 0.5)
        t = taug._rand_mix(torch.from_numpy(np.array(jax.random.uniform(key, (5, 1, 1)))), tx,
                           torch.from_numpy(y), 0.5)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **AUG_TOL)
    if which != "mix":
        assert not np.allclose(t.numpy(), x)


@pytest.mark.parametrize("p", [0.5, 1.0])
@pytest.mark.parametrize("flags", [ALL, dict(aug_r90=True), dict(aug_f=True, aug_s=True),
                                   dict(aug_t=True)], ids=["all", "r90", "f_s", "t"])
def test_augment_matches_jax(flags, p):
    x = _clouds(b=16, n=9)
    rng = jax.random.PRNGKey(7)
    jcfg = jaug.AugmentConfig(**flags, translate_ratio=0.2, scale_sd=0.3)
    tcfg = taug.AugmentConfig(**flags, translate_ratio=0.2, scale_sd=0.3)
    j = jaug.augment(jcfg, rng, jnp.asarray(x), p)
    t = taug.augment(tcfg, torch.from_numpy(x), p, jax_draws(tcfg, rng, 16))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **AUG_TOL)
    # intensity (the third feature) is left alone
    np.testing.assert_array_equal(t.numpy()[..., 2], x[..., 2])


def test_masked_clouds_jax_raises_the_port_keeps_later_features():
    """A fourth feature (the mask column of a masked jet card): the JAX
    transforms' 3-column factors do not broadcast; the port touches the two
    coordinates only, which equals JAX on the first three features."""
    x = _clouds(b=8, n=6, f=4)
    rng = jax.random.PRNGKey(2)
    jcfg, tcfg = jaug.AugmentConfig(**ALL), taug.AugmentConfig(**ALL)
    with pytest.raises((TypeError, ValueError)):
        jaug.augment(jcfg, rng, jnp.asarray(x), 1.0)
    t = taug.augment(tcfg, torch.from_numpy(x), 1.0, jax_draws(tcfg, rng, 8)).numpy()
    j3 = np.asarray(jaug.augment(jcfg, rng, jnp.asarray(x[..., :3]), 1.0))
    np.testing.assert_allclose(t[..., :3], j3, **AUG_TOL)
    np.testing.assert_array_equal(t[..., 3], x[..., 3])


def test_draw_augment_draws_the_enabled_transforms_from_the_key():
    cfg = taug.AugmentConfig(aug_f=True, aug_s=True)
    a = taug.draw_augment(cfg, prng.PRNGKey(1), 6)
    b = taug.draw_augment(cfg, prng.PRNGKey(1), 6)
    assert a.r90 is None and a.translate is None
    assert [t.shape for t in a.flip] == [(6, 1, 1), (6, 1, 2)]
    assert [t.shape for t in a.scale] == [(6, 1, 1), (6, 1, 1)]
    assert all(torch.equal(x, y) for x, y in zip(a.flip + a.scale, b.flip + b.scale))
    # the loop's step config carries no augmentation where no transform is on
    args = types.SimpleNamespace(loss="ls", gp=0.0, label_smoothing=False, label_noise=0.0,
                                 translate_ratio=0.125, scale_sd=0.125, aug_prob=1.0,
                                 aug_t=False, aug_f=False, aug_r90=False, aug_s=False)
    assert tts.step_config(args).augment is None
    args.aug_s = True
    assert tts.step_config(args).augment == taug.AugmentConfig(aug_s=True)


# ---------------------------------------------------------------------------
# one D step and one G step
# ---------------------------------------------------------------------------


def _np(tree):
    return jax.tree.map(np.asarray, tree)


class StepPair:
    """Both packages' suites for ``card`` (``post``: attributes set after the
    args processing, as ``cli.train_mnist`` does), a JAX-initialised TrainState
    and the port's TrainState holding its weights; JAX's optimizers keep the
    gradients they are handed."""

    def __init__(self, card, post=None):
        self.jargs, self.targs = (_args(config, card, post) for config in (jconfig, tconfig))
        self.jsuite, self.tsuite = jregistry.build_suite(self.jargs), \
            tregistry.build_suite(self.targs)
        self.grads = {}
        a = self.jargs
        g_opt = self._recording(jopt.build_optimizer(a.optimizer, a.lr_gen), "g")
        d_opt = self._recording(jopt.build_optimizer(a.optimizer, a.lr_disc), "d")
        self.g_opt, self.d_opt = g_opt, d_opt
        js = self.jsuite
        self.jstate = jts.init_train_state(jax.random.PRNGKey(0), js.g_init, js.d_init,
                                           js.g_cfg, js.d_cfg, g_opt, d_opt)
        g, d = self.tsuite.generator(prng.PRNGKey(5)), \
            self.tsuite.discriminator()
        load_jax_trees(g, _np(self.jstate.g_params), _np(self.jstate.g_state))
        load_jax_trees(d, _np(self.jstate.d_params), _np(self.jstate.d_state))
        t = self.targs
        self.tstate = tts.TrainState(g, d, topt.build_optimizer(t.optimizer, g.parameters(),
                                                                t.lr_gen),
                                     topt.build_optimizer(t.optimizer, d.parameters(), t.lr_disc),
                                     prng.PRNGKey(0))

    def _recording(self, opt, name):
        import optax

        def update(grads, state, params=None):
            self.grads[name] = grads
            return opt.update(grads, state, params)
        return optax.GradientTransformation(opt.init, update)

    def step_cfgs(self):
        a = self.jargs
        flags = dict(aug_t=a.aug_t, aug_f=a.aug_f, aug_r90=a.aug_r90, aug_s=a.aug_s,
                     translate_ratio=a.translate_ratio, scale_sd=a.scale_sd)
        common = dict(loss=a.loss, gp_lambda=a.gp, aug_prob=a.aug_prob)
        return (jts.StepConfig(augment=jaug.AugmentConfig(**flags), **common),
                tts.StepConfig(augment=taug.AugmentConfig(**flags), **common))

    def run(self, data):
        """One D step and one G step in both packages on ``data`` (no labels)
        with JAX's draws; returns both packages' loss parts and the port's
        D and G gradients."""
        js, b = self.jsuite, len(data)
        jcfg, tcfg = self.step_cfgs()
        d_step, g_step = jts.make_train_steps(
            step_cfg=jcfg, g_apply=js.g_apply, d_apply=js.d_apply, g_cfg=js.g_cfg,
            d_cfg=js.d_cfg, spec=js.noise, g_opt=self.g_opt, d_opt=self.d_opt,
            use_labels=False)
        jd, td = jnp.asarray(data), torch.from_numpy(data)
        aug = tcfg.augment

        j0 = self.jstate
        _, k_noise, k_real, k_fake, k_gp_drop, k_gp, _, k_aug_r, k_aug_f = \
            jax.random.split(j0.rng, 9)
        noise, _ = js.noise.sample(k_noise, b)
        alpha = torch.from_numpy(np.array(jax.random.uniform(k_gp, (b, 1, 1))))
        self.d_draws = tts.DDraws(
            torch.from_numpy(np.array(noise)), port_keys(k_real), port_keys(k_fake), None,
            port_keys(k_gp_drop), alpha, *(None if aug is None else jax_draws(aug, k, b)
                                         for k in (k_aug_r, k_aug_f)))
        j1, jd_parts = d_step(j0, jd)
        td_parts = tts.d_step(self.tstate, tcfg, self.tsuite.noise, td, None,
                              draws=self.d_draws)
        d_grads = [p.grad.clone() for p in jax_leaves(self.tstate.d, True)]

        _, k_noise, k_g, k_d, k_aug = jax.random.split(j1.rng, 5)
        noise, _ = js.noise.sample(k_noise, b)
        j2, jg_parts = g_step(j1, jd)
        tg_parts = tts.g_step(self.tstate, tcfg, self.tsuite.noise, td, None, draws=tts.GDraws(
            torch.from_numpy(np.array(noise)), port_keys(k_g), port_keys(k_d),
            None if aug is None else jax_draws(aug, k_aug, b)))
        g_grads = [p.grad for p in jax_leaves(self.tstate.g, True)]
        return (jd_parts, td_parts, jg_parts, tg_parts), (d_grads, g_grads)

    def check(self, data):
        (jd, td, jg, tg), (d_grads, g_grads) = self.run(data)
        assert set(td) == set(jd)
        for k in jd:
            np.testing.assert_allclose(td[k].numpy(), np.asarray(jd[k]), **STEP_TOL)
        np.testing.assert_allclose(tg["G"].numpy(), np.asarray(jg["G"]), **STEP_TOL)
        for name, ours in (("d", d_grads), ("g", g_grads)):
            theirs = tree_leaves(_np(self.grads[name]))
            assert len(ours) == len(theirs)
            for t, g in zip(ours, theirs):
                np.testing.assert_allclose(t.numpy(), g, **STEP_TOL)
        return td


def _args(config, card, post=None):
    args = config.from_args_dict(card)
    for key, value in (post or {}).items():
        setattr(args, key, value)
    return args


def _jets(card, b=6):
    ds = JetNetDataset("g", num_particles=card["num_hits"], synthetic_num_jets=200,
                       mask_feature=False)
    return ds.particle_data[:b]


@pytest.mark.parametrize("use_pallas", [True, False])
def test_augmented_d_step_and_g_step_match_jax(use_pallas):
    """G on the kernel path or not (D is pinned to the plain path by the GP)."""
    card = dict(AUG_CARD, use_pallas=use_pallas)
    pair = StepPair(card)
    assert pair.tstate.d.cfg.use_kernels is False and pair.step_cfgs()[1].augment is not None
    data = _jets(card)
    assert data.shape[-1] == 3
    parts = pair.check(data)
    assert set(parts) == {"Dr", "Df", "D", "gp"}


def test_real_pass_sees_unaugmented_data():
    """With every transform mixed in (``aug_prob`` 1), D on the augmented real
    batch differs from the Dr that both packages compute on the real batch."""
    card = dict(AUG_CARD, aug_prob=1.0, disc_dropout=0.0)
    pair = StepPair(card)
    data = _jets(card)
    aug = pair.step_cfgs()[1].augment
    k_aug_r = jax.random.split(pair.jstate.rng, 9)[7]  # the D step's real-batch draws
    with torch.no_grad():
        real_aug = taug.augment(aug, torch.from_numpy(data), 1.0,
                                jax_draws(aug, k_aug_r, len(data)))
        dr_aug = -pair.tstate.d(real_aug, None, update_sn=False).mean().item()
    parts = pair.check(data)
    assert abs(parts["Dr"].item() - dr_aug) > 1e-3
