"""The PyTorch port's train step against the JAX package.

- the discriminator (eval and train, plain and kernel path);
- one ``d_step`` and one ``g_step`` from the same JAX-initialised state, batch
  and draws: the JAX key splits (``train_step.py:182-183, 261-262``) are
  replayed here and handed to the port, so both draw the same noise and
  dropout masks. Losses within 1e-5, gradients within 1e-4; updated params are
  compared where the gradient is clear of zero (RMSprop's first step is about
  ``10 * lr * sign(g)``).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one thread a test worker: the suite runs in parallel workers

import jax
import jax.numpy as jnp

from mpgan_tpu.models.mpgan import (
    mp_discriminator_apply,
    mp_discriminator_init,
    mp_generator_apply,
    mp_generator_init,
)
from mpgan_tpu.models import registry as jregistry
from mpgan_tpu.training import config as jconfig
from mpgan_tpu.training import losses as jlosses
from mpgan_tpu.training import optimizers as jopt
from mpgan_tpu.training import sampling as jsampling
from mpgan_tpu.training import train_step as jts
from mpgan_tpu_torch.ops import prng
from mpgan_tpu_torch.data.jetnet import JetNetDataset
from mpgan_tpu_torch.models import registry as tregistry
from mpgan_tpu_torch.ops.augment import AugmentConfig
from mpgan_tpu_torch.training import config as tconfig
from mpgan_tpu_torch.training import optimizers as topt
from mpgan_tpu_torch.training import sampling as tsampling
from mpgan_tpu_torch.training import train_step as tts
from mpgan_tpu_torch.training.loop import check_supported
from mpgan_tpu_torch.utils.weights import (
    jax_leaves,
    mp_discriminator_from_jax,
    mp_generator_from_jax,
)

from test_torch_ops import port_keys  # the port's keys of a JAX key

torch.backends.cuda.matmul.allow_tf32 = False
FWD_TOL = dict(rtol=1e-5, atol=1e-5)
BWD_TOL = dict(rtol=1e-4, atol=1e-4)
NARROW = {"model": "mpgan", "num_hits": 10, "hidden_node_size": 8, "fe": [12, 16], "fn": [16]}
# the 150-particle knn-20 mode at small size: knn layers, self loops, no distance feature
KNN = dict(NARROW, fully_connected=False, num_knn=4)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _batch(card, b, seed=0):
    ds = JetNetDataset("g", num_particles=card["num_hits"], synthetic_num_jets=200, seed=seed)
    return ds.particle_data[:b], ds.jet_data[:b]


# ---------------------------------------------------------------------------
# discriminator
# ---------------------------------------------------------------------------


def _disc_pair(card, seed=0):
    jcfg = jconfig.build_mpgan_discriminator(jconfig.from_args_dict(card))
    tcfg = tconfig.build_mpgan_discriminator(tconfig.from_args_dict(card))
    params, state = mp_discriminator_init(jax.random.PRNGKey(seed), jcfg)
    return jcfg, params, state, mp_discriminator_from_jax(_np(params), _np(state), tcfg)


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("extra", [{}, {"mean": True, "fnd": [8]}, {"spectral_norm_disc": True}])
def test_discriminator_matches_jax(train, use_pallas, extra):
    card = dict(NARROW, **{k: v for k, v in extra.items() if k != "mean"})
    if extra.get("mean"):
        card["sum"] = False
    jcfg, params, state, d = _disc_pair(card)
    data, labels = _batch(card, 4)
    key = jax.random.PRNGKey(5)
    yj, _ = mp_discriminator_apply(dataclasses.replace(jcfg, use_pallas=use_pallas), params, state,
                                   jnp.asarray(data), jnp.asarray(labels), train=train,
                                   rng=key if train else None)
    d.cfg = dataclasses.replace(d.cfg, use_kernels=use_pallas)
    yt = d(torch.from_numpy(data), torch.from_numpy(labels), train=train,
           rng=port_keys(key) if train else None)
    assert yt.shape == (4, 1)
    np.testing.assert_allclose(yt.detach().numpy(), np.asarray(yj), **FWD_TOL)


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("extra", [{}, {"pos_diffs": True, "deltar": True, "self_loops": False}])
def test_knn_discriminator_matches_jax(train, use_pallas, extra):
    card = dict(KNN, **extra)
    jcfg, params, state, d = _disc_pair(card)
    assert not d.cfg.layers[0].fully_connected and d.cfg.layers[0].num_knn == 4
    data, labels = _batch(card, 4)
    key = jax.random.PRNGKey(5)
    yj, _ = mp_discriminator_apply(dataclasses.replace(jcfg, use_pallas=use_pallas), params, state,
                                   jnp.asarray(data), jnp.asarray(labels), train=train,
                                   rng=key if train else None)
    d.cfg = dataclasses.replace(d.cfg, use_kernels=use_pallas)
    yt = d(torch.from_numpy(data), torch.from_numpy(labels), train=train,
           rng=port_keys(key) if train else None)
    np.testing.assert_allclose(yt.detach().numpy(), np.asarray(yj), **FWD_TOL)


@pytest.mark.parametrize("card", [NARROW, KNN], ids=["dense", "knn"])
def test_discriminator_config_pins_gp_configs_to_the_plain_path(card):
    card = dict(card, gp=10.0, use_pallas=True)
    assert tconfig.build_mpgan_discriminator(tconfig.from_args_dict(card)).use_kernels is False
    assert jconfig.build_mpgan_discriminator(jconfig.from_args_dict(card)).use_pallas is False


def test_step_config_refuses_what_is_not_ported():
    """bf16 and the batched D pass are ported (tests/test_torch_bf16.py), bf16
    on a path that reaches the knn or GAPT kernels too
    (tests/test_torch_bf16_knn.py, tests/test_torch_bf16_gapt.py), and
    multi-device training (tests/test_torch_mesh.py): ``--multi-gpu`` is the
    config check alone, as in the JAX package, and a mesh that does not split
    the batch is refused before a step is built."""
    assert tts.StepConfig(bf16=True, batched_d=True).bf16
    for card in (KNN, {"model": "gapt", "num_hits": 10}):
        args = tconfig.from_args_dict(dict(card, compute_dtype="bfloat16"))
        assert tts.step_config(args).bf16
        check_supported(args)
        args.multi_gpu = True
        check_supported(args)
        args.mesh_shape = "2"
        check_supported(args)
        args.mesh_shape = "3"
        with pytest.raises(ValueError, match=f"--batch-size {args.batch_size} is not divisible"):
            check_supported(args)
    # augmentation is ported (tests/test_torch_augment.py)
    assert tts.StepConfig(augment=AugmentConfig(aug_t=True)).augment.aug_t


# ---------------------------------------------------------------------------
# one D step and one G step
# ---------------------------------------------------------------------------


def _step_pair(card, use_pallas, post_gen=None):
    card = dict(card, use_pallas=use_pallas)
    jargs = jconfig.from_args_dict(card)
    targs = tconfig.from_args_dict(card)
    gcfg, dcfg = jconfig.build_mpgan_generator(jargs), jconfig.build_mpgan_discriminator(jargs)
    spec = jsampling.noise_spec("mpgan", {"latent_node_size": jargs.latent_node_size},
                                jargs.num_hits, jargs.sd)
    g_opt = jopt.build_optimizer("rmsprop", jargs.lr_gen)
    d_opt = jopt.build_optimizer("rmsprop", jargs.lr_disc)
    jstate = jts.init_train_state(jax.random.PRNGKey(0), mp_generator_init,
                                  mp_discriminator_init, gcfg, dcfg, g_opt, d_opt)
    d_step, g_step = jts.make_train_steps(
        step_cfg=jts.StepConfig(), g_apply=mp_generator_apply, d_apply=mp_discriminator_apply,
        g_cfg=gcfg, d_cfg=dcfg, spec=spec, g_opt=g_opt, d_opt=d_opt, post_gen=post_gen)
    g = mp_generator_from_jax(_np(jstate.g_params), _np(jstate.g_state),
                              tconfig.build_mpgan_generator(targs))
    d = mp_discriminator_from_jax(_np(jstate.d_params), _np(jstate.d_state),
                                  tconfig.build_mpgan_discriminator(targs))
    tstate = tts.TrainState(g, d, topt.build_optimizer("rmsprop", g.parameters(), targs.lr_gen),
                            topt.build_optimizer("rmsprop", d.parameters(), targs.lr_disc),
                            prng.PRNGKey(0))
    tspec = tsampling.noise_spec("mpgan", {"latent_node_size": targs.latent_node_size},
                                 targs.num_hits, targs.sd)
    return (gcfg, dcfg, spec, jstate, d_step, g_step), (tstate, tspec)


def _compare_update(t_params, j_old, j_new, j_grads, lr, zero_grads_stay=False):
    """``zero_grads_stay``: a tensor whose JAX gradient is exactly zero may stay
    unchanged (and then must, in both packages)."""
    for t, old, new, g in zip(t_params, jax.tree.leaves(j_old), jax.tree.leaves(j_new),
                              jax.tree.leaves(j_grads)):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), **BWD_TOL)
        clear = np.abs(np.asarray(g)) > 1e-3
        np.testing.assert_allclose(t.detach().numpy()[clear], np.asarray(new)[clear],
                                   rtol=0, atol=lr)
        if zero_grads_stay and not np.asarray(g).any():
            np.testing.assert_array_equal(t.detach().numpy(), np.asarray(old))
            continue
        assert not np.array_equal(np.asarray(new), np.asarray(old))


@pytest.mark.parametrize("use_pallas", [True, False])
def test_d_step_and_g_step_match_jax(use_pallas):
    _check_steps_match_jax(NARROW, use_pallas)


@pytest.mark.parametrize("use_pallas", [True, False])
def test_knn_d_step_and_g_step_match_jax(use_pallas):
    """One D+G step of a knn MPGAN: with ``use_pallas`` the JAX side runs K5
    and K6 in interpret mode, the port their plain versions."""
    _check_steps_match_jax(KNN, use_pallas)


def _check_steps_match_jax(card, use_pallas, post_gens=(None, None)):
    """``post_gens``: the JAX and the port's hook on G's output (``--mask-manual``)."""
    jpost, tpost = post_gens
    keep = lambda x: x  # noqa: E731
    (gcfg, dcfg, spec, jstate, d_step, g_step), (tstate, tspec) = _step_pair(card, use_pallas,
                                                                             jpost)
    data, labels = _batch(card, 4)
    jd, jl = jnp.asarray(data), jnp.asarray(labels)
    td, tl = torch.from_numpy(data), torch.from_numpy(labels)

    # D step: replay train_step.py:182-183
    _, k_noise, k_real, k_fake, *_ = jax.random.split(jstate.rng, 9)
    noise, _ = spec.sample(k_noise, 4)

    def d_loss_fn(d_params):
        fake, _ = mp_generator_apply(gcfg, jstate.g_params, jstate.g_state, noise, jl)
        fake = (jpost or keep)(fake)
        r, s1 = mp_discriminator_apply(dcfg, d_params, jstate.d_state, jd, jl, train=True,
                                       rng=k_real)
        f, _ = mp_discriminator_apply(dcfg, d_params, s1, fake, jl, train=True, rng=k_fake)
        return jlosses.d_loss("ls", r, f)[0]

    jgrads = jax.grad(d_loss_fn)(jstate.d_params)
    jstate1, jparts = d_step(jstate, jd, jl)
    tparts = tts.d_step(tstate, tts.StepConfig(), tspec, td, tl, draws=tts.DDraws(
        torch.from_numpy(np.array(noise)), port_keys(k_real), port_keys(k_fake)), post_gen=tpost)
    for k in ("Dr", "Df", "D"):
        np.testing.assert_allclose(tparts[k].numpy(), np.asarray(jparts[k]), **FWD_TOL)
    _compare_update(jax_leaves(tstate.d, True), jstate.d_params, jstate1.d_params, jgrads,
                    1e-6)

    # G step: replay train_step.py:261-262
    _, k_noise, k_g, k_d, _ = jax.random.split(jstate1.rng, 5)
    noise, _ = spec.sample(k_noise, 4)

    def g_loss_fn(g_params):
        fake, _ = mp_generator_apply(gcfg, g_params, jstate1.g_state, noise, jl, train=True,
                                     rng=k_g)
        fake = (jpost or keep)(fake)
        out, _ = mp_discriminator_apply(dcfg, jstate1.d_params, jstate1.d_state, fake, jl,
                                        train=True, rng=k_d)
        return jlosses.g_loss("ls", out)

    jgrads = jax.grad(g_loss_fn)(jstate1.g_params)
    jstate2, jmetrics = g_step(jstate1, jd, jl)
    tmetrics = tts.g_step(tstate, tts.StepConfig(), tspec, td, tl, draws=tts.GDraws(
        torch.from_numpy(np.array(noise)), port_keys(k_g), port_keys(k_d)), post_gen=tpost)
    np.testing.assert_allclose(tmetrics["G"].numpy(), np.asarray(jmetrics["G"]), **FWD_TOL)
    _compare_update(jax_leaves(tstate.g, True), jstate1.g_params, jstate2.g_params, jgrads,
                    1e-6, zero_grads_stay=jpost is not None)
    # D's parameters took no gradient in the G step and are trainable again
    assert all(p.requires_grad for p in tstate.d.parameters())


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("flags", [{}, {"mask_real_only": True}], ids=["cutoff", "real_only"])
def test_mask_manual_d_step_and_g_step_match_jax(use_pallas, flags):
    """``--mask-manual --no-mask-c``: G emits 3 features, the hook appends the
    mask that D reads (both registries build it), in both steps. With the pT
    cutoff 0 an untrained G's particles all fall below it, D masks every one of
    them, and G's gradient is zero in both packages; ``--mask-real-only`` keeps
    them and G learns."""
    card = dict(NARROW, mask_manual=True, mask_c=False, **flags)
    jpost = jregistry.build_suite(jconfig.from_args_dict(card)).post_gen
    tpost = tregistry.build_suite(tconfig.from_args_dict(card)).post_gen
    assert jpost is not None and tpost is not None
    _check_steps_match_jax(card, use_pallas, (jpost, tpost))


def test_steps_draw_everything_from_the_state_generator():
    """Without explicit draws, two states keyed alike take identical steps, and
    each step writes the next key: child 0 of the old (JAX's split keeps it)."""
    outs = []
    for _ in range(2):
        _, (tstate, tspec) = _step_pair(NARROW, True)
        data, labels = map(torch.from_numpy, _batch(NARROW, 4))
        key = tstate.rng.clone()
        parts = tts.d_step(tstate, tts.StepConfig(label_smoothing=True), tspec, data, labels)
        parts.update(tts.g_step(tstate, tts.StepConfig(), tspec, data, labels))
        assert torch.equal(tstate.rng, prng.split(prng.split(key, 9)[0], 5)[0])
        outs.append({k: v.item() for k, v in parts.items()})
    assert outs[0] == outs[1]
