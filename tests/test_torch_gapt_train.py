"""GAPT training in the port against the JAX package on the CPU: one D step and
one G step from identical state, batch, noise and dropout keys (losses and
gradients 1e-4, updated parameters within the learning rate); a GAPT
``state_*.npz`` moves between the packages both ways; a tiny ``cli.train
--device cpu --model gapt`` run with a resume; ``cli.gen --device cpu`` from a
GAPT ``.pt``.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one thread a test worker: the suite runs in parallel workers

import jax
import jax.numpy as jnp

from mpgan_tpu.models.gapt import gapt_d_apply, gapt_d_init, gapt_g_apply, gapt_g_init
from mpgan_tpu.training import checkpoint as jckpt
from mpgan_tpu.training import config as jconfig
from mpgan_tpu.training import losses as jlosses
from mpgan_tpu.training import optimizers as jopt
from mpgan_tpu.training import sampling as jsampling
from mpgan_tpu.training import train_step as jts
from mpgan_tpu_torch.ops import prng
from mpgan_tpu_torch.cli import gen as tgen_cli
from mpgan_tpu_torch.cli import train as ttrain_cli
from mpgan_tpu_torch.data import jetnet as tjetnet
from mpgan_tpu_torch.models.registry import build_suite
from mpgan_tpu_torch.training import checkpoint as tckpt
from mpgan_tpu_torch.training import config as tconfig
from mpgan_tpu_torch.training import optimizers as topt
from mpgan_tpu_torch.training import train_step as tts
from mpgan_tpu_torch.training.loop import Trainer
from mpgan_tpu_torch.utils.weights import (
    gapt_discriminator_from_jax,
    gapt_generator_from_jax,
    gapt_generator_to_reference_sd,
    jax_leaves,
)

from test_torch_ops import port_keys  # the port's keys of a JAX key

FWD_TOL = dict(rtol=1e-4, atol=1e-4)
BWD_TOL = dict(rtol=1e-4, atol=1e-4)
NARROW = {"model": "gapt", "num_hits": 8, "gapt_embed_dim": 16, "num_heads": 2,
          "sab_layers_gen": 2, "sab_layers_disc": 1}
TINY = ["--model", "gapt", "--jets", "g", "--num-hits", "8", "--gapt-embed-dim", "16",
        "--num-heads", "2", "--sab-layers-gen", "2", "--sab-layers-disc", "1", "--batch-size",
        "16", "--eval-tot-samples", "64", "--w1-num-samples", "50", "--num-samples", "200",
        "--save-model-epochs", "1"]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_state(card, optimizer="rmsprop", seed=0):
    a = jconfig.from_args_dict(dict(card, optimizer=optimizer))
    gcfg, dcfg = jconfig.build_gapt(a, gen=True), jconfig.build_gapt(a, gen=False)
    g_opt = jopt.build_optimizer(optimizer, a.lr_gen, beta1=a.beta1, beta2=a.beta2)
    d_opt = jopt.build_optimizer(optimizer, a.lr_disc, beta1=a.beta1, beta2=a.beta2)
    state = jts.init_train_state(jax.random.PRNGKey(seed), gapt_g_init, gapt_d_init, gcfg, dcfg,
                                 g_opt, d_opt)
    return a, gcfg, dcfg, g_opt, d_opt, state


def _batch(n, b, seed=0):
    ds = tjetnet.JetNetDataset("g", num_particles=n, synthetic_num_jets=200, seed=seed)
    return ds.particle_data[:b], ds.jet_data[:b]


def _compare_update(t_params, j_old, j_new, j_grads, lr):
    for t, old, new, g in zip(t_params, jax.tree.leaves(j_old), jax.tree.leaves(j_new),
                              jax.tree.leaves(j_grads)):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), **BWD_TOL)
        clear = np.abs(np.asarray(g)) > 1e-3
        np.testing.assert_allclose(t.detach().numpy()[clear], np.asarray(new)[clear],
                                   rtol=0, atol=lr)
        assert not np.array_equal(np.asarray(new), np.asarray(old))


@pytest.mark.parametrize("card", [
    pytest.param(NARROW, id="narrow"),
    pytest.param(dict(NARROW, layer_norm=True, use_isab=True, num_isab_nodes=3,
                      gen_dropout=0.5), id="isab-ln-gen-dropout"),
])
def test_gapt_d_step_and_g_step_match_jax(card):
    """D dropout 0.5 (the default) under replayed keys; the D step's fake batch
    comes from G in eval mode, which on the CPU with ``use_kernels=None`` is the
    plain path."""
    jargs, gcfg, dcfg, g_opt, d_opt, jstate = _jax_state(card)
    targs = tconfig.from_args_dict(card)
    spec = jsampling.noise_spec("gapt", {"embed_dim": jargs.gapt_embed_dim}, jargs.num_hits,
                                jargs.sd)
    d_step, g_step = jts.make_train_steps(
        step_cfg=jts.StepConfig(), g_apply=gapt_g_apply, d_apply=gapt_d_apply, g_cfg=gcfg,
        d_cfg=dcfg, spec=spec, g_opt=g_opt, d_opt=d_opt)
    suite = build_suite(targs)
    g = gapt_generator_from_jax(_np(jstate.g_params), _np(jstate.g_state), suite.g_cfg)
    d = gapt_discriminator_from_jax(_np(jstate.d_params), _np(jstate.d_state), suite.d_cfg)
    tstate = tts.TrainState(g, d, topt.build_optimizer("rmsprop", g.parameters(), targs.lr_gen),
                            topt.build_optimizer("rmsprop", d.parameters(), targs.lr_disc),
                            prng.PRNGKey(0))
    assert suite.noise.shape == spec.shape
    data, labels = _batch(jargs.num_hits, 4)
    jd, jl = jnp.asarray(data), jnp.asarray(labels)
    td, tl = torch.from_numpy(data), torch.from_numpy(labels)

    # D step: replay train_step.py:182-183
    _, k_noise, k_real, k_fake, *_ = jax.random.split(jstate.rng, 9)
    noise, _ = spec.sample(k_noise, 4)

    def d_loss_fn(d_params):
        fake, _ = gapt_g_apply(gcfg, jstate.g_params, jstate.g_state, noise, jl)
        r, s1 = gapt_d_apply(dcfg, d_params, jstate.d_state, jd, jl, train=True, rng=k_real)
        f, _ = gapt_d_apply(dcfg, d_params, s1, fake, jl, train=True, rng=k_fake)
        return jlosses.d_loss("ls", r, f)[0]

    jgrads = jax.grad(d_loss_fn)(jstate.d_params)
    jstate1, jparts = d_step(jstate, jd, jl)
    tparts = tts.d_step(tstate, tts.StepConfig(), suite.noise, td, tl, draws=tts.DDraws(
        torch.from_numpy(np.array(noise)), port_keys(k_real), port_keys(k_fake)))
    for k in ("Dr", "Df", "D"):
        np.testing.assert_allclose(tparts[k].numpy(), np.asarray(jparts[k]), **FWD_TOL)
    _compare_update(jax_leaves(tstate.d, True), jstate.d_params, jstate1.d_params, jgrads,
                    2e-5)

    # G step: replay train_step.py:261-262
    _, k_noise, k_g, k_d, _ = jax.random.split(jstate1.rng, 5)
    noise, _ = spec.sample(k_noise, 4)

    def g_loss_fn(g_params):
        fake, _ = gapt_g_apply(gcfg, g_params, jstate1.g_state, noise, jl, train=True, rng=k_g)
        out, _ = gapt_d_apply(dcfg, jstate1.d_params, jstate1.d_state, fake, jl, train=True,
                              rng=k_d)
        return jlosses.g_loss("ls", out)

    jgrads = jax.grad(g_loss_fn)(jstate1.g_params)
    jstate2, jmetrics = g_step(jstate1, jd, jl)
    tmetrics = tts.g_step(tstate, tts.StepConfig(), suite.noise, td, tl, draws=tts.GDraws(
        torch.from_numpy(np.array(noise)), port_keys(k_g), port_keys(k_d)))
    np.testing.assert_allclose(tmetrics["G"].numpy(), np.asarray(jmetrics["G"]), **FWD_TOL)
    _compare_update(jax_leaves(tstate.g, True), jstate1.g_params, jstate2.g_params, jgrads,
                    1e-5)
    assert all(p.requires_grad for p in tstate.d.parameters())


def test_gapt_d_step_fake_batch_takes_the_fused_route_when_asked():
    """With ``use_kernels=True`` the D step's eval-mode G forward goes through
    K9's wrapper (on the CPU its plain version) and the step gives the same
    losses as the plain path."""
    import dataclasses

    targs = tconfig.from_args_dict(NARROW)
    suite = build_suite(targs)
    data, labels = map(torch.from_numpy, _batch(8, 4))
    parts = []
    for flag in (False, True):
        kg, kd = prng.split(prng.PRNGKey(1))
        g, d = suite.generator(kg), suite.discriminator(kd)
        g.cfg = dataclasses.replace(g.cfg, use_kernels=flag)
        st = tts.TrainState(g, d, topt.build_optimizer("rmsprop", g.parameters(), 1e-4),
                            topt.build_optimizer("rmsprop", d.parameters(), 1e-4),
                            prng.PRNGKey(1))
        out = tts.d_step(st, tts.StepConfig(), suite.noise, data, labels)
        out.update(tts.g_step(st, tts.StepConfig(), suite.noise, data, labels))
        parts.append({k: v.item() for k, v in out.items()})
    for k in parts[0]:
        assert abs(parts[0][k] - parts[1][k]) < 1e-5


CARD = dict(NARROW, name="ck", batch_size=16, num_samples=200, eval_tot_samples=64,
            w1_num_samples=[50], layer_norm=True, spectral_norm_disc=True)


def _trainer(tmp_path, card):
    args = tconfig.from_args_dict(dict(card, dir_path=str(tmp_path)))
    kw = dict(num_particles=args.num_hits, synthetic_num_jets=args.num_samples,
              mask_feature=True)
    return Trainer(args, tjetnet.JetNetDataset("g", split="train", **kw),
                   tjetnet.JetNetDataset("g", split="valid", **kw), device="cpu")


@pytest.mark.parametrize("extra", [{}, {"use_isab": True, "num_isab_nodes": 3,
                                       "optimizer": "adam"}], ids=["sab", "isab-adam"])
def test_gapt_checkpoint_moves_between_the_packages(tmp_path, extra):
    card = dict(CARD, **extra)
    optimizer = card.get("optimizer", "rmsprop")
    trainer = _trainer(tmp_path, dict(card, num_epochs=1, save_epochs=1))
    trainer.train()
    template = _jax_state(card, optimizer)[-1]
    loaded = jckpt.load_train_state(tckpt.checkpoint_path(trainer.models_dir, 1), template)
    st = trainer.state
    ref = (jax_leaves(st.g, True) + jax_leaves(st.g, False)
           + jax_leaves(st.d, True) + jax_leaves(st.d, False))
    leaves = jax.tree.leaves(loaded)
    assert len(leaves) > len(ref)
    for a, b in zip(leaves, ref):
        np.testing.assert_array_equal(np.asarray(a), b.detach().numpy())

    jstate = _jax_state(dict(card, name="jk"), optimizer, seed=5)[-1]
    models = tmp_path / "jk" / "models"
    models.mkdir(parents=True)
    jckpt.save_train_state(jckpt.checkpoint_path(models, 1), jstate)
    resumed = _trainer(tmp_path, dict(card, name="jk", num_epochs=2, save_epochs=2))
    assert resumed.start_epoch == 1
    got = tckpt.train_state_leaves(resumed.state)
    want = jax.tree.leaves(jstate)
    assert len(got) == len(want)
    for a, b in zip(got[:-1], want[:-1]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    resumed.train()
    assert np.isfinite(resumed.losses["D"]).all() and len(resumed.losses["G"]) == 1


def test_train_cli_tiny_gapt_run_writes_the_run_directory_and_resumes(tmp_path):
    argv = ["--device", "cpu", "--name", "tiny", "--dir-path", str(tmp_path), *TINY]
    t1 = ttrain_cli.main(argv + ["--num-epochs", "2", "--save-epochs", "2"])
    run = tmp_path / "tiny"
    assert type(t1.state.g).__name__ == "GAPTGenerator"
    assert type(t1.state.d).__name__ == "GAPTDiscriminator"
    assert (run / "tiny_args.txt").exists()
    assert sorted(p.name for p in (run / "models").iterdir()) == ["state_1.npz", "state_2.npz"]
    assert len(t1.losses["G"]) == 2 and len(t1.losses["w1m"]) == 1
    t2 = ttrain_cli.main(argv + ["--num-epochs", "3", "--save-epochs", "2"])
    assert t2.start_epoch == 2 and len(t2.losses["G"]) == 3
    assert (run / "models" / "state_3.npz").exists()
    assert np.isfinite(t2.losses["G"]).all() and np.isfinite(t2.losses["D"]).all()
    np.testing.assert_array_equal(t1.losses["G"], t2.losses["G"][:2])


def test_train_cli_gapt_refuses_cuda_without_a_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit, match="no CUDA device"):
        ttrain_cli.main(["--name", "x", "--dir-path", str(tmp_path), *TINY])


@pytest.mark.parametrize("masked", [True, False])
def test_gen_cli_from_a_gapt_pt(tmp_path, masked):
    card = dict(NARROW, gapt_mask=masked)
    args = tconfig.from_args_dict(card)
    suite = build_suite(args)
    g = suite.generator(prng.PRNGKey(2))
    (tmp_path / "card.txt").write_text(repr(args.to_dict()))
    torch.save(gapt_generator_to_reference_sd(g), tmp_path / "G.pt")
    out = tmp_path / "gen.npy"
    argv = ["--g-args", str(tmp_path / "card.txt"), "--g-state", str(tmp_path / "G.pt"),
            "--output-file", str(out), "--num-samples", "70", "--batch-size", "32", "--seed", "3"]
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            tgen_cli.main(argv)
    tgen_cli.main(argv + ["--device", "cpu"])
    jets = np.load(out)
    assert jets.shape == (70, 8, 3) and np.isfinite(jets).all()
    assert (jets[:, :, 2] >= 0).all()
    if masked:
        ds = tjetnet.JetNetDataset("g", num_particles=8, split="valid")
        labels = ds.jet_data[np.random.default_rng(3).choice(len(ds), size=70)]
        counts = (labels[:, -1].astype(np.float32) * 8).astype(np.int32)
        np.testing.assert_array_equal(np.any(jets != 0, axis=-1).sum(axis=1), counts)
    # the same seed gives the same jets; the module's own forward gives them too
    tgen_cli.main(argv + ["--device", "cpu"])
    np.testing.assert_array_equal(np.load(out), jets)
