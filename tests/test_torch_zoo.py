"""The model zoo in the PyTorch port against the JAX package: the 14
generator/discriminator families of the reference's ``trained_models/`` at
tiny widths, each with its presets (``training/config.py``'s ext-model
processing: WGAN-GP, ``num_critic 5``, the family's optimizer).

- ``noise_spec`` gives the JAX package's shapes for every generator family;
- one D step and one G step per family from the same JAX-initialised state on
  the same draws (the JAX key splits replayed): loss parts and every
  gradient within 1e-4, updated parameters where the gradient is clear of zero;
- the TrainState checkpoint moves both ways per family: a port ``state_*.npz``
  loads in the JAX ``load_train_state`` with the template's shapes, a JAX one
  in the port, and the loaded models give the other package's outputs;
- the reference-layout ``.pt`` writer of every generator family reads back
  through the JAX ``generator_from_torch`` and the port's reader to equal outputs;
- a tiny ``cli.train`` run on the CPU for fcpnet, graphcnnmp, mpfc and pcgan:
  finite losses, a resume that restores the state exactly, and ``cli.gen``.

PCGAN's pre-trained ``G_inv`` and ``G_pc`` are written here by the port from
seeded random weights, in the reference layout, and read by both packages.
"""

import numpy as np
import optax
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one thread a test worker: the suite runs in parallel workers

import jax
import jax.numpy as jnp

from mpgan_tpu.models import registry as jregistry
from mpgan_tpu.training import checkpoint as jckpt
from mpgan_tpu.training import config as jconfig
from mpgan_tpu.training import optimizers as jopt
from mpgan_tpu.training import sampling as jsampling
from mpgan_tpu.training import train_step as jts
from mpgan_tpu.utils.torch_import import generator_from_torch
from mpgan_tpu_torch.ops import prng
from mpgan_tpu_torch.cli import args as targs_cli
from mpgan_tpu_torch.cli import gen as tgen_cli
from mpgan_tpu_torch.cli import train as ttrain_cli
from mpgan_tpu_torch.data.jetnet import JetNetDataset
from mpgan_tpu_torch.models import registry as tregistry
from mpgan_tpu_torch.models.ext.pcgan import GInv, GPc, PCGANConfig
from mpgan_tpu_torch.training import checkpoint as tckpt
from mpgan_tpu_torch.training import config as tconfig
from mpgan_tpu_torch.training import optimizers as topt
from mpgan_tpu_torch.training import train_step as tts
from mpgan_tpu_torch.training.loop import Trainer
from mpgan_tpu_torch.utils.weights import (
    generator_from_reference,
    jax_leaves,
    load_jax_trees,
    reference_state_dict,
    tree_leaves,
)

from test_torch_ops import port_keys  # the port's keys of a JAX key

torch.backends.cuda.matmul.allow_tf32 = False
FWD_TOL = dict(rtol=1e-5, atol=1e-5)
STEP_TOL = dict(rtol=1e-4, atol=1e-4)

WIDTHS = dict(
    jets="g", num_hits=8, hidden_node_size=8, fe=[8, 8], fn=[8], lfc_latent_size=12,
    latent_dim=8, rgang_fc=[16], rgand_sfc=[8, 12], rgand_fc=[8], pointnetd_pointfc=[8, 12],
    pointnetd_fc=[8], graphcnng_layers=[6, 5], treegang_features=[8, 6, 5, 3],
    treegang_degrees=[2, 2, 2], treegang_support=3, pcgan_latent_dim=8, pcgan_z1_dim=12,
    pcgan_z2_dim=4, pcgan_d_dim=16,
)
# the legacy families' learning rates: the presets set none for old_mpgan
LEGACY_LR = dict(lr_disc=3e-5, lr_gen=1e-5)
# family: (model, model_D, flags, card overrides after the args processing)
FAMILIES = {
    "fc": ("rgan", "rgan", {}, {}),
    "fcmp": ("rgan", "mpgan", {}, {}),
    "fcpnet": ("rgan", "pointnet", {}, {}),
    # the preset's num_knn 20 needs 21 particles at least
    "graphcnn": ("graphcnngan", "rgan", {"num_hits": 24}, {}),
    "graphcnnmp": ("graphcnngan", "mpgan", {"num_hits": 24}, {}),
    "graphcnnpnet": ("graphcnngan", "pointnet", {"num_hits": 24}, {}),
    "mp": ("mpgan", "mpgan", {}, {}),
    "mpfc": ("old_mpgan", "rgan", dict(LEGACY_LR, lfc=True), {}),
    # the shipped mplfc card's masks (the processing clears mask_c for old_mpgan)
    "mplfc": ("old_mpgan", "mpgan", dict(LEGACY_LR, lfc=True), {"mask": True, "mask_c": True}),
    "mppnet": ("mpgan", "pointnet", {}, {}),
    "pcgan": ("pcgan", "pcgan", {}, {}),
    "treeganfc": ("treegan", "rgan", {}, {}),
    "treeganmp": ("treegan", "mpgan", {}, {}),
    "treeganpnet": ("treegan", "pointnet", {}, {}),
}
GENERATORS = ("rgan", "graphcnngan", "treegan", "pcgan", "old_mpgan", "mpgan", "gapt")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def pcgan_dir(tmp_path_factory):
    """Seeded random G_inv / G_pc in the reference layout, as ``<dir>/pcgan_G_*_g.pt``."""
    d = tmp_path_factory.mktemp("pcgan")
    cfg = PCGANConfig(node_feat_size=3, latent_dim=8, z1_dim=12, z2_dim=4, d_dim=16)
    torch.save(GInv(cfg, prng.PRNGKey(11)).state_dict(), d / "pcgan_G_inv_g.pt")
    torch.save(GPc(cfg, prng.PRNGKey(12)).state_dict(), d / "pcgan_G_pc_g.pt")
    return str(d)


def _card(family, pcgan_dir=""):
    model, model_d, flags, post = FAMILIES[family]
    card = dict(WIDTHS, model=model, model_D=model_d, pcgan_weights_dir=pcgan_dir, **flags)
    return card, post


def _args(config, family, pcgan_dir=""):
    card, post = _card(family, pcgan_dir)
    args = config.from_args_dict(card)
    for key, value in post.items():
        setattr(args, key, value)
    return args


def _jax_opt(args, lr):
    return jopt.build_optimizer(args.optimizer, lr, beta1=args.beta1, beta2=args.beta2)


class _Family:
    """Both packages' suites, a JAX-initialised TrainState and the port's
    TrainState holding its weights."""

    def __init__(self, family, pcgan_dir):
        weights = pcgan_dir if family == "pcgan" else None
        self.jargs, self.targs = _args(jconfig, family), _args(tconfig, family)
        self.jsuite = jregistry.build_suite(self.jargs, pcgan_weights_dir=weights)
        self.tsuite = tregistry.build_suite(self.targs, pcgan_weights_dir=weights)
        self.grads = {}
        self.g_opt = self._recording(_jax_opt(self.jargs, self.jargs.lr_gen), "g")
        self.d_opt = self._recording(_jax_opt(self.jargs, self.jargs.lr_disc), "d")
        js = self.jsuite
        self.jstate = jts.init_train_state(jax.random.PRNGKey(0), js.g_init, js.d_init,
                                           js.g_cfg, js.d_cfg, self.g_opt, self.d_opt)
        self.tstate = self.port_state()
        load_jax_trees(self.tstate.g, _np(self.jstate.g_params), _np(self.jstate.g_state))
        load_jax_trees(self.tstate.d, _np(self.jstate.d_params), _np(self.jstate.d_state))
        self.use_labels = bool(self.jargs.get("mask_c") or self.jargs.clabels)

    def _recording(self, opt, name):
        """The optimizer, keeping the gradients it is handed (the steps run eagerly)."""
        def update(grads, state, params=None):
            self.grads[name] = grads
            return opt.update(grads, state, params)
        return optax.GradientTransformation(opt.init, update)

    def port_state(self):
        a, s = self.targs, self.tsuite
        g, d = s.generator(prng.PRNGKey(5)), s.discriminator()
        opt = lambda m, lr: topt.build_optimizer(a.optimizer, m.parameters(), lr,  # noqa: E731
                                                 beta1=a.beta1, beta2=a.beta2)
        return tts.TrainState(g, d, opt(g, a.lr_gen), opt(d, a.lr_disc), prng.PRNGKey(0))

    def batch(self, b=4):
        a = self.targs
        ds = JetNetDataset("g", num_particles=a.num_hits, synthetic_num_jets=200,
                           mask_feature=bool(a.get("mask")))
        labels = ds.jet_data[:b] if self.use_labels else None
        return ds.particle_data[:b], labels

    def steps(self):
        js = self.jsuite
        step_cfg = jts.StepConfig(loss=self.jargs.loss, gp_lambda=self.jargs.gp)
        return jts.make_train_steps(
            step_cfg=step_cfg, g_apply=js.g_apply, d_apply=js.d_apply, g_cfg=js.g_cfg,
            d_cfg=js.d_cfg, spec=js.noise, g_opt=self.g_opt, d_opt=self.d_opt,
            use_labels=self.use_labels, encode_real=js.encode_real, post_gen=js.post_gen)


@pytest.fixture(scope="module", params=list(FAMILIES))
def stepped(request, pcgan_dir):
    """A family after one D step and one G step in both packages."""
    fam = _Family(request.param, pcgan_dir)
    data, labels = fam.batch()
    jargs_ = (jnp.asarray(data),) + ((jnp.asarray(labels),) if labels is not None else ())
    td = torch.from_numpy(data)
    tl = torch.from_numpy(labels) if labels is not None else None
    d_step, g_step = fam.steps()
    step_cfg = tts.StepConfig(loss=fam.targs.loss, gp_lambda=fam.targs.gp)

    # D step: replay train_step.py:182-183 (and the GP weight of losses.py:107-108)
    j0 = fam.jstate
    _, k_noise, k_real, k_fake, k_gp_drop, k_gp, *_ = jax.random.split(j0.rng, 9)
    noise, _ = fam.jsuite.noise.sample(k_noise, len(data))
    real = data if fam.jsuite.encode_real is None else np.asarray(
        fam.jsuite.encode_real(jnp.asarray(data)))
    alpha = jax.random.uniform(k_gp, (len(data),) + (1,) * (real.ndim - 1))
    j1, jd_parts = d_step(j0, *jargs_)
    td_parts = tts.d_step(fam.tstate, step_cfg, fam.tsuite.noise, td, tl, draws=tts.DDraws(
        torch.from_numpy(np.array(noise)), port_keys(k_real), port_keys(k_fake), None,
        port_keys(k_gp_drop), torch.from_numpy(np.array(alpha))),
        post_gen=fam.tsuite.post_gen, encode_real=fam.tsuite.encode_real)
    d_grads = [None if p.grad is None else p.grad.clone() for p in jax_leaves(fam.tstate.d, True)]

    # G step: replay train_step.py:261-262
    _, k_noise, k_g, k_d, _ = jax.random.split(j1.rng, 5)
    noise, _ = fam.jsuite.noise.sample(k_noise, len(data))
    j2, jg_parts = g_step(j1, *jargs_)
    tg_parts = tts.g_step(fam.tstate, step_cfg, fam.tsuite.noise, td, tl, draws=tts.GDraws(
        torch.from_numpy(np.array(noise)), port_keys(k_g), port_keys(k_d)),
        post_gen=fam.tsuite.post_gen)
    return fam, (j0, j1, j2), (jd_parts, td_parts, jg_parts, tg_parts), d_grads


def _compare_grads(ours, j_grads, j_old, j_new, t_params):
    theirs = tree_leaves(_np(j_grads))
    assert len(ours) == len(theirs) == len(t_params)
    for t, g, old, new, p in zip(ours, theirs, tree_leaves(_np(j_old)),
                                 tree_leaves(_np(j_new)), t_params):
        # a parameter the loss does not reach (TreeGAN's last bias) has no grad
        t = np.zeros_like(g) if t is None else t.numpy()
        np.testing.assert_allclose(t, g, **STEP_TOL)
        clear = np.abs(g) > 1e-3
        np.testing.assert_allclose(p.detach().numpy()[clear], new[clear], rtol=1e-5, atol=1e-6)


def test_one_d_step_and_one_g_step_match_jax(stepped):
    fam, (j0, j1, j2), (jd, td, jg, tg), d_grads = stepped
    assert set(td) == set(jd) == ({"Dr", "Df", "D", "gp"} if fam.targs.gp else {"Dr", "Df", "D"})
    for k in jd:
        np.testing.assert_allclose(td[k].numpy(), np.asarray(jd[k]), **STEP_TOL)
    np.testing.assert_allclose(tg["G"].numpy(), np.asarray(jg["G"]), **STEP_TOL)
    st = fam.tstate
    _compare_grads(d_grads, fam.grads["d"], j0.d_params, j1.d_params, jax_leaves(st.d, True))
    g_grads = [None if p.grad is None else p.grad for p in jax_leaves(st.g, True)]
    _compare_grads(g_grads, fam.grads["g"], j1.g_params, j2.g_params, jax_leaves(st.g, True))
    # mutable state after both steps: BN running statistics, SN vectors
    for t, leaf in zip(jax_leaves(st.g, False) + jax_leaves(st.d, False),
                       tree_leaves(_np(j2.g_state)) + tree_leaves(_np(j2.d_state))):
        np.testing.assert_allclose(t.numpy(), leaf, **STEP_TOL)


def _outputs_agree(fam, jstate, tstate):
    """G (eval) and D (eval) of both packages on the same inputs, within 1e-5."""
    js = fam.jsuite
    noise, _ = js.noise.sample(jax.random.PRNGKey(9), 3)
    data, labels = fam.batch(3)
    jl = jnp.asarray(labels) if labels is not None else None
    tl = torch.from_numpy(labels) if labels is not None else None
    jg, _ = js.g_apply(js.g_cfg, jstate.g_params, jstate.g_state, noise, jl)
    tg = tstate.g(torch.from_numpy(np.array(noise)), tl, update_sn=False)
    np.testing.assert_allclose(tg.detach().numpy(), np.asarray(jg), **FWD_TOL)
    real = data if js.encode_real is None else np.asarray(js.encode_real(jnp.asarray(data)))
    jd, _ = js.d_apply(js.d_cfg, jstate.d_params, jstate.d_state, jnp.asarray(real), jl)
    td = tstate.d(torch.from_numpy(np.array(real)), tl, update_sn=False)
    np.testing.assert_allclose(td.detach().numpy(), np.asarray(jd), **FWD_TOL)


def test_port_checkpoint_loads_in_jax(stepped, tmp_path):
    fam, (_, _, j2), _, _ = stepped
    path = tmp_path / "state_1.npz"
    tckpt.save_train_state(path, fam.tstate)
    loaded = jckpt.load_train_state(path, j2)
    for a, b in zip(jax.tree.leaves(loaded), jax.tree.leaves(j2)):
        assert np.shape(a) == np.shape(b)
    ours = tckpt.train_state_leaves(fam.tstate)[:-1]  # the models' and optimizers' leaves
    for a, b in zip(jax.tree.leaves(loaded)[:-1], ours):
        np.testing.assert_array_equal(np.asarray(a), b)
    _outputs_agree(fam, loaded, fam.tstate)


def test_jax_checkpoint_loads_in_the_port(stepped, tmp_path):
    fam, (_, _, j2), _, _ = stepped
    path = tmp_path / "state_1.npz"
    jckpt.save_train_state(path, j2)
    fresh = fam.port_state()
    tckpt.load_train_state(path, fresh)
    want = jax.tree.leaves(j2)
    got = tckpt.train_state_leaves(fresh)
    assert len(got) == len(want)
    for a, b in zip(got[:-1], want[:-1]):
        np.testing.assert_array_equal(a, np.asarray(b))
    _outputs_agree(fam, j2, fresh)


@pytest.mark.parametrize("model", GENERATORS)
def test_noise_spec_matches_jax(model):
    card = dict(WIDTHS, model=model, model_D={"pcgan": "pcgan"}.get(model, "rgan"),
                lfc=model == "old_mpgan")
    jargs, targs = jconfig.from_args_dict(card), tconfig.from_args_dict(card)
    js, ts = jregistry.build_suite(jargs), tregistry.build_suite(targs)
    assert ts.noise.shape == js.noise.shape and ts.noise.std == js.noise.std
    # the decoder noise: the same shape where the JAX package draws it
    margs = dict(jregistry._model_args(jargs), sample_points=True)
    assert ts.noise.point_shape == jsampling.noise_spec(model, margs, jargs.num_hits).point_shape
    if model == "pcgan":
        assert ts.noise.point_shape == (8, 4) and js.noise.point_shape is None
    else:
        assert ts.noise.point_shape is None


@pytest.mark.parametrize("model", ["rgan", "graphcnngan", "treegan", "pcgan", "old_mpgan"])
def test_reference_state_dict_reads_back_in_both_packages(model):
    family = {"rgan": "fc", "graphcnngan": "graphcnn", "treegan": "treeganfc",
              "pcgan": "pcgan", "old_mpgan": "mplfc"}[model]
    jargs, targs = _args(jconfig, family), _args(tconfig, family)
    js, ts = jregistry.build_suite(jargs), tregistry.build_suite(targs)
    g = ts.generator(prng.PRNGKey(3))
    if model == "graphcnngan":
        with torch.no_grad():  # running statistics away from their init
            for bn in g.bn_layers:
                bn.running_mean.uniform_(-0.1, 0.1)
                bn.running_var.uniform_(1.0, 2.0)
    sd = reference_state_dict(model, g)
    if model == "old_mpgan":
        assert "fe.0.0.weight" in sd and "lfc.weight" in sd
    if model == "graphcnngan":
        assert sd["layers.0.root"].shape == (6, 5) and "bn_layers.0.module.running_var" in sd
    params, state = generator_from_torch(model, {k: v.numpy() for k, v in sd.items()}, js.g_cfg)
    noise, _ = js.noise.sample(jax.random.PRNGKey(4), 3)
    labels = np.full((3, 1), 0.75, np.float32)
    want, _ = js.g_apply(js.g_cfg, params, state, noise, jnp.asarray(labels))
    back = generator_from_reference(model, sd, ts.g_cfg, ts.g_cls)
    for m in (g, back):
        got = m(torch.from_numpy(np.array(noise)), torch.from_numpy(labels))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **FWD_TOL)


def test_modern_layout_old_mpgan_state_dict_is_refused():
    targs = _args(tconfig, "mplfc")
    ts = tregistry.build_suite(targs)
    with pytest.raises(ValueError, match="modern MPGAN layout"):
        generator_from_reference("old_mpgan", {"mp_layers.0.fe.net.0.weight": torch.zeros(1)},
                                 ts.g_cfg, ts.g_cls)


# ---------------------------------------------------------------------------
# the CLI on the CPU
# ---------------------------------------------------------------------------


def _argv(family, tmp_path, pcgan_dir):
    card, post = _card(family, pcgan_dir)
    assert not post
    argv = ["--device", "cpu", "--name", family, "--dir-path", str(tmp_path),
            "--num-epochs", "1", "--save-epochs", "1", "--eval-tot-samples", "64",
            "--w1-num-samples", "50", "--num-samples", "400", "--batch-size", "16"]
    if family == "pcgan":  # its preset's batch of 256 needs two batches of jets
        argv[-3] = "1000"
    for key, value in card.items():
        if key in ("rgand_sfc", "rgand_fc"):
            continue  # scalar flags (default 0): the presets fill the rGAN D's widths
        flag = "--" + key.replace("_", "-")
        if isinstance(value, bool):
            argv.append(flag if value else "--no-" + flag[2:])
        elif isinstance(value, list):
            argv += [flag, *map(str, value)]
        elif value != "":
            argv += [flag, str(value)]
    return argv


@pytest.mark.parametrize("family", ["fcpnet", "graphcnnmp", "mpfc", "pcgan"])
def test_train_cli_runs_and_resumes(family, tmp_path, pcgan_dir):
    argv = _argv(family, tmp_path, pcgan_dir)
    t1 = ttrain_cli.main(argv)
    assert t1.suite.model == FAMILIES[family][0] and t1.suite.model_d == FAMILIES[family][1]
    for key in ("D", "G", "w1m"):
        assert len(t1.losses[key]) == 1 and np.isfinite(t1.losses[key]).all()
    # the resume: the saved state, exactly, and the random stream it continues
    argv[argv.index("--num-epochs") + 1] = "2"
    args = ttrain_cli._reload_args_on_resume(targs_cli.parse_cli(argv[2:]))
    t2 = Trainer(args, t1.train_dataset, t1.valid_dataset, device="cpu")
    assert t2.start_epoch == 1
    assert torch.equal(t2.state.rng, t1.state.rng)
    for a, b in zip(tckpt.train_state_leaves(t2.state)[:-1],
                    tckpt.train_state_leaves(t1.state)[:-1]):
        np.testing.assert_array_equal(a, b)
    t2.train()
    assert len(t2.losses["G"]) == 2 and np.isfinite(t2.losses["G"]).all()
    out = tmp_path / "gen.npy"
    tgen_cli.main(["--device", "cpu", "--g-args", str(t2.out_dir / f"{family}_args.txt"),
                   "--g-state", str(t2.models_dir / "state_2.npz"), "--num-samples", "40",
                   "--batch-size", "16", "--output-file", str(out)])
    jets = np.load(out)
    assert jets.shape == (40, t2.args.num_hits, 3) and np.isfinite(jets).all()


def test_pcgan_trainer_refuses_without_g_inv(tmp_path):
    args = tconfig.from_args_dict(dict(_card("pcgan")[0], dir_path=str(tmp_path), name="p",
                                       pcgan_weights_dir=str(tmp_path)))
    ds = JetNetDataset("g", num_particles=8, synthetic_num_jets=100)
    with pytest.raises(FileNotFoundError, match="pcgan_G_inv_g.pt"):
        Trainer(args, ds, ds, device="cpu")


def test_pcgan_evaluation_refuses_without_g_pc(tmp_path, pcgan_dir):
    import shutil

    wdir = tmp_path / "w"
    wdir.mkdir()
    shutil.copy(f"{pcgan_dir}/pcgan_G_inv_g.pt", wdir)
    args = tconfig.from_args_dict(dict(_card("pcgan")[0], dir_path=str(tmp_path), name="p",
                                       pcgan_weights_dir=str(wdir), eval_tot_samples=20))
    ds = JetNetDataset("g", num_particles=8, synthetic_num_jets=100)
    with pytest.raises(FileNotFoundError, match="pcgan_G_pc_g.pt"):
        Trainer(args, ds, ds, device="cpu").eval_save_plot(0)
