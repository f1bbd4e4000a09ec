"""The PyTorch port's initial weights against the JAX package's, from one key.

Every model initialiser of the port draws from a threefry key as the JAX
function it mirrors draws from the same key (``mpgan_tpu_torch/ops/init.py``).
For each JAX init function, a module built from ``PRNGKey(s)`` is held to a
module of the same config that took the JAX init of ``PRNGKey(s)`` through the
converters (``utils/weights``), every ``state_dict`` tensor:

- uniform-drawn leaves and constants bit for bit;
- normal-drawn leaves and those derived from them (spectral norm's
  ``weight_u``/``weight_v``, FPND's random trunk) within rtol = atol = 1e-6
  (``prng.normal`` is within a few ulps of XLA's, ``tests/test_torch_prng.py``).

Then the Trainer: its state from ``--seed N`` is ``init_train_state(PRNGKey(N))``
leaf by leaf, its key included (flagship, 150-particle knn-20, GAPT, a zoo
pair); one epoch of both packages' trainers from one seed, no weights carried,
saves states within 1e-4; the random-trunk FPND equals the JAX package's; a
``torch.Generator`` is refused.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one thread a test worker: the suite runs in parallel workers

import jax
import jax.numpy as jnp

from mpgan_tpu.data.jetnet import JetNetDataset as JJetNetDataset
from mpgan_tpu.evaluation import fpnd as jfpnd
from mpgan_tpu.models import gapt as jgapt
from mpgan_tpu.models import registry as jregistry
from mpgan_tpu.models.ext import pcgan as jpcgan
from mpgan_tpu.ops import attention as jattention
from mpgan_tpu.ops import linear as jlinear
from mpgan_tpu.ops import mp as jmp
from mpgan_tpu.training import checkpoint as jckpt
from mpgan_tpu.training import config as jconfig
from mpgan_tpu.training import optimizers as jopt
from mpgan_tpu.training import train_step as jts
from mpgan_tpu.training.loop import Trainer as JTrainer
from mpgan_tpu_torch.data.jetnet import JetNetDataset as TJetNetDataset
from mpgan_tpu_torch.evaluation import fpnd as tfpnd
from mpgan_tpu_torch.models import gapt as tgapt
from mpgan_tpu_torch.models import registry as tregistry
from mpgan_tpu_torch.models.ext import pcgan as tpcgan
from mpgan_tpu_torch.ops import attention as tattention
from mpgan_tpu_torch.ops import init
from mpgan_tpu_torch.ops import linear as tlinear
from mpgan_tpu_torch.ops import mp as tmp
from mpgan_tpu_torch.ops import prng
from mpgan_tpu_torch.training import checkpoint as tckpt
from mpgan_tpu_torch.training import config as tconfig
from mpgan_tpu_torch.training.loop import Trainer as TTrainer
from mpgan_tpu_torch.utils import weights as tweights

NORMAL_TOL = dict(rtol=1e-6, atol=1e-6)
TOL = dict(rtol=1e-4, atol=1e-4)  # tests/test_torch_keyed_steps.py's
SEEDS = [0, 11]
NORMAL_NAMES = ("weight_u", "weight_v")  # spectral norm's u and the v derived from it


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _same_bits(a: np.ndarray, b: np.ndarray, what: str) -> None:
    assert a.shape == b.shape and a.dtype == b.dtype, what
    np.testing.assert_array_equal(a.reshape(-1).view(np.uint8), b.reshape(-1).view(np.uint8),
                                  err_msg=what)


def _same_state(got: torch.nn.Module, want: torch.nn.Module) -> None:
    """Every state-dict tensor: normal-derived ones at 1e-6, the rest bit for bit."""
    sg, sw = got.state_dict(), want.state_dict()
    assert sg.keys() == sw.keys()
    for name in sg:
        a, b = sg[name].detach().cpu().numpy(), sw[name].detach().cpu().numpy()
        if name.endswith(NORMAL_NAMES):
            np.testing.assert_allclose(a, b, err_msg=name, **NORMAL_TOL)
        else:
            _same_bits(a, b, name)


def _carry(template: torch.nn.Module, leaves, params, state) -> torch.nn.Module:
    """JAX ``(params, state)`` into ``template`` through ``leaves(module,
    params: bool)``, the module's tensors in the JAX trees' flatten order."""
    with torch.no_grad():
        for tree, is_params in ((params, True), (state, False)):
            theirs, ours = tweights.tree_leaves(_np(tree)), leaves(template, is_params)
            assert len(theirs) == len(ours)
            for t, leaf in zip(ours, theirs):
                assert tuple(t.shape) == leaf.shape
                t.copy_(torch.from_numpy(np.array(leaf, np.float32)))
    tweights.refresh_sn_v(template)
    return template


# ---------------------------------------------------------------------------
# the building blocks: (port module of a key, JAX (params, state) of a key,
# the module's leaves in the JAX order)
# ---------------------------------------------------------------------------

MLP_KW = dict(sizes=(5, 7, 6, 3), leaky_relu_alpha=0.2)
GAPT_KW = dict(embed_dim=8, num_heads=2, sab_fc_layers=(12,), num_particles=6,
               feat_size=3, is_generator=True, final_fc_layers=(10,))


def _lin_leaves(m, params):
    return [m.bias, m.weight] if params else []


def _mp_layer_cfg(mod):
    return mod.MPLayerConfig.build(4, [9, 7], [6], 5,
                                   linear_args=dict(spectral_norm=True, batch_norm=True))


def _mab_cfg(mod):
    return mod.MABConfig.build(8, 2, ff_layers=[12], layer_norm=True, final_linear=False,
                               linear_args=dict(spectral_norm=True))


def _gapt_cfg(mod, **kw):
    return mod.GAPTConfig(**dict(GAPT_KW, sab_layers=2, **kw))


def _g_inv_leaves(m, params):
    if not params:
        return []
    out = []
    for pe in (m.phi[0], m.phi[2], m.phi[4]):
        out += [pe.Gamma.bias, pe.Gamma.weight]
        if pe.pool in ("max", "mean"):
            out.append(pe.Lambda.weight)
    return out + [m.ro[0].bias, m.ro[0].weight, m.ro[2].bias, m.ro[2].weight]


def _g_pc_leaves(m, params):
    if not params:
        return []
    out = [m.fc.bias, m.fc.weight, m.fu.weight]
    for i in (1, 3, 5, 7):
        out += [m.main[i].bias, m.main[i].weight]
    return out + [m.main[9].bias, m.main[9].weight]


PCGAN_KW = dict(node_feat_size=3, z1_dim=12, z2_dim=4, d_dim=16)

BLOCKS = {
    # linear_init
    "linear": (lambda k: tlinear.make_linear(5, 7, k),
               lambda k: (jlinear.linear_init(k, 5, 7), {}), _lin_leaves),
    # mlp_init, with batch norm and spectral norm
    "mlp_sn_bn": (
        lambda k: tlinear.MLP(tlinear.MLPConfig(**MLP_KW, final_linear=True, batch_norm=True,
                                                spectral_norm=True), k),
        lambda k: jlinear.mlp_init(k, jlinear.MLPConfig(**MLP_KW, final_linear=True,
                                                        batch_norm=True, spectral_norm=True)),
        tweights._mlp_leaves),
    # mp_layer_init
    "mp_layer": (lambda k: tmp.MPLayer(_mp_layer_cfg(tmp), k),
                 lambda k: jmp.mp_layer_init(k, _mp_layer_cfg(jmp)),
                 lambda m, p: tweights._mlp_leaves(m.fe, p) + tweights._mlp_leaves(m.fn, p)),
    # mha_init
    "mha": (lambda k: tattention.MHA(8, 2, k), lambda k: (jattention.mha_init(k, 8), {}),
            lambda m, p: [m.in_proj_bias, m.in_proj_weight, m.out_proj.bias,
                          m.out_proj.weight] if p else []),
    # mab_init
    "mab": (lambda k: tattention.MAB(_mab_cfg(tattention), k),
            lambda k: jattention.mab_init(k, _mab_cfg(jattention)), tweights._mab_leaves),
    # _sab_init: one MAB, and an ISAB (_xavier_uniform's inducing points)
    "sab": (lambda k: tgapt.SAB(_gapt_cfg(tgapt), k),
            lambda k: jgapt._sab_init(k, _gapt_cfg(jgapt), jnp.float32), tweights._sab_leaves),
    "isab": (lambda k: tgapt.SAB(_gapt_cfg(tgapt, use_isab=True, num_isab_nodes=4), k),
             lambda k: jgapt._sab_init(k, _gapt_cfg(jgapt, use_isab=True, num_isab_nodes=4),
                                       jnp.float32),
             tweights._sab_leaves),
    # g_inv_init (the Lambda maps of the max and mean pools) and g_pc_init
    **{f"g_inv_{pool}": (
        lambda k, pool=pool: tpcgan.GInv(tpcgan.PCGANConfig(**PCGAN_KW, pool=pool), k),
        lambda k, pool=pool: jpcgan.g_inv_init(k, jpcgan.PCGANConfig(**PCGAN_KW, pool=pool)),
        _g_inv_leaves) for pool in ("max1", "max", "mean")},
    "g_pc": (lambda k: tpcgan.GPc(tpcgan.PCGANConfig(**PCGAN_KW), k),
             lambda k: jpcgan.g_pc_init(k, jpcgan.PCGANConfig(**PCGAN_KW)), _g_pc_leaves),
}


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("block", list(BLOCKS))
def test_block_init_matches_jax(block, seed):
    port, jinit, leaves = BLOCKS[block]
    got = port(prng.PRNGKey(seed))
    params, state = jinit(jax.random.PRNGKey(seed))
    want = _carry(port(prng.PRNGKey(seed + 1000)), leaves, params, state)
    _same_state(got, want)


@pytest.mark.parametrize("shape", [(1, 4, 8), (1, 1, 8)])
def test_xavier_uniform_matches_jax(shape):
    got = tgapt._xavier_uniform(shape, init.root(prng.PRNGKey(3)))
    want = jgapt._xavier_uniform(jax.random.PRNGKey(3), shape, jnp.float32)
    _same_bits(got.detach().numpy(), np.asarray(want), "xavier")


# ---------------------------------------------------------------------------
# whole generators and discriminators through the registries
# ---------------------------------------------------------------------------

FLAGSHIP = {"model": "mpgan"}  # the published 30-particle widths
ZOO = dict(jets="g", num_hits=8, hidden_node_size=8, fe=[8, 8], fn=[8], lfc_latent_size=12,
           latent_dim=8, rgang_fc=[16], rgand_sfc=[8, 12], rgand_fc=[8],
           pointnetd_pointfc=[8, 12], pointnetd_fc=[8], graphcnng_layers=[6, 5],
           treegang_features=[8, 6, 3], treegang_degrees=[2, 4], treegang_support=3,
           pcgan_latent_dim=8, pcgan_z1_dim=12, pcgan_z2_dim=4, pcgan_d_dim=16)
GAPT = {"model": "gapt", "num_hits": 8, "gapt_embed_dim": 16, "num_heads": 2,
        "sab_layers_gen": 2, "sab_layers_disc": 2}
SUITES = {
    # mp_generator_init / mp_discriminator_init at full width
    "flagship": FLAGSHIP,
    # lfc (keys[-2]) and the learned mask's fmg (keys[-1])
    "mpgan_lfc_fmg": dict(ZOO, model="mpgan", lfc=True, mask_learn=True, mask_c=False,
                          spectral_norm_disc=True, batch_norm_gen=True),
    # gapt_g_init / gapt_d_init (PMA's seed and MAB), with ISAB
    "gapt": GAPT,
    "gapt_isab": dict(GAPT, use_isab=True, num_isab_nodes=4, layer_norm=True),
    # old_mpgan_init: lfc from keys[-3]; its D's fnd from keys[-2]
    "old_mpgan": dict(ZOO, model="old_mpgan", model_D="old_mpgan", lfc=True,
                      lr_disc=3e-5, lr_gen=1e-5),
    # rgan_g_init / rgan_d_init
    "rgan": dict(ZOO, model="rgan", model_D="rgan"),
    # graphcnn_g_init / pointnet_d_init
    "graphcnn_pointnet": dict(ZOO, model="graphcnngan", model_D="pointnet", num_hits=24),
    # treegan_g_init
    "treegan": dict(ZOO, model="treegan", model_D="rgan"),
    # latent_g_init / latent_d_init
    "pcgan": dict(ZOO, model="pcgan", model_D="pcgan"),
}


def _suites(card):
    return (tregistry.build_suite(tconfig.from_args_dict(card)),
            jregistry.build_suite(jconfig.from_args_dict(card)))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("side", ["G", "D"])
@pytest.mark.parametrize("suite", list(SUITES))
def test_model_init_matches_jax(suite, side, seed):
    ts, js = _suites(SUITES[suite])
    if side == "G":
        build, jinit, jcfg = ts.generator, js.g_init, js.g_cfg
    else:
        build, jinit, jcfg = ts.discriminator, js.d_init, js.d_cfg
    got = build(prng.PRNGKey(seed))
    params, state = jinit(jax.random.PRNGKey(seed), jcfg)
    want = tweights.load_jax_trees(build(prng.PRNGKey(seed + 1000)), _np(params), _np(state))
    _same_state(got, want)


def test_the_default_key_is_prngkey_0():
    ts, _ = _suites(SUITES["gapt"])
    _same_state(ts.generator(), ts.generator(prng.PRNGKey(0)))
    with torch.no_grad():
        assert not torch.equal(ts.generator().final_fc.net[0].weight,
                               ts.generator(prng.PRNGKey(1)).final_fc.net[0].weight)


@pytest.mark.parametrize("build", [
    lambda g: tlinear.MLP(tlinear.MLPConfig(**MLP_KW), g),
    lambda g: tattention.MHA(8, 2, g),
    lambda g: _suites(FLAGSHIP)[0].generator(g),
    lambda g: tfpnd.particlenet_init(g),
], ids=["mlp", "mha", "registry", "fpnd"])
def test_a_torch_generator_is_refused(build):
    with pytest.raises(TypeError, match="threefry key"):
        build(torch.Generator().manual_seed(0))


# ---------------------------------------------------------------------------
# the Trainer's state, and one epoch of both trainers from one seed
# ---------------------------------------------------------------------------

TRAINERS = {
    "flagship": dict(FLAGSHIP, num_samples=100, batch_size=8),
    "knn20_150p": {"model": "mpgan", "num_hits": 150, "fully_connected": False, "num_knn": 20,
                   "num_samples": 100, "batch_size": 8},
    "gapt": dict(GAPT, num_samples=100, batch_size=8),
    "treegan_pointnet": dict(ZOO, model="treegan", model_D="pointnet", num_samples=100,
                             batch_size=8),
}


def _normal_positions(state) -> set[int]:
    """The positions of spectral norm's ``u`` among ``train_state_leaves``."""
    u = {t.data_ptr() for m in (state.g, state.d) for n, t in m.named_buffers()
         if n.endswith("weight_u")}
    leaves = (tweights.jax_leaves(state.g, True) + tweights.jax_leaves(state.g, False)
              + tweights.jax_leaves(state.d, True) + tweights.jax_leaves(state.d, False))
    return {i for i, t in enumerate(leaves) if t.data_ptr() in u}


@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("case", list(TRAINERS))
def test_trainer_state_is_jax_init_train_state(case, seed, tmp_path):
    card = dict(TRAINERS[case], name="i", seed=seed, dir_path=str(tmp_path))
    t = TTrainer(tconfig.from_args_dict(card), device="cpu")
    ja = jconfig.from_args_dict(card)
    js = jregistry.build_suite(ja)
    opt = lambda lr: jopt.build_optimizer(ja.optimizer, lr, beta1=ja.beta1,  # noqa: E731
                                          beta2=ja.beta2)
    jstate = jts.init_train_state(jax.random.PRNGKey(seed), js.g_init, js.d_init, js.g_cfg,
                                  js.d_cfg, opt(ja.lr_gen), opt(ja.lr_disc))
    got, want = tckpt.train_state_leaves(t.state), [np.asarray(x) for x in
                                                    jax.tree.leaves(jstate)]
    assert len(got) == len(want)
    normal = _normal_positions(t.state)
    assert bool(normal) == bool(ja.spectral_norm_disc or ja.spectral_norm_gen)
    for i, (a, b) in enumerate(zip(got, want)):
        if i in normal:
            np.testing.assert_allclose(a, b, err_msg=f"leaf {i}", **NORMAL_TOL)
        else:
            _same_bits(np.asarray(a, b.dtype), b, f"leaf {i}")
    _same_bits(got[-1], want[-1], "key")


EPOCH = {"name": "e", "model": "mpgan", "jets": "g", "num_hits": 8, "hidden_node_size": 8,
         "fe": [12], "fn": [16], "batch_size": 16, "num_samples": 100,
         "eval_tot_samples": 64, "w1_num_samples": [50], "spectral_norm_disc": True,
         "batch_norm_gen": True, "num_epochs": 1, "save_epochs": 5, "save_model_epochs": 1,
         "epoch_scan": False}
DS = dict(jet_type="g", data_dir=None, num_particles=8, synthetic_num_jets=100,
          mask_feature=True)


def test_one_epoch_from_one_seed_matches_jax(tmp_path):
    """Both trainers from ``--seed 3``, nothing carried between them: the
    saved ``state_1.npz`` leaves agree within 1e-4."""
    card = dict(EPOCH, seed=3)
    jt = JTrainer(jconfig.from_args_dict(dict(card, dir_path=str(tmp_path / "j"))),
                  train_dataset=JJetNetDataset(**DS, split="train"),
                  valid_dataset=JJetNetDataset(**DS, split="valid"))
    jt.train()
    tt = TTrainer(tconfig.from_args_dict(dict(card, dir_path=str(tmp_path / "t"))),
                  TJetNetDataset(**DS, split="train"), TJetNetDataset(**DS, split="valid"),
                  device="cpu")
    tt.train()
    with np.load(jckpt.checkpoint_path(jt.models_dir, 1)) as jf, \
            np.load(tckpt.checkpoint_path(tt.models_dir, 1)) as tf:
        assert sorted(jf.files) == sorted(tf.files)
        for name in jf.files:
            np.testing.assert_allclose(tf[name], jf[name], err_msg=name, **TOL)
    np.testing.assert_allclose(tt.losses["G"], jt.losses["G"], **TOL)


# ---------------------------------------------------------------------------
# FPND's random trunk
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [42, 7])
def test_random_trunk_matches_jax(seed):
    got = tfpnd.particlenet_init(prng.PRNGKey(seed) if seed != 42 else None)
    want = jfpnd.particlenet_init(jax.random.PRNGKey(seed))
    theirs, ours = tweights.tree_leaves(_np(want)), tweights.tree_leaves(got)
    assert len(theirs) == len(ours) == 64
    for a, b in zip(ours, theirs):
        if a.ndim == 2:  # the normal-drawn weights
            np.testing.assert_allclose(a, b, **NORMAL_TOL)
        else:
            _same_bits(a, b, "batch norm")


def test_random_trunk_fpnd_matches_jax():
    rng = np.random.default_rng(2)
    real = rng.normal(scale=0.3, size=(64, 30, 3)).astype(np.float32)
    gen = rng.normal(scale=0.3, size=(64, 30, 3)).astype(np.float32)
    real[..., 2], gen[..., 2] = np.abs(real[..., 2]), np.abs(gen[..., 2])
    gen[:, 12:] = 0
    j = jfpnd.fpnd(real, gen, None, batch_size=64, num_samples=64)
    t = tfpnd.fpnd(real, gen, None, batch_size=64, num_samples=64, device="cpu")
    assert j > 0 and t == pytest.approx(j, rel=1e-4)
    assert math.isfinite(t)
