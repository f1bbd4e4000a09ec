"""The port's data-parallel step and sampler against the JAX package's
(``parallel/mesh.py``; ``mpgan_tpu/parallel/mesh.py``).

- one D step then one G step on a 2-rank gloo mesh against the JAX step built
  with ``pmean_axis="data"`` under ``shard_map_step`` on a 2-device mesh, on
  the same shards, from the JAX state's key with no draws passed: each rank
  folds its rank into the step's split keys (``train_step.py:176-179, 182,
  261``) and ends on JAX's next key, bit for bit. Loss parts within 1e-5,
  the gradients and updates within ``_compare_update``'s bounds, the models'
  state (BN running statistics, SN vectors) after both steps within 1e-4; the
  parameters and buffers equal bit for bit across the ranks. Cases: the dense card with D dropout 0.5 (K1's
  masks on the kernels' plain path), the ``graphcnn`` zoo family (its G's
  train-mode BN makes the state differ between shards) and SN in D;
- ``generate_multi_batch`` on 2 ranks against one process
  (``tests/test_training.py:374-396``'s counterpart);
- a mesh of one with given draws is the step without a mesh, bit for bit; the
  per-rank keys (JAX's ``fold_in``), the reduce, ``make_mesh``'s refusals and
  the rows of a rank.

The ranks run ``tests/torch_mesh_ranks.py`` through ``mesh.launch``, every
case of this module in one world (:func:`ranks`).
"""

import dataclasses

import numpy as np
import optax
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one thread a test worker: the suite runs in parallel workers

import jax
import jax.numpy as jnp

from mpgan_tpu.models import registry as jregistry
from mpgan_tpu.parallel.mesh import make_mesh as jmake_mesh
from mpgan_tpu.parallel.mesh import shard_map_step
from mpgan_tpu.training import config as jconfig
from mpgan_tpu.training import optimizers as jopt
from mpgan_tpu.training import train_step as jts
from mpgan_tpu_torch.data.jetnet import JetNetDataset
from mpgan_tpu_torch.models import registry as tregistry
from mpgan_tpu_torch.ops import prng
from mpgan_tpu_torch.ops.keys import Keys
from mpgan_tpu_torch.parallel import mesh as tmesh
from mpgan_tpu_torch.training import config as tconfig
from mpgan_tpu_torch.training import sampling as tsampling
from mpgan_tpu_torch.training import train_step as tts
from mpgan_tpu_torch.utils.weights import load_jax_trees, tree_leaves

import torch_mesh_ranks
from test_torch_ops import port_keys
from test_torch_train_step import NARROW, _batch, _compare_update, _step_pair
from test_torch_zoo import WIDTHS

RANKS = 2
B = 8  # the global batch, 4 rows a rank
FWD_TOL = dict(rtol=1e-5, atol=1e-5)
STATE_TOL = dict(rtol=1e-4, atol=1e-4)

CARDS = {
    "dense_dropout": dict(NARROW, disc_dropout=0.5, use_pallas=True),
    "graphcnn": dict(WIDTHS, model="graphcnngan", model_D="rgan", num_hits=24),
    "spectral_norm": dict(NARROW, spectral_norm_disc=True, use_pallas=False),
}
SAMPLER = dict(NARROW, use_pallas=True)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _keeping(opt):
    """``opt`` whose state also keeps the gradients of its last update (after
    the step's pmean, so replicated)."""
    def init(params):
        return opt.init(params), jax.tree.map(jnp.zeros_like, params)

    def update(grads, state, params=None):
        updates, inner = opt.update(grads, state[0], params)
        return updates, (inner, grads)
    return optax.GradientTransformation(init, update)


class _Pair:
    """A card's JAX suite and shard-mapped steps, the JAX-initialised state and
    the port's modules holding its weights."""

    def __init__(self, card):
        jargs, targs = jconfig.from_args_dict(card), tconfig.from_args_dict(card)
        self.jargs, self.targs = jargs, targs
        self.js, self.ts = jregistry.build_suite(jargs), tregistry.build_suite(targs)
        opt = lambda lr: _keeping(jopt.build_optimizer(  # noqa: E731
            jargs.optimizer, lr, beta1=jargs.beta1, beta2=jargs.beta2))
        js = self.js
        g_opt, d_opt = opt(jargs.lr_gen), opt(jargs.lr_disc)
        self.jstate = jts.init_train_state(jax.random.PRNGKey(0), js.g_init, js.d_init,
                                           js.g_cfg, js.d_cfg, g_opt, d_opt)
        self.use_labels = bool(jargs.get("mask_c") or jargs.clabels)
        d_step, g_step = jts.make_train_steps(
            step_cfg=jts.StepConfig(loss=jargs.loss, gp_lambda=jargs.gp), g_apply=js.g_apply,
            d_apply=js.d_apply, g_cfg=js.g_cfg, d_cfg=js.d_cfg, spec=js.noise, g_opt=g_opt,
            d_opt=d_opt, use_labels=self.use_labels, encode_real=js.encode_real,
            post_gen=js.post_gen, pmean_axis="data")
        mesh = jmake_mesh(RANKS)
        n = 1 + self.use_labels
        self.d_step = shard_map_step(d_step, mesh, num_batch_args=n, donate_state=False)
        self.g_step = shard_map_step(g_step, mesh, num_batch_args=n, donate_state=False)
        self.g, self.d = self.ts.generator(), self.ts.discriminator()
        load_jax_trees(self.g, _np(self.jstate.g_params), _np(self.jstate.g_state))
        load_jax_trees(self.d, _np(self.jstate.d_params), _np(self.jstate.d_state))


def _payload(pair, data, labels, j0):
    """The ranks' inputs: modules, optimizer, batch and the JAX state's key."""
    a = pair.targs
    return dict(g=pair.g, d=pair.d, data=data, labels=labels,
                opt=dict(optimizer=a.optimizer, beta1=a.beta1, beta2=a.beta2, lr_gen=a.lr_gen,
                         lr_disc=a.lr_disc),
                step_cfg=tts.StepConfig(loss=a.loss, gp_lambda=a.gp), spec=pair.ts.noise,
                post_gen=pair.ts.post_gen, encode_real=pair.ts.encode_real,
                rng=np.asarray(j0.rng).copy())


def _with_grads(params, grads):
    """Tensors holding a rank's parameters, each with its gradient."""
    out = []
    for p, g in zip(params, grads):
        t = torch.from_numpy(p)
        t.grad = torch.from_numpy(g)
        out.append(t)
    return out


def _stepped(case):
    """A card's JAX steps on the 2-device mesh and the ranks' payload."""
    pair = _Pair(CARDS[case])
    a = pair.targs
    ds = JetNetDataset("g", num_particles=a.num_hits, synthetic_num_jets=200,
                       mask_feature=bool(a.get("mask")))
    data, labels = ds.particle_data[:B], ds.jet_data[:B] if pair.use_labels else None
    batch = (jnp.asarray(data),) + ((jnp.asarray(labels),) if labels is not None else ())
    j0 = pair.jstate
    j1, jd_parts = pair.d_step(j0, *batch)
    j2, jg_parts = pair.g_step(j1, *batch)
    return (pair, (j0, j1, j2), jd_parts, jg_parts), _payload(pair, data, labels, j0)


def _sampler():
    suite = tregistry.build_suite(tconfig.from_args_dict(SAMPLER))
    g, spec = suite.generator(prng.PRNGKey(3)), suite.noise
    labels = (np.random.RandomState(0).randint(1, 11, size=50) / 10)[:, None].astype(np.float32)
    return dict(g=g, spec=spec, seed=1, n=50, batch=16, labels=labels)


@pytest.fixture(scope="module")
def ranks():
    """Every case's JAX side, then one 2-rank world running all of the port's
    sides: ``(jax, outputs)``, the outputs by rank, then by task."""
    jax_side, tasks = {}, []
    for case in CARDS:
        jax_side[case], payload = _stepped(case)
        tasks.append(("step", payload))
    sampler = _sampler()
    tasks += [("sample", dict(sampler, static=static)) for static in (True, False)]
    jax_side["sampler"] = sampler
    outs = tmesh.launch(torch_mesh_ranks.run_tasks, RANKS, "cpu", RANKS, tasks)
    return jax_side, outs


@pytest.mark.parametrize("case", list(CARDS))
def test_two_rank_d_and_g_step_match_jax_shard_map(ranks, case):
    jax_side, outs = ranks
    pair, (j0, j1, j2), jd_parts, jg_parts = jax_side[case]
    task = list(CARDS).index(case)
    lr_d, lr_g = pair.targs.lr_disc, pair.targs.lr_gen
    for out in (o[task] for o in outs):
        np.testing.assert_array_equal(out["rng_d"], np.asarray(j1.rng))
        np.testing.assert_array_equal(out["rng_g"], np.asarray(j2.rng))
        for k, v in jd_parts.items():
            np.testing.assert_allclose(out[k], np.asarray(v), **FWD_TOL)
        np.testing.assert_allclose(out["G"], np.asarray(jg_parts["G"]), **FWD_TOL)
        _compare_update(_with_grads(out["d_params"], out["d_grads"]), j0.d_params,
                        j1.d_params, j1.d_opt_state[1], lr_d)
        _compare_update(_with_grads(out["g_params"], out["g_grads"]), j1.g_params,
                        j2.g_params, j2.g_opt_state[1], lr_g)
        for t, leaf in zip(out["state"], tree_leaves(_np(j2.g_state))
                           + tree_leaves(_np(j2.d_state))):
            np.testing.assert_allclose(t, leaf, **STATE_TOL)
    for a, b in zip(outs[0][task]["all"], outs[1][task]["all"]):
        np.testing.assert_array_equal(a, b)
    if case == "graphcnn":  # the shards' BN statistics differ: the state's pmean is seen
        assert tree_leaves(_np(j2.g_state)) and not all(
            np.array_equal(a, b) for a, b in zip(tree_leaves(_np(j1.g_state)),
                                                 tree_leaves(_np(j2.g_state))))


@pytest.mark.parametrize("static", [True, False], ids=["static", "eager"])
def test_generate_multi_batch_on_two_ranks_matches_one_process(ranks, static):
    """Every rank draws the whole batch's noise and runs G on its rows: the
    single-process output, the mask multiplicities included, from the labels."""
    jax_side, outs = ranks
    p = jax_side["sampler"]
    single = tsampling.generate_multi_batch(p["g"], p["spec"], prng.PRNGKey(1),
                                            50, 16, labels=p["labels"], static=static)
    task = len(CARDS) + (not static)
    for out in (o[task] for o in outs):
        assert out.shape == single.shape == (50, 10, 4)
        np.testing.assert_allclose(out, single, rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal((out[:, :, -1] > 0).sum(1), (single[:, :, -1] > 0).sum(1))
    np.testing.assert_array_equal((single[:, :, -1] > 0).sum(1),
                                  np.round(p["labels"][:, 0] * 10).astype(int))
    np.testing.assert_array_equal(outs[0][task], outs[1][task])


# ---------------------------------------------------------------------------
# in this process: a mesh of one, the draws and the reduce
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def one():
    return tmesh.make_mesh(1, device_type="cpu")


def test_mesh_of_one_step_with_given_draws_is_the_step_without_a_mesh(one):
    """An all-reduce over one rank and a division by 1 are exact."""
    out = []
    for mesh in (None, one):
        (_, _, spec, jstate, *_), (tstate, tspec) = _step_pair(NARROW, True)
        data, labels = map(torch.from_numpy, _batch(NARROW, 4))
        _, k_noise, k_real, k_fake, *_ = jax.random.split(jstate.rng, 9)
        draws = tts.DDraws(torch.from_numpy(np.array(spec.sample(k_noise, 4)[0])),
                           port_keys(k_real), port_keys(k_fake))
        parts = tts.d_step(tstate, tts.StepConfig(), tspec, data, labels, draws=draws, mesh=mesh)
        gd = tts.GDraws(draws.noise, port_keys(k_real), port_keys(k_fake))
        parts.update(tts.g_step(tstate, tts.StepConfig(), tspec, data, labels, draws=gd,
                                mesh=mesh))
        out.append(([v.numpy() for v in parts.values()],
                    [p.detach().numpy().copy() for m in (tstate.g, tstate.d)
                     for p in m.parameters()]))
    for a, b in zip(out[0][0] + out[0][1], out[1][0] + out[1][1]):
        np.testing.assert_array_equal(a, b)


def test_mesh_step_draws_one_word_a_part_and_folds_in_the_rank(one):
    """Without a mesh the step's split keys are used as they are; with one each
    is folded with the rank (JAX's ``fold_in``), the next key is not: the ranks'
    draws differ, a mesh of one draws otherwise than no mesh, and the key
    advances alike on every rank."""
    assert tmesh.local_path(None) == ()
    key = jax.random.PRNGKey(7)
    tkey = prng.PRNGKey(7)
    for r in range(3):
        rank = dataclasses.replace(one, rank=r)
        assert tmesh.local_path(rank) == (r,)
        np.testing.assert_array_equal(Keys(tkey, tmesh.local_path(rank)).key().numpy(),
                                      np.asarray(jax.random.fold_in(key, r)))
    spec = tsampling.NoiseSpec((3, 2))
    draws = []
    for mesh in (None, one, dataclasses.replace(one, rank=1)):
        state = tts.TrainState(None, None, None, None, prng.PRNGKey(7))
        draws.append(tts.draw_g(state, tts.StepConfig(), spec, 4, "cpu", mesh=mesh).noise)
        np.testing.assert_array_equal(state.rng.numpy(), np.asarray(jax.random.split(key, 5)[0]))
    k_noise = jax.random.split(key, 5)[1]
    for got, k in zip(draws, (k_noise, jax.random.fold_in(k_noise, 0),
                              jax.random.fold_in(k_noise, 1))):
        want = jax.random.normal(jax.random.split(k)[0], (4, 3, 2)) * 0.2
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    assert not torch.equal(draws[0], draws[1]) and not torch.equal(draws[1], draws[2])


def test_pmean_reduces_in_one_kept_bucket(one):
    ts = [torch.arange(6.0).reshape(2, 3), None, torch.tensor(2.5), torch.ones(4)]
    want = [t.clone() for t in ts if t is not None]
    assert tmesh.pmean_(ts, one, "t") == 11 * 4
    bucket = one.bucket("t", 11, "cpu")
    assert one.bucket("t", 11, "cpu").data_ptr() == bucket.data_ptr()
    for t, w in zip([t for t in ts if t is not None], want):
        assert torch.equal(t, w)
    tmesh.pmean_(ts, one, "t")
    assert one.bucket("t", 11, "cpu").data_ptr() == bucket.data_ptr()


def test_make_mesh_rejects_oversubscription():
    """``tests/test_training.py:488-494``'s counterpart, on both device types."""
    with pytest.raises(ValueError, match="available"):
        tmesh.make_mesh(99, device_type="cpu")
    with pytest.raises(ValueError, match="available"):
        tmesh.make_mesh(torch.cuda.device_count() + 1, device_type="cuda")


def test_mesh_rows_and_backend(one):
    assert one.size == 1 and one.rank == 0 and one.is_main and one.backend == "gloo"
    assert one.rows(16) == slice(0, 16)
    two = dataclasses.replace(one, rank=1, size=2)
    assert two.rows(16) == slice(8, 16) and not two.is_main
    with pytest.raises(ValueError, match="does not split"):
        two.rows(15)
    with pytest.raises(ValueError, match="2-device mesh in a world of 1"):
        tmesh.make_mesh(devices=["cpu", "cpu"])
