"""The port's steps and generation drawing from their own keys, against the JAX
package, with no draws passed.

- from a JAX ``init_train_state`` carried across whole, its ``rng`` included
  (the TrainState's leaves through ``training/checkpoint.py``), three D+G steps
  of the flagship (the kernels' plain path, D dropout, smoothed and flipped
  targets), GAPT, knn and a WGAN-GP card with every augmentation: the loss
  parts, the parameters and the models' state within 1e-4 after each step,
  and the state's key equal to JAX's bit for bit after each step;
- the static step (the epoch's CUDA-graph body, run as it is on the CPU) takes
  the same three steps from the key: equal to the eager steps bit for bit;
- ``cli.gen`` from a JAX TrainState ``.npz`` with the same ``--seed`` writes
  JAX ``gen``'s jets within 1e-4 (30 particles, MPGAN and GAPT, small);
- a resume from a JAX checkpoint continues JAX's stream;
- the trainer seeds the step key as the JAX trainer does.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one thread a test worker: the suite runs in parallel workers

import jax
import jax.numpy as jnp

from mpgan_tpu.cli import gen as jgen
from mpgan_tpu.models import registry as jregistry
from mpgan_tpu.ops.augment import AugmentConfig as JAugmentConfig
from mpgan_tpu.training import checkpoint as jckpt
from mpgan_tpu.training import config as jconfig
from mpgan_tpu.training import optimizers as jopt
from mpgan_tpu.training import train_step as jts
from mpgan_tpu_torch.cli import gen as tgen
from mpgan_tpu_torch.data.jetnet import JetNetDataset
from mpgan_tpu_torch.models import registry as tregistry
from mpgan_tpu_torch.ops import prng
from mpgan_tpu_torch.training import checkpoint as tckpt
from mpgan_tpu_torch.training import config as tconfig
from mpgan_tpu_torch.training import optimizers as topt
from mpgan_tpu_torch.training import train_step as tts
from mpgan_tpu_torch.utils.weights import jax_leaves, tree_leaves

TOL = dict(rtol=1e-4, atol=1e-4)
B = 6
NARROW = {"model": "mpgan", "num_hits": 10, "hidden_node_size": 8, "fe": [12, 16], "fn": [16]}
CASES = {
    "flagship": dict(NARROW, use_pallas=True, label_smoothing=True, label_noise=0.2),
    "gapt": {"model": "gapt", "num_hits": 8, "gapt_embed_dim": 16, "num_heads": 2,
             "sab_layers_gen": 2, "sab_layers_disc": 1},
    "knn": dict(NARROW, fully_connected=False, num_knn=4, use_pallas=False),
    # no mask column: the JAX augmentation takes 3-feature clouds only
    "wgan_gp_aug": dict(NARROW, loss="w", gp=10.0, aug_t=True, aug_f=True, aug_r90=True,
                        aug_s=True, aug_prob=0.5, mask_c=False, use_pallas=False),
}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_step_config(a):
    return jts.StepConfig(
        loss=a.loss, gp_lambda=a.gp, label_smoothing=a.label_smoothing,
        label_noise=a.label_noise, aug_prob=a.aug_prob,
        augment=JAugmentConfig(aug_t=a.aug_t, aug_f=a.aug_f, aug_r90=a.aug_r90, aug_s=a.aug_s,
                               translate_ratio=a.translate_ratio, scale_sd=a.scale_sd))


class Pair:
    """A card's JAX TrainState and jitted steps, and port states carried from it."""

    def __init__(self, card, seed=0):
        self.jargs, self.targs = jconfig.from_args_dict(card), tconfig.from_args_dict(card)
        ja = self.jargs
        self.js = jregistry.build_suite(ja)
        self.ts = tregistry.build_suite(self.targs)
        opt = lambda lr: jopt.build_optimizer(ja.optimizer, lr, beta1=ja.beta1,  # noqa: E731
                                              beta2=ja.beta2)
        g_opt, d_opt = opt(ja.lr_gen), opt(ja.lr_disc)
        js = self.js
        self.jstate = jts.init_train_state(jax.random.PRNGKey(seed), js.g_init, js.d_init,
                                           js.g_cfg, js.d_cfg, g_opt, d_opt)
        self.use_labels = bool(ja.get("mask_c") or ja.clabels or ja.get("gapt_mask"))
        d_step, g_step = jts.make_train_steps(
            step_cfg=_jax_step_config(ja), g_apply=js.g_apply, d_apply=js.d_apply,
            g_cfg=js.g_cfg, d_cfg=js.d_cfg, spec=js.noise, g_opt=g_opt, d_opt=d_opt,
            use_labels=self.use_labels, encode_real=js.encode_real, post_gen=js.post_gen)
        self.d_step, self.g_step = jax.jit(d_step), jax.jit(g_step)
        ds = JetNetDataset("g", num_particles=ja.num_hits, synthetic_num_jets=100,
                           mask_feature=bool(ja.get("mask")))
        self.data = ds.particle_data[:3 * B]
        self.labels = ds.jet_data[:3 * B] if self.use_labels else None

    def port_state(self, key_seed=99):
        """A port TrainState holding the JAX state's leaves, its key among them."""
        a, s = self.targs, self.ts
        g, d = s.generator(prng.PRNGKey(1)), s.discriminator(prng.PRNGKey(2))
        opt = lambda m, lr: topt.build_optimizer(a.optimizer, m.parameters(), lr,  # noqa: E731
                                                 beta1=a.beta1, beta2=a.beta2)
        st = tts.TrainState(g, d, opt(g, a.lr_gen), opt(d, a.lr_disc), prng.PRNGKey(key_seed))
        tckpt.load_train_state_leaves(st, [np.asarray(x) for x in jax.tree.leaves(self.jstate)])
        return st

    def batch(self, i):
        rows = slice(i * B, (i + 1) * B)
        data = self.data[rows]
        labels = None if self.labels is None else self.labels[rows]
        return data, labels

    def jax_steps(self, n):
        """``n`` D+G steps of JAX: the states after each and the loss parts."""
        st, out = self.jstate, []
        for i in range(n):
            data, labels = self.batch(i)
            args = (jnp.asarray(data),) + ((jnp.asarray(labels),) if labels is not None else ())
            st, d_parts = self.d_step(st, *args)
            st, g_parts = self.g_step(st, *args)
            out.append((st, {**d_parts, **g_parts}))
        return out


def _port_eager_step(pair, st, i):
    data, labels = pair.batch(i)
    td = torch.from_numpy(data)
    tl = None if labels is None else torch.from_numpy(labels)
    cfg, spec = tts.step_config(pair.targs), pair.ts.noise
    parts = tts.d_step(st, cfg, spec, td, tl, post_gen=pair.ts.post_gen,
                       encode_real=pair.ts.encode_real)
    parts.update(tts.g_step(st, cfg, spec, td, tl, post_gen=pair.ts.post_gen))
    return parts


def _check_against_jax(st, jst, parts, jparts):
    assert set(parts) == set(jparts)
    for k in jparts:
        np.testing.assert_allclose(parts[k].numpy(), np.asarray(jparts[k]), **TOL)
    ours = jax_leaves(st.g, True) + jax_leaves(st.d, True) + jax_leaves(st.g, False) \
        + jax_leaves(st.d, False)
    theirs = tree_leaves(_np(jst.g_params)) + tree_leaves(_np(jst.d_params)) \
        + tree_leaves(_np(jst.g_state)) + tree_leaves(_np(jst.d_state))
    assert len(ours) == len(theirs)
    for t, j in zip(ours, theirs):
        np.testing.assert_allclose(t.detach().numpy(), j, **TOL)
    np.testing.assert_array_equal(st.rng.numpy(), np.asarray(jst.rng))


@pytest.fixture(scope="module", params=list(CASES))
def pair(request):
    return request.param, Pair(CASES[request.param])


def test_three_keyed_steps_match_jax(pair):
    """No draws passed: noise, targets, GP weight, augmentation and dropout keys
    all come from the carried key, as JAX's do."""
    _, p = pair
    st = p.port_state()
    np.testing.assert_array_equal(st.rng.numpy(), np.asarray(p.jstate.rng))
    for i, (jst, jparts) in enumerate(p.jax_steps(3)):
        parts = _port_eager_step(p, st, i)
        _check_against_jax(st, jst, parts, jparts)


def test_static_steps_equal_eager_steps_bit_for_bit(pair):
    """The epoch's static "dg" step (one plan drawn a step from the key at a
    batch counter, run as it is on the CPU) against the eager steps."""
    _, p = pair
    eager, static = p.port_state(), p.port_state()
    eager_parts = [_port_eager_step(p, eager, i) for i in range(3)]
    data = torch.from_numpy(p.data)
    labels = None if p.labels is None else torch.from_numpy(p.labels)
    keys = list(eager_parts[0])
    graphs = tts.StepGraphs(static, tts.step_config(p.targs), p.ts.noise, keys, "cpu",
                            post_gen=p.ts.post_gen, encode_real=p.ts.encode_real)
    order = np.arange(3 * B).reshape(3, B)
    graphs.epoch(tts.step_kinds(3), data, labels, order)
    for k in keys:
        want = sum(parts[k] for parts in eager_parts)
        assert torch.equal(graphs.sums[k], want), k
    for a, b in zip([*eager.g.parameters(), *eager.d.parameters(), *eager.g.buffers(),
                     *eager.d.buffers()],
                    [*static.g.parameters(), *static.d.parameters(), *static.g.buffers(),
                     *static.d.buffers()]):
        assert torch.equal(a, b)
    assert torch.equal(eager.rng, static.rng)
    assert int(graphs.counter) == 3


def test_eager_steps_draw_their_dropout_keys_in_one_launch_a_part(pair, monkeypatch):
    """From its second step on, an eager part draws its dropout keys in the
    launch of its draws (the last run's requests, ``ops/keys.KeyLog``): one
    ``threefry_draws`` a part; the first step draws each key alone."""
    _, p = pair
    st = p.port_state()
    launches = []
    plain = prng.threefry_draws
    monkeypatch.setattr(prng, "threefry_draws",
                        lambda *a, **k: (launches.append(1), plain(*a, **k))[1])
    per_step = []
    for i in range(3):
        before = len(launches)
        _port_eager_step(p, st, i)
        per_step.append(len(launches) - before)
    requests = sum(len(log.log) for log in st.key_logs.values())
    assert per_step == [2 + requests, 2, 2]


def test_key_log_serves_the_log_and_draws_what_it_lacks():
    """A run that leaves the log is served by keys drawn alone, with the same
    values; its requests become the next log."""
    from mpgan_tpu_torch.ops.keys import KeyLog, Keys

    root = prng.PRNGKey(8)
    src = {"a": Keys(root, (2,)), "b": Keys(root, (3, 1))}
    log = KeyLog()
    want = lambda r, path, kind: getattr(Keys(root, src[r].path + path), kind)()  # noqa: E731
    runs = [[("words", "a", (0,)), ("edge_seed", "b", ())],
            [("words", "a", (0,)), ("edge_seed", "b", ())],
            [("words", "a", (0,)), ("words", "b", (1,)), ("edge_seed", "a", ())]]
    for run in runs:
        log.renew()
        rows = log.rows({"a": (2,), "b": (3, 1)})
        values = prng.draw(root, rows) if rows else []
        log.begin(src, values)
        for kind, r, path in run:
            key = log.root(r)
            for i in path:
                key = key.split(i + 1)[i]
            assert torch.equal(getattr(key, kind)(), want(r, path, kind))
    log.renew()
    assert log.log == runs[-1]


def test_step_kinds_interleave():
    assert tts.step_kinds(3) == [(0, "dg"), (1, "dg"), (2, "dg")]
    assert tts.step_kinds(3, num_critic=2) == [(0, "d"), (1, "d"), (1, "g"), (2, "d")]
    assert tts.step_kinds(4, num_gen=2) == [(0, "d"), (0, "g"), (1, "d"), (1, "g"), (2, "g"),
                                            (3, "d"), (3, "g")]


def test_resume_from_a_jax_checkpoint_continues_its_stream(tmp_path):
    """A JAX state saved after one step, loaded by the port, steps on as JAX does."""
    p = Pair(CASES["flagship"], seed=3)
    (j1, _), (j2, jparts) = p.jax_steps(2)
    path = tmp_path / "state_1.npz"
    jckpt.save_train_state(path, j1)
    st = p.port_state(key_seed=5)
    tckpt.load_train_state(path, st)
    np.testing.assert_array_equal(st.rng.numpy(), np.asarray(j1.rng))
    parts = _port_eager_step(p, st, 1)
    _check_against_jax(st, j2, parts, jparts)
    # and the port's own checkpoint stores the key as it is
    tckpt.save_train_state(tmp_path / "state_2.npz", st)
    with np.load(tmp_path / "state_2.npz") as f:
        np.testing.assert_array_equal(f[f"leaf_{len(f.files) - 1}"], np.asarray(j2.rng))


def test_trainer_seeds_its_key_as_the_jax_trainer(tmp_path):
    from mpgan_tpu_torch.training.loop import Trainer

    args = tconfig.from_args_dict(dict(NARROW, name="k", seed=7, dir_path=str(tmp_path),
                                       num_samples=100, batch_size=8))
    t = Trainer(args, device="cpu")
    kg, kd, krest = jax.random.split(jax.random.PRNGKey(7), 3)
    np.testing.assert_array_equal(t.state.rng.numpy(), np.asarray(krest))


GEN_CARDS = {
    "mpgan30": {"model": "mpgan", "jets": "g", "num_hits": 30, "hidden_node_size": 8,
                "fe": [12, 8], "fn": [16]},
    "gapt30": {"model": "gapt", "jets": "g", "num_hits": 30, "gapt_embed_dim": 16,
               "num_heads": 2, "sab_layers_gen": 2, "sab_layers_disc": 1},
}


@pytest.mark.parametrize("case", list(GEN_CARDS))
def test_gen_cli_reproduces_jax_gen_from_its_weights_and_seed(case, tmp_path):
    card = GEN_CARDS[case]
    args = tconfig.from_args_dict(card)
    card_path = tmp_path / "card.txt"
    card_path.write_text(repr(args.to_dict()))
    p = Pair(card, seed=4)
    npz = tmp_path / "state_1.npz"
    jckpt.save_train_state(npz, p.jstate)
    common = ["--g-args", str(card_path), "--g-state", str(npz), "--num-samples", "10",
              "--batch-size", "4", "--seed", "11"]
    jgen.main(common + ["--output-file", str(tmp_path / "j.npy")])
    tgen.main(common + ["--output-file", str(tmp_path / "t.npy"), "--device", "cpu"])
    want, got = np.load(tmp_path / "j.npy"), np.load(tmp_path / "t.npy")
    assert got.shape == want.shape == (10, 30, 3)
    np.testing.assert_allclose(got, want, **TOL)
