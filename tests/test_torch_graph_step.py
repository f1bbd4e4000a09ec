"""The static-buffer step and sampler that the port replays as CUDA graphs, on the CPU.

- key slots: the plain versions of K2, K3, K5, K6 and K8 with a seed read from a
  slot equal the same calls with an int seed bit for bit, and K1 equals
  ``mp_pallas._dropmul``; ``hash_dropout`` with a slot equals the JAX package's;
- the step's plan fills the slots with the values the eager step's keys give,
  in its order, and leaves the state's key where the eager step leaves it;
- ``StaticStep`` run as it is (the CPU's path) equals ``d_step``/``g_step`` bit
  for bit: parameters, optimizer state, loss parts, key; from JAX's key, a D
  and a G step on it equal the JAX package's;
- a CPU ``Trainer`` with ``epoch_scan`` on and off trains alike, a legacy
  ``--mask-epoch`` crossing included; the static sampler equals the eager loop;
- ``CountedGraph``'s replay accounting, on a stub graph.

The CUDA graphs themselves are held to the eager loop on the card
(``tests/test_torch_cuda_kernels.py`` and ``chip_smoke.py``, phase 27).
"""

import contextlib
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one thread a test worker: the suite runs in parallel workers

import jax
import jax.numpy as jnp

from mpgan_tpu.ops import linear as jlinear
from mpgan_tpu.ops import mp_pallas as jmpp
from mpgan_tpu.training import losses as jlosses
from mpgan_tpu_torch.data import jetnet as tjetnet
from mpgan_tpu_torch.data.loader import BatchLoader
from mpgan_tpu_torch.models import registry as tregistry
from mpgan_tpu_torch.ops import knn_kernels as tkk
from mpgan_tpu_torch.ops import linear as tlinear
from mpgan_tpu_torch.ops import mp_kernels as tmk
from mpgan_tpu_torch.ops import prng
from mpgan_tpu_torch.ops.keys import Keys, KeySlots
from mpgan_tpu_torch.training import checkpoint as tckpt
from mpgan_tpu_torch.training import config as tconfig
from mpgan_tpu_torch.training import sampling as tsampling
from mpgan_tpu_torch.training import train_step as tts
from mpgan_tpu_torch.training.loop import Trainer
from mpgan_tpu_torch.training.optimizers import build_optimizer
from mpgan_tpu_torch.utils.weights import jax_leaves

from test_torch_ops import port_keys  # the port's keys of a JAX key
from test_torch_train_step import FWD_TOL, NARROW, _batch, _compare_update, _step_pair

SEED = 123457
KNN = dict(NARROW, fully_connected=False, num_knn=4)
GAPT = {"model": "gapt", "num_hits": 8, "gapt_embed_dim": 16, "num_heads": 2,
        "sab_layers_gen": 2, "sab_layers_disc": 1}
LEGACY = dict(NARROW, model="old_mpgan", model_D="old_mpgan", lr_disc=3e-5, lr_gen=1e-5)


def _served(kind, keys):
    """A ``kind`` request of a root key (a :class:`Keys`), recorded, then drawn by
    the slots' plan rows into their buffer and served from it: the form a
    replayed step reads."""
    slots = KeySlots()
    with slots.recording({"r": keys}):
        getattr(slots.root("r"), kind)()
    slots.buffer = prng.Plan(slots.rows({"r": keys.path})).run(keys.root)
    with slots.serving():
        return getattr(slots.root("r"), kind)()


KEY = Keys(prng.PRNGKey(SEED))
EDGE_SEED = int(KEY.edge_seed())


def _dense(b=3, n=13, widths=(8, 12, 6), seed=0):
    rng = np.random.RandomState(seed)
    f = lambda *s, scale=1.0: torch.from_numpy((rng.randn(*s) * scale).astype(np.float32))  # noqa: E731
    hidden = []
    for a, c in zip(widths[:-1], widths[1:]):
        hidden += [f(a, c, scale=a ** -0.5), f(c, scale=0.1)]
    mask = torch.from_numpy((rng.rand(b, n, 1) > 0.3).astype(np.float32))
    return f(b, n, widths[0], scale=0.5), f(b, n, widths[0], scale=0.5), mask, tuple(hidden), \
        f(b, n, widths[-1])


# ---------------------------------------------------------------------------
# (a) seeds from slots
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("salt", [0, 3])
def test_dropmul_with_a_slot_seed_is_pallas_dropmul(salt):
    seed = _served("edge_seed", KEY)
    assert seed.dtype == torch.int32 and seed.shape == (1,) and seed.item() == EDGE_SEED
    ids = tmk.pair_ids(2, 13, "cpu").reshape(-1, 1)
    t = tmk._dropmul(ids, 20, 0.5, seed, salt)
    np.testing.assert_array_equal(t.numpy(), tmk._dropmul(ids, 20, 0.5, EDGE_SEED, salt).numpy())
    j = jmpp._dropmul((ids.shape[0], 20), 0.5, jnp.asarray(EDGE_SEED, jnp.int32), salt, None,
                      ids=jnp.asarray(ids.numpy().astype(np.uint32)))
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("p", [0.5, 0.1])
def test_hash_dropout_with_a_slot_is_jax_hash_dropout(p):
    x = np.random.RandomState(1).randn(3, 13, 17).astype(np.float32)
    key = jax.random.PRNGKey(7)
    slot = _served("words", port_keys(key))
    kd = np.asarray(key)
    assert slot.item() == tlinear.hash_seed((int(kd[0]), int(kd[1])))
    t = tlinear.hash_dropout(torch.from_numpy(x), p, slot).numpy()
    np.testing.assert_array_equal(t, np.asarray(jlinear.hash_dropout(jnp.asarray(x), p, key)))


@pytest.mark.parametrize("sum_agg", [True, False])
def test_dense_kernels_plain_versions_take_a_slot_seed(sum_agg):
    u1, u2, mask, hidden, g = _dense()
    seed = _served("edge_seed", KEY)
    a = tmk.edge_aggregate(u1, u2, mask, hidden, 0.2, sum_agg, 0.5, EDGE_SEED)
    b = tmk.edge_aggregate(u1, u2, mask, hidden, 0.2, sum_agg, 0.5, seed)
    assert torch.equal(a, b) and not torch.equal(a, tmk.edge_aggregate(
        u1, u2, mask, hidden, 0.2, sum_agg, 0.5, EDGE_SEED + 1))
    for need in (True, False):
        ga = tmk.edge_aggregate_bwd(u1, u2, mask, hidden, g, 0.2, sum_agg, 0.5, EDGE_SEED, need)
        gb = tmk.edge_aggregate_bwd(u1, u2, mask, hidden, g, 0.2, sum_agg, 0.5, seed, need)
        for x, y in zip([*ga[:3], *ga[3]], [*gb[:3], *gb[3]]):
            assert torch.equal(x, y)


@pytest.mark.parametrize("want_dists", [False, True])
def test_knn_kernels_plain_versions_take_a_slot_seed(want_dists):
    b, n, k, c = 2, 13, 4, 3
    rng = np.random.RandomState(2)
    f = lambda *s: torch.from_numpy((rng.randn(*s) * 0.5).astype(np.float32))  # noqa: E731
    xs = f(b, n, c)
    u1, u2, mask, hidden, g = _dense(b, n)
    u2m = torch.cat([u2, mask], dim=-1)
    w_d = f(u1.shape[-1])
    seed = _served("edge_seed", KEY)
    common = (xs, xs, u1, u2m, w_d, hidden, k, True, want_dists, 0.2, True, 0.5)
    a = tkk.knn_fused_layer(*common, EDGE_SEED, True)
    s = tkk.knn_fused_layer(*common, seed, True)
    assert all(torch.equal(x, y) for x, y in zip(a, s) if x is not None)
    idx, dists = a[1], a[2]
    k8 = [tkk.knn_edge_aggregate(u1, u2m, idx, dists, w_d, hidden, 0.2, True, 0.5, sd)
          for sd in (EDGE_SEED, seed)]
    assert torch.equal(*k8) and torch.equal(k8[0], a[0])
    k6 = [tkk.knn_edge_aggregate_bwd(u1, u2m, idx, dists, w_d, hidden, g, 0.2, True, 0.5, sd)
          for sd in (EDGE_SEED, seed)]
    flat = lambda r: [t for t in (*r[:5], *r[5]) if t is not None]  # noqa: E731
    assert all(torch.equal(x, y) for x, y in zip(flat(k6[0]), flat(k6[1])))


def test_seed_tensors_are_checked_and_ints_range_checked():
    u1, u2, mask, hidden, _ = _dense()
    with pytest.raises(TypeError, match="int32"):
        tmk.edge_aggregate(u1, u2, mask, hidden, 0.2, True, 0.5, torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="outside"):
        tmk.edge_aggregate(u1, u2, mask, hidden, 0.2, True, 0.5, -1)


# ---------------------------------------------------------------------------
# the slots' protocol
# ---------------------------------------------------------------------------


def test_key_slots_serve_only_the_recorded_requests():
    slots = KeySlots()
    root = slots.root("r")
    with pytest.raises(RuntimeError, match="outside"):
        root.words()
    with slots.recording({"r": Keys(KEY.root, (4,))}):
        root.split(2)[1].words()
        root.edge_seed()
    assert slots.log == [("words", "r", (1,)), ("edge_seed", "r", ())]
    with pytest.raises(RuntimeError, match="no buffer"):
        with slots.serving():
            pass
    rows = slots.rows({"r": (4,)})
    assert [(r.dist, r.path) for r in rows] == [("words", (4, 1)), ("edge_seed", (4,))]
    slots.buffer = prng.Plan(rows).run(KEY.root)
    assert slots.buffer.tolist() == [int(Keys(KEY.root, (4, 1)).words()),
                                     int(Keys(KEY.root, (4,)).edge_seed())]
    with pytest.raises(RuntimeError, match="not the recorded"):
        with slots.serving():
            root.edge_seed()
    with pytest.raises(RuntimeError, match="made 1 key requests"):
        with slots.serving():
            root.split(2)[1].words()


# ---------------------------------------------------------------------------
# (b) the fill draws the eager step's keys; (c) the static step is the eager step
# ---------------------------------------------------------------------------


class LoggedKeys:
    """A step's keys object that logs what it draws, as the slots hold it."""

    def __init__(self, keys, out):
        self.keys, self.out = keys, out

    def split(self, num):
        return [LoggedKeys(k, self.out) for k in self.keys.split(num)]

    def words(self):
        w = self.keys.words()
        self.out.append(int(w))
        return w

    def edge_seed(self):
        s = self.keys.edge_seed()
        self.out.append(int(s))
        return s


def _card_args(card, **kw):
    args = tconfig.from_args_dict(dict(card, **kw))
    if card.get("model") == "old_mpgan":  # the shipped legacy cards' masks, after processing
        args.mask = args.mask_c = True
    return args


def _state(args, seed=0):
    suite = tregistry.build_suite(args)
    kg, kd = prng.split(prng.PRNGKey(seed))
    g, d = suite.generator(kg), suite.discriminator(kd)
    opt = lambda m, lr: build_optimizer(args.optimizer, m.parameters(), lr,  # noqa: E731
                                        beta1=args.beta1, beta2=args.beta2)
    return suite, tts.TrainState(g, d, opt(g, args.lr_gen), opt(d, args.lr_disc),
                                 prng.PRNGKey(seed))


def _data(args, n_jets, seed=0):
    ds = tjetnet.JetNetDataset("g", num_particles=args.num_hits, synthetic_num_jets=n_jets + 50,
                               seed=seed)
    return torch.from_numpy(ds.particle_data[:n_jets]), torch.from_numpy(ds.jet_data[:n_jets])


def _tensors(state):
    out = []
    for m, opt in ((state.g, state.g_opt), (state.d, state.d_opt)):
        params = jax_leaves(m, True)
        out += params + jax_leaves(m, False)
        for p in params:
            out += [v for _, v in sorted(opt.state[p].items())]
    return out


def _assert_same_state(a, b):
    ta, tb = _tensors(a), _tensors(b)
    assert len(ta) == len(tb)
    for x, y in zip(ta, tb):
        assert torch.equal(x, y)
    assert torch.equal(a.rng, b.rng)


def _eager(state, suite, cfg, kind, data, labels, epoch=0, keys_log=None):
    """The eager loop's step of ``kind`` on one batch; its loss parts."""
    out = {}
    if "d" in kind:
        draws = None
        if keys_log is not None:
            def draws(x):
                dd = tts.draw_d(state, cfg, suite.noise, x)
                return dataclasses.replace(dd, **{f: LoggedKeys(getattr(dd, f), keys_log)
                                                  for f in ("real", "fake", "gp")})
        out.update(tts.d_step(state, cfg, suite.noise, data, labels, draws=draws,
                              post_gen=suite.post_gen, encode_real=suite.encode_real,
                              epoch=epoch))
    if "g" in kind:
        draws = None
        if keys_log is not None:
            gd = tts.draw_g(state, cfg, suite.noise, data.shape[0], "cpu")
            draws = dataclasses.replace(gd, **{f: LoggedKeys(getattr(gd, f), keys_log)
                                               for f in ("g", "d")})
        out.update(tts.g_step(state, cfg, suite.noise, data, labels, draws=draws,
                              post_gen=suite.post_gen, epoch=epoch))
    return out


STEP_CASES = {
    "flagship": (NARROW, {}),
    "knn": (KNN, {}),
    "gapt": (GAPT, {}),
    "legacy": (dict(LEGACY, lfc=True), {}),
}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_fill_draws_the_eager_steps_keys_in_order(case):
    card, kw = STEP_CASES[case]
    args = _card_args(card, **kw)
    data, labels = _data(args, 8)
    cfg = tts.step_config(args)
    (suite, eager), (_, static) = _state(args), _state(args)
    order = torch.arange(8, dtype=torch.int32).repeat(2, 1)
    step = tts.StaticStep("dg", static, cfg, suite.noise, data, labels,
                          {k: torch.zeros(()) for k in ("Dr", "Df", "D", "G")},
                          order, torch.zeros(1, dtype=torch.int32), post_gen=suite.post_gen)
    for i in range(2):
        logged: list[int] = []
        _eager(eager, suite, cfg, "dg", data, labels, keys_log=logged)
        step()
        if i:  # the second call's plan fills the slots from the key
            filled = torch.cat([s.buffer for s in step.slots]).tolist()
            assert filled == logged and len(logged) > 0
        assert torch.equal(eager.rng, static.rng)


STATIC_CASES = {
    "dg": (NARROW, {}, "dg"),
    "dg_aug": (NARROW, {"aug_t": True, "aug_f": True, "aug_r90": True, "aug_s": True,
                        "label_smoothing": True}, "dg"),
    "wgan_gp_critic5": (NARROW, {"loss": "w", "gp": 10.0, "num_critic": 5,
                                 "optimizer": "adam"}, "d,g"),
    "knn_dg": (KNN, {}, "dg"),
    "gapt_dg": (GAPT, {"optimizer": "adadelta"}, "dg"),
    # bf16 applies (StepConfig.bf16), with spectral norm in D: its vectors pass
    # through bf16 and back into the float32 buffers every step
    "bf16_dg": (NARROW, {"compute_dtype": "bfloat16", "spectral_norm_disc": True}, "dg"),
}


@pytest.mark.parametrize("case", list(STATIC_CASES))
def test_static_step_uncaptured_is_the_eager_step_bit_for_bit(case):
    card, kw, kinds = STATIC_CASES[case]
    args = _card_args(card, **kw)
    b = 6
    data, labels = _data(args, 3 * b)
    cfg = tts.step_config(args)
    (suite, eager), (_, static) = _state(args), _state(args)
    keys = ["Dr", "Df", "D"] + (["gp"] if args.gp else []) + ["G"]
    sums_e = {k: torch.zeros(()) for k in keys}
    graphs = tts.StepGraphs(static, cfg, suite.noise, keys, "cpu", post_gen=suite.post_gen)
    order = np.random.RandomState(0).permutation(3 * b).reshape(3, b)
    steps = [(i, kind) for i in range(3) for kind in kinds.split(",")]
    for i, kind in steps:
        for k, v in _eager(eager, suite, cfg, kind, data[order[i]], labels[order[i]]).items():
            sums_e[k] += v
    graphs.epoch(steps, data, labels, order)
    assert graphs.replays == 0 and all(s.calls == 3 for s in graphs.steps.values())
    assert int(graphs.counter) == len(steps)
    for k in keys:
        assert torch.equal(sums_e[k], graphs.sums[k]), k
    _assert_same_state(eager, static)


def test_step_graphs_record_again_for_new_data_or_phase():
    args = _card_args(NARROW)
    data, labels = _data(args, 12)
    suite, state = _state(args)
    graphs = tts.StepGraphs(state, tts.step_config(args), suite.noise, ["Dr", "Df", "D", "G"],
                            "cpu")
    order = np.arange(12).reshape(2, 6)
    graphs.epoch(tts.step_kinds(2), data, labels, order)
    first = graphs.steps["dg"]
    assert first.calls == 2
    graphs.epoch(tts.step_kinds(2), data, labels, order)  # the same: kept
    assert graphs.steps["dg"] is first and first.calls == 4
    graphs.epoch(tts.step_kinds(2), data, labels, order, epoch=1)  # another model phase
    assert graphs.steps["dg"] is not first and graphs.steps["dg"].calls == 2
    again = data.clone()  # another staged dataset
    graphs.epoch(tts.step_kinds(2), again, labels, order, epoch=1)
    assert graphs.steps["dg"].data_all is again
    # a load replaces the optimizer state the steps read: they go
    tckpt.load_train_state_leaves(state, tckpt.train_state_leaves(state))
    assert not graphs.steps


# ---------------------------------------------------------------------------
# (d) from JAX's key, the static step's D and G updates are the JAX package's
# ---------------------------------------------------------------------------


def test_static_d_and_g_steps_with_jax_draws_match_jax():
    """Static D steps, then static G steps, from the JAX state's key with no
    draws passed: each draws what the JAX step draws, and ends on its key."""
    from mpgan_tpu.models.mpgan import mp_discriminator_apply, mp_generator_apply

    # the plain paths (the JAX kernel path runs in interpret mode, and the seed slots'
    # kernel path is held to the int seeds' above)
    (gcfg, dcfg, spec, jstate, d_step, g_step), (tstate, tspec) = _step_pair(NARROW, False)
    tstate.rng.copy_(torch.from_numpy(np.asarray(jstate.rng).copy()))
    data, labels = _batch(NARROW, 4)
    jd, jl = jnp.asarray(data), jnp.asarray(labels)
    td, tl = torch.from_numpy(data), torch.from_numpy(labels)
    sums = {k: torch.zeros(()) for k in ("Dr", "Df", "D", "G")}
    order = torch.arange(4, dtype=torch.int32).repeat(2, 1)
    static_d = tts.StaticStep("d", tstate, tts.StepConfig(), tspec, td, tl, sums, order,
                              torch.zeros(1, dtype=torch.int32))
    static_g = tts.StaticStep("g", tstate, tts.StepConfig(), tspec, td, tl, sums, order,
                              torch.zeros(1, dtype=torch.int32))
    # two D steps (record, then the static body), then two G steps
    for call in range(2):
        _, k_noise, k_real, k_fake, *_ = jax.random.split(jstate.rng, 9)
        noise, _ = spec.sample(k_noise, 4)

        def d_loss_fn(d_params, st=jstate, noise=noise, k_real=k_real, k_fake=k_fake):
            fake, _ = mp_generator_apply(gcfg, st.g_params, st.g_state, noise, jl)
            r, s1 = mp_discriminator_apply(dcfg, d_params, st.d_state, jd, jl, train=True,
                                           rng=k_real)
            f, _ = mp_discriminator_apply(dcfg, d_params, s1, fake, jl, train=True, rng=k_fake)
            return jlosses.d_loss("ls", r, f)[0]

        jnext, jparts = d_step(jstate, jd, jl)
        for v in sums.values():
            v.zero_()
        static_d()
        for k in ("Dr", "Df", "D"):
            np.testing.assert_allclose(sums[k].numpy(), np.asarray(jparts[k]), **FWD_TOL)
        if call:  # the static body's update (the first, recorded, is d_step's own)
            _compare_update(jax_leaves(tstate.d, True), jstate.d_params, jnext.d_params,
                            jax.grad(d_loss_fn)(jstate.d_params), 1e-6)
        jstate = jnext
        np.testing.assert_array_equal(tstate.rng.numpy(), np.asarray(jstate.rng))
    for call in range(2):
        _, k_noise, k_g, k_d, _ = jax.random.split(jstate.rng, 5)
        noise, _ = spec.sample(k_noise, 4)

        def g_loss_fn(g_params, st=jstate, noise=noise, k_g=k_g, k_d=k_d):
            fake, _ = mp_generator_apply(gcfg, g_params, st.g_state, noise, jl, train=True,
                                         rng=k_g)
            out, _ = mp_discriminator_apply(dcfg, st.d_params, st.d_state, fake, jl,
                                            train=True, rng=k_d)
            return jlosses.g_loss("ls", out)

        jnext, jmetrics = g_step(jstate, jd, jl)
        sums["G"].zero_()
        static_g()
        np.testing.assert_allclose(sums["G"].numpy(), np.asarray(jmetrics["G"]), **FWD_TOL)
        if call:
            _compare_update(jax_leaves(tstate.g, True), jstate.g_params, jnext.g_params,
                            jax.grad(g_loss_fn)(jstate.g_params), 1e-6)
        jstate = jnext
        np.testing.assert_array_equal(tstate.rng.numpy(), np.asarray(jstate.rng))
    assert static_d.calls == static_g.calls == 2 and len(static_d.slots[0].log) > 0


# ---------------------------------------------------------------------------
# (e) the Trainer with epoch_scan on and off; the loop's gate
# ---------------------------------------------------------------------------


TRAINER_CASES = {
    "flagship": dict(NARROW, num_hits=8),
    "interleave": dict(NARROW, num_hits=8, num_critic=2, num_gen=1),
    # the legacy masks from model epoch 1: epoch 2 crosses, the steps record again
    "legacy_mask_epoch": dict(LEGACY, num_hits=8, lfc=True, mask_epoch=1),
}


def _trainer(tmp_path, card, name, scan):
    args = _card_args(dict(card, name=name, dir_path=str(tmp_path), batch_size=8,
                           num_samples=60, eval_tot_samples=32, w1_num_samples=[16],
                           epoch_scan=scan))
    kw = dict(num_particles=args.num_hits, synthetic_num_jets=args.num_samples, mask_feature=True)
    train = tjetnet.JetNetDataset("g", split="train", **kw)
    return Trainer(args, train, train, device="cpu"), train


@pytest.mark.parametrize("case", list(TRAINER_CASES))
def test_trainer_epoch_scan_on_and_off_train_alike(tmp_path, case):
    runs = []
    for scan in (True, False):
        t, train = _trainer(tmp_path, TRAINER_CASES[case], f"{case}{int(scan)}", scan)
        loader = BatchLoader(train.particle_data, train.jet_data if t.use_labels else None,
                             batch_size=8, shuffle=True, seed=t.args.seed)
        assert t.can_scan_epoch(loader) is scan
        for epoch in (1, 2):
            t.train_epoch(epoch, loader)
        t.eval_save_plot(2)
        runs.append(t)
    on, off = runs
    assert on.graphs.steps and not off.graphs.steps
    for k in on.d_loss_keys + ["G", "w1p", "w1m"]:
        assert on.losses[k] == off.losses[k], k
    _assert_same_state(on.state, off.state)
    if case == "legacy_mask_epoch":
        assert on._epoch_phase(0) == 0 and on._epoch_phase(1) == 1
        assert all(s.epoch == 1 for s in on.graphs.steps.values())


@pytest.mark.parametrize("flag", ["break_zero", "bottleneck", "debug_nans"])
def test_the_epoch_runs_eager_under_the_debugging_flags(tmp_path, flag):
    t, train = _trainer(tmp_path, dict(NARROW, num_hits=8, **{flag: True}), flag, True)
    loader = BatchLoader(train.particle_data, train.jet_data, batch_size=8, shuffle=True,
                         seed=t.args.seed)
    assert not t.can_scan_epoch(loader)
    t.train_epoch(1, loader)
    assert not t.graphs.steps


# ---------------------------------------------------------------------------
# (f) the static sampler
# ---------------------------------------------------------------------------


SAMPLER_CASES = {
    "flagship": (NARROW, {}),
    "gapt": (GAPT, {}),
    "legacy_epoch": (dict(LEGACY, lfc=True, mask_epoch=1), {"epoch": 1}),
    "point_noise": (NARROW, {}),
}


@pytest.mark.parametrize("case", list(SAMPLER_CASES))
def test_static_sampler_equals_the_eager_loop(case):
    card, g_kwargs = SAMPLER_CASES[case]
    args = _card_args(card)
    suite, state = _state(args)
    spec, post_fn = suite.noise, None
    if case == "point_noise":  # PCGAN's hook: point noise from each batch key's child 1
        spec = dataclasses.replace(spec, point_shape=(args.num_hits, 2))
        post_fn = lambda out, pts: out + pts.sum(-1, keepdim=True)  # noqa: E731
    _, labels = _data(args, 23)
    for seed in (1, 2):  # the second call runs on the kept sampler
        outs = [tsampling.generate_multi_batch(
            state.g, spec, prng.PRNGKey(seed), 23, 8, labels=labels.numpy(),
            post_fn=post_fn, static=static, **g_kwargs) for static in (True, False)]
        assert outs[0].shape[0] == 23
        np.testing.assert_array_equal(*outs)
    kept = tsampling._SAMPLERS[state.g]
    assert len(kept) == 1 and next(iter(kept.values())).runs == 6
    tsampling.drop_samplers(state.g)
    assert state.g not in tsampling._SAMPLERS


# ---------------------------------------------------------------------------
# (g) replay accounting
# ---------------------------------------------------------------------------


class StubGraph:
    """The two calls ``CountedGraph`` makes of a graph."""

    def __init__(self):
        self.replays = 0

    @contextlib.contextmanager
    def capture(self):
        yield

    def replay(self):
        self.replays += 1


def _launch(name, n):
    def body():
        tmk.launch_counts[name] += n
        return "out"
    return body


def test_replays_add_the_captured_launch_counts():
    tmk.reset_launch_counts()
    tmk.launch_counts["knn_search"] = 1
    graph = tmk.CountedGraph(_launch("edge_aggregate_train", 3), graph=StubGraph())
    # the capture ran nothing: its counts are taken back and kept
    assert graph.out == "out" and graph.launches == {"edge_aggregate_train": 3}
    assert tmk.launch_counts["edge_aggregate_train"] == 0 and tmk.launch_counts["knn_search"] == 1
    for _ in range(4):
        graph.replay()
    assert graph.graph.replays == 4 and tmk.launch_counts["edge_aggregate_train"] == 12
    tmk.reset_launch_counts()


def test_a_failed_capture_raises_and_leaves_the_counts():
    tmk.reset_launch_counts()

    def body():
        tmk.launch_counts["edge_aggregate"] += 2
        raise RuntimeError("operation not permitted when stream is capturing")

    with pytest.raises(RuntimeError, match="capturing"):
        tmk.CountedGraph(body, graph=StubGraph())
    assert tmk.launch_counts["edge_aggregate"] == 0


def test_optimizers_are_capturable_only_on_a_gpu():
    p = [torch.nn.Parameter(torch.zeros(3))]
    for name in ("rmsprop", "adam", "adadelta"):
        assert build_optimizer(name, p, 1e-3).defaults["capturable"] is False


def test_keys_words_and_slot_seed_agree():
    """A key's words drawn at once and through a slot: one seed, one mask, the
    hash of the key's two words."""
    keys = Keys(prng.PRNGKey(3), (2, 5))
    w = keys.words()
    slot = _served("words", keys)
    assert slot.item() == w.item() == tlinear.hash_seed(prng.key_words(keys.key()))
    x = torch.randn(4, 9)
    assert torch.equal(tlinear.hash_dropout(x, 0.5, w), tlinear.hash_dropout(x, 0.5, slot))


def test_a_kept_sampler_is_not_reused_once_the_weights_move():
    args = _card_args(NARROW)
    suite, state = _state(args)
    labels = _data(args, 8)[1].numpy()
    run = lambda: tsampling.generate_multi_batch(  # noqa: E731
        state.g, suite.noise, prng.PRNGKey(0), 8, 8, labels=labels)
    before = run()
    w = next(state.g.parameters())
    w.data = w.data.clone()  # same values, new storage (as .to() or an assigning load)
    np.testing.assert_array_equal(run(), before)
    assert len(tsampling._SAMPLERS[state.g]) == 2
