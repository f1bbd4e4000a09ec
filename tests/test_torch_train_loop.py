"""The PyTorch port's training loop, checkpoints, data and CLI against the JAX package.

- a checkpoint written by JAX ``save_train_state`` loads in the port (and a
  JAX-written run resumes in the port's ``Trainer``), and the reverse;
- ``BatchLoader`` gives the same batches; the same argv gives the same Args;
- ``w1p``/``w1m`` and ``gen_jet_corrections`` agree with the JAX package;
- a tiny ``cli.train`` run on the CPU writes its run directory and resumes;
- ``--efp --fpd --cov-mmd`` write their metrics and the real-EFP cache, and
  the best epoch by FPD is kept and survives a resume;
- the refusals of what is not ported yet, and that ``--fpnd`` and ``--aug-t`` build.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one thread a test worker: the suite runs in parallel workers

import jax

from mpgan_tpu.cli import args as jargs_cli
from mpgan_tpu.data import jetnet as jjetnet
from mpgan_tpu.data.loader import BatchLoader as JBatchLoader
from mpgan_tpu.evaluation import efp as jefp
from mpgan_tpu.evaluation import w1 as jw1
from mpgan_tpu.models.mpgan import mp_discriminator_init, mp_generator_init
from mpgan_tpu.training import checkpoint as jckpt
from mpgan_tpu.training import config as jconfig
from mpgan_tpu.training import optimizers as jopt
from mpgan_tpu.training import train_step as jts
from mpgan_tpu_torch.ops import prng
from mpgan_tpu_torch.cli import args as targs_cli
from mpgan_tpu_torch.cli import train as ttrain_cli
from mpgan_tpu_torch.data import jetnet as tjetnet
from mpgan_tpu_torch.data.loader import BatchLoader as TBatchLoader
from mpgan_tpu_torch.evaluation import w1 as tw1
from mpgan_tpu_torch.evaluation.fpnd import make_fpnd_fn
from mpgan_tpu_torch.training import checkpoint as tckpt
from mpgan_tpu_torch.training import config as tconfig
from mpgan_tpu_torch.training import loop as tloop
from mpgan_tpu_torch.training.loop import Trainer
from mpgan_tpu_torch.utils.weights import jax_leaves

TINY = ["--model", "mpgan", "--jets", "g", "--num-hits", "8", "--hidden-node-size", "8",
        "--fe", "12", "16", "--fn", "16", "--batch-size", "16", "--eval-tot-samples", "64",
        "--w1-num-samples", "50", "--num-samples", "200", "--save-model-epochs", "1"]


def _jax_state(card, optimizer="rmsprop", seed=0):
    a = jconfig.from_args_dict(dict(card, optimizer=optimizer))
    gcfg, dcfg = jconfig.build_mpgan_generator(a), jconfig.build_mpgan_discriminator(a)
    g_opt = jopt.build_optimizer(optimizer, a.lr_gen, beta1=a.beta1, beta2=a.beta2)
    d_opt = jopt.build_optimizer(optimizer, a.lr_disc, beta1=a.beta1, beta2=a.beta2)
    return jts.init_train_state(jax.random.PRNGKey(seed), mp_generator_init,
                                mp_discriminator_init, gcfg, dcfg, g_opt, d_opt)


def _datasets(args):
    kw = dict(num_particles=args.num_hits, synthetic_num_jets=args.num_samples,
              mask_feature=True)
    return tjetnet.JetNetDataset("g", split="train", **kw), \
        tjetnet.JetNetDataset("g", split="valid", **kw)


def _trainer(tmp_path, card, **kw):
    args = tconfig.from_args_dict(dict(card, dir_path=str(tmp_path)))
    train, valid = _datasets(args)
    return Trainer(args, train, valid, device="cpu", **kw)


CARD = {"model": "mpgan", "name": "ck", "num_hits": 8, "hidden_node_size": 8, "fe": [12, 16],
        "fn": [16], "batch_size": 16, "num_samples": 200, "eval_tot_samples": 64,
        "w1_num_samples": [50], "spectral_norm_disc": True, "batch_norm_gen": True}


@pytest.mark.parametrize("optimizer", ["rmsprop", "adam", "adadelta"])
def test_jax_checkpoint_resumes_in_the_port_trainer(tmp_path, optimizer):
    """A JAX TrainState saved with ``save_train_state`` (SN state in D, BN in G,
    optimizer state) is what the port's Trainer resumes from."""
    card = dict(CARD, optimizer=optimizer)
    jstate = _jax_state(card, optimizer, seed=3)
    # non-trivial optimizer state: one update with random gradients
    leaves = jax.tree.leaves(jstate.d_opt_state)
    rng = np.random.RandomState(0)
    jstate = jstate._replace(d_opt_state=jax.tree.unflatten(
        jax.tree.structure(jstate.d_opt_state),
        [np.asarray(x) + (rng.rand(*np.shape(x)).astype(np.asarray(x).dtype)
                          if np.asarray(x).dtype == np.float32 else 1) for x in leaves]))
    models = tmp_path / "ck" / "models"
    models.mkdir(parents=True)
    jckpt.save_train_state(jckpt.checkpoint_path(models, 1), jstate)
    (tmp_path / "ck" / "ck_args.txt").write_text(
        str(tconfig.from_args_dict(dict(card, dir_path=str(tmp_path))).to_dict()))

    trainer = _trainer(tmp_path, dict(card, num_epochs=2, save_epochs=2))
    assert trainer.start_epoch == 1
    st = trainer.state
    want = jax.tree.leaves(jstate)
    got = tckpt.train_state_leaves(st)
    assert len(got) == len(want)
    for a, b in zip(got[:-1], want[:-1]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    sn = st.d.mp_layers[0].fe.net[0].module
    assert torch.allclose(sn.weight_u, torch.from_numpy(np.array(
        jstate.d_state["mp_layers"][0]["fe"]["sn_u"][0])))
    trainer.train()
    assert tckpt.latest_epoch(models) == 2
    assert np.isfinite(trainer.losses["D"]).all() and len(trainer.losses["G"]) == 1


@pytest.mark.parametrize("optimizer", ["rmsprop", "adam"])
def test_port_checkpoint_loads_in_jax(tmp_path, optimizer):
    card = dict(CARD, optimizer=optimizer, num_epochs=1, save_epochs=1)
    trainer = _trainer(tmp_path, card)
    trainer.train()
    path = tckpt.checkpoint_path(trainer.models_dir, 1)
    template = _jax_state(card, optimizer)
    loaded = jckpt.load_train_state(path, template)
    st = trainer.state
    ref = (jax_leaves(st.g, True) + jax_leaves(st.g, False)
           + jax_leaves(st.d, True) + jax_leaves(st.d, False))
    for a, b in zip(jax.tree.leaves(loaded), ref):
        np.testing.assert_array_equal(np.asarray(a), b.detach().numpy())
    if optimizer == "adam":
        assert int(loaded.d_opt_state.count) == len(trainer.train_dataset) // 16
    assert np.asarray(loaded.rng).dtype == np.uint32 and loaded.rng.shape == (2,)


def test_checkpoint_rng_continues_the_saved_stream(tmp_path):
    trainer = _trainer(tmp_path, dict(CARD, num_epochs=1))
    """The key's two words are saved as they are and loaded as the key: saving
    leaves the stream where it was, and a load returns to it."""
    key = trainer.state.rng.clone()
    tckpt.save_train_state(tmp_path / "a.npz", trainer.state)
    assert torch.equal(trainer.state.rng, key)
    trainer.state.rng.copy_(prng.PRNGKey(5))
    tckpt.load_train_state(tmp_path / "a.npz", trainer.state)
    assert torch.equal(trainer.state.rng, key)


def test_batch_loader_order_matches_jax():
    a = np.arange(103 * 2, dtype=np.float32).reshape(103, 2)
    lab = np.arange(103, dtype=np.float32)[:, None]
    jl = JBatchLoader(a, lab, batch_size=16, shuffle=True, seed=7)
    tl = TBatchLoader(a, lab, batch_size=16, shuffle=True, seed=7)
    assert len(jl) == len(tl) == 6
    for _ in range(2):
        for (ja, jb), (ta, tb) in zip(jl, tl):
            np.testing.assert_array_equal(ja, ta)
            np.testing.assert_array_equal(jb, tb)
    np.testing.assert_array_equal(jl.epoch_batch_indices(), tl.epoch_batch_indices())


@pytest.mark.parametrize("argv", [
    [],
    ["--name", "x", "--num-hits", "150", "--mean", "--fe", "128", "256", "--no-mask-c"],
    ["--loss", "w", "--gp", "10", "--optimizer", "adam", "--label-smoothing", "--jets", "t"],
])
def test_same_argv_gives_the_same_args(argv):
    assert targs_cli.parse_cli(argv).to_dict() == jargs_cli.parse_cli(argv).to_dict()


def test_argv_errors_exit_like_jax():
    with pytest.raises(SystemExit):
        targs_cli.parse_cli(["--int-diffs"])


def test_w1_metrics_and_corrections_match_jax():
    rng = np.random.RandomState(0)
    real = np.abs(rng.randn(300, 8, 4)).astype(np.float32)
    gen = np.abs(rng.randn(300, 8, 4) * 1.1).astype(np.float32)
    real[..., 3] = rng.rand(300, 8) > 0.3
    gen[..., 3] = rng.rand(300, 8)
    for kw in ({}, {"zero_mask_particles": False, "zero_neg_pt": False}):
        tj, tm = tjetnet.gen_jet_corrections(gen, **kw)
        jj, jm = jjetnet.gen_jet_corrections(gen, **kw)
        np.testing.assert_array_equal(tj, jj)
        np.testing.assert_array_equal(tm, jm)
    r, g = real[..., :3], tjetnet.gen_jet_corrections(gen)[0]
    for fn in ("w1p", "w1m"):
        t = getattr(tw1, fn)(r, g, num_eval_samples=100, num_batches=3)
        j = getattr(jw1, fn)(r, g, num_eval_samples=100, num_batches=3)
        for a, b in zip(t, j):
            np.testing.assert_allclose(a, b, rtol=1e-12)


def test_train_cli_tiny_run_writes_the_run_directory_and_resumes(tmp_path):
    argv = ["--device", "cpu", "--name", "tiny", "--dir-path", str(tmp_path), *TINY]
    t1 = ttrain_cli.main(argv + ["--num-epochs", "2", "--save-epochs", "2"])
    run = tmp_path / "tiny"
    assert (run / "tiny_args.txt").exists()
    assert sorted(p.name for p in (run / "models").iterdir()) == ["state_1.npz", "state_2.npz"]
    assert {p.name for p in (run / "losses").iterdir()} >= {"D.txt", "G.txt", "w1p.txt",
                                                             "w1m.txt"}
    assert len(t1.losses["G"]) == 2 and len(t1.losses["w1m"]) == 1
    t2 = ttrain_cli.main(argv + ["--num-epochs", "3", "--save-epochs", "2"])
    assert t2.start_epoch == 2 and len(t2.losses["G"]) == 3
    assert (run / "models" / "state_3.npz").exists()
    assert np.isfinite(t2.losses["G"]).all()
    # the resumed run started from the saved weights
    np.testing.assert_array_equal(t1.losses["G"], t2.losses["G"][:2])


def test_resume_before_the_first_evaluation_jax_raises_the_port_resumes(tmp_path):
    """A run stopped before its first evaluation epoch leaves ``losses/w1p.txt``
    empty. The JAX package reads that file back as ``[[]]`` and its next
    ``save_losses`` raises; the port reads an empty history and saves on."""
    losses = tmp_path / "losses"
    keys, eval_keys, multi = ["D", "G", "w1p", "w1m"], ["w1p", "w1m"], ["w1p", "w1m"]
    saved = {"D": [0.5], "G": [0.25], "w1p": [], "w1m": []}
    jckpt.save_losses(saved, losses)
    assert (losses / "w1p.txt").read_text() == ""
    with pytest.warns(UserWarning, match="no data"):
        jl = jckpt.load_losses(losses, keys, eval_keys, multi, 1, 2)
    assert jl["w1p"] == [[]]
    jl["w1p"].append([0.1, 0.01])
    with pytest.raises(ValueError):
        jckpt.save_losses(jl, losses)
    tckpt.save_losses(saved, losses)
    tl = tckpt.load_losses(losses, keys, eval_keys, multi, 1, 2)
    assert tl == saved
    tl["w1p"].append([0.1, 0.01])
    tckpt.save_losses(tl, losses)
    assert tckpt.load_losses(losses, keys, eval_keys, multi, 2, 2)["w1p"] == [[0.1, 0.01]]


def test_train_cli_resumes_a_run_that_stopped_before_its_first_evaluation(tmp_path):
    argv = ["--device", "cpu", "--name", "tiny", "--dir-path", str(tmp_path), *TINY,
            "--save-epochs", "2"]
    t1 = ttrain_cli.main(argv + ["--num-epochs", "1"])
    losses = tmp_path / "tiny" / "losses"
    assert t1.losses["w1p"] == [] and (losses / "w1p.txt").read_text() == ""
    t2 = ttrain_cli.main(argv + ["--num-epochs", "2"])
    assert t2.start_epoch == 1 and len(t2.losses["G"]) == 2
    assert len(t2.losses["w1p"]) == len(t2.losses["w1m"]) == 1
    assert np.loadtxt(losses / "w1p.txt").shape == (len(t2.losses["w1p"][0]),)
    assert (tmp_path / "tiny" / "models" / "state_2.npz").exists()
    np.testing.assert_array_equal(t1.losses["G"], t2.losses["G"][:1])


def test_train_cli_tiny_mask_manual_run_trains(tmp_path):
    """``--mask-manual --no-mask-c`` once failed at the first D call (G's 3
    features against D's masked input); the hook now appends the pT-cutoff mask
    in both steps and in the evaluation."""
    argv = ["--device", "cpu", "--name", "mm", "--dir-path", str(tmp_path), *TINY,
            "--mask-manual", "--no-mask-c", "--num-epochs", "1", "--save-epochs", "1"]
    t = ttrain_cli.main(argv)
    assert t.post_gen is not None and not t.args.mask_c
    assert (tmp_path / "mm" / "models" / "state_1.npz").exists()
    assert np.isfinite(t.losses["G"]).all() and np.isfinite(t.losses["D"]).all()
    assert len(t.losses["w1m"]) == 1 and np.isfinite(t.losses["w1m"]).all()


def test_train_cli_refuses_cuda_without_a_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit, match="no CUDA device"):
        ttrain_cli.main(["--name", "x", "--dir-path", str(tmp_path), *TINY])


@pytest.mark.parametrize("flags,match", [
    pytest.param(["--fpnd", "--num-hits", "30"], None, id="flags0-fpnd"),
    pytest.param(["--aug-t"], None, id="flags1-augment"),
    pytest.param(["--compute-dtype", "bfloat16", "--no-fully-connected", "--num-knn", "3"],
                 None, id="flags2-bf16"),
    pytest.param(["--mesh-shape", "1", "--num-epochs", "1", "--save-epochs", "1"], None,
                 id="flags3-mesh"),
    pytest.param(["--mesh-shape", "3"], "not divisible by --mesh-shape 3", id="flags4-mesh"),
])
def test_trainer_refuses_what_is_not_ported(tmp_path, flags, match):
    """``--fpnd``, ``--aug-t``, bf16 training of a knn layer and a device mesh
    (``match`` None), refused until they were ported, now build and are wired
    (bf16: tests/test_torch_bf16.py, tests/test_torch_bf16_knn.py; the mesh:
    tests/test_torch_mesh.py, tests/test_torch_mesh_loop.py): a mesh of one
    rank trains an epoch in this process. What is refused is a batch that the
    mesh does not split."""
    args = targs_cli.parse_cli(["--name", "r", "--dir-path", str(tmp_path), *TINY, *flags])
    train, valid = _datasets(args)
    if match is None:
        t = Trainer(args, train, valid, device="cpu", fpnd_fn=make_fpnd_fn(None, "cpu"))
        if args.fpnd:
            assert t.eval_keys == ["w1p", "w1m", "fpnd"]
        elif args.compute_dtype == "bfloat16":
            assert t.step_cfg.bf16 and not t.args.fully_connected
        elif args.mesh_shape:
            assert t.mesh.size == 1 and t.graphs.mesh is t.mesh and t.mesh.backend == "gloo"
            t.train()
            assert np.isfinite(t.losses["G"]).all() and len(t.losses["w1m"]) == 1
            assert (tmp_path / "r" / "models" / "state_1.npz").exists()
        else:
            assert t.step_cfg.augment.aug_t and not t.step_cfg.augment.aug_f
        return
    with pytest.raises(ValueError, match=match) as err:
        Trainer(args, train, valid, device="cpu")
    assert "--batch-size 16" in str(err.value)


def test_trainer_knn_layer_is_refused_at_the_first_step(tmp_path):
    """The default ``--num-knn 10`` on an 8-particle cloud: more neighbours
    than senders, refused by the layer (the knn layer itself is ported, see
    the knn run below)."""
    args = targs_cli.parse_cli(["--name", "k", "--dir-path", str(tmp_path), *TINY,
                                "--no-fully-connected", "--num-epochs", "1"])
    train, valid = _datasets(args)
    with pytest.raises(ValueError, match="knn"):
        Trainer(args, train, valid, device="cpu").train()


@pytest.mark.parametrize("extra", [[], ["--pos-diffs", "--deltar", "--no-self-loops"]])
def test_train_cli_tiny_knn_run_trains_and_resumes(tmp_path, extra):
    argv = ["--device", "cpu", "--name", "knn", "--dir-path", str(tmp_path), *TINY,
            "--no-fully-connected", "--num-knn", "3", *extra]
    t1 = ttrain_cli.main(argv + ["--num-epochs", "2", "--save-epochs", "2"])
    assert all(not c.fully_connected and c.num_knn == 3 for c in t1.state.d.cfg.layers)
    assert np.isfinite(t1.losses["G"]).all() and len(t1.losses["w1m"]) == 1
    t2 = ttrain_cli.main(argv + ["--num-epochs", "3", "--save-epochs", "2"])
    assert t2.start_epoch == 2 and len(t2.losses["G"]) == 3
    assert np.isfinite(t2.losses["G"]).all() and np.isfinite(t2.losses["D"]).all()
    np.testing.assert_array_equal(t1.losses["G"], t2.losses["G"][:2])


KNN_CARD = dict(CARD, fully_connected=False, num_knn=3, pos_diffs=True, deltar=True)


def test_knn_checkpoint_moves_between_the_packages(tmp_path):
    """A knn-20-style G and D (fe layer 1 one column wider under ``pos_diffs``):
    the port's checkpoint loads in JAX, and a JAX checkpoint resumes in the port."""
    trainer = _trainer(tmp_path, dict(KNN_CARD, num_epochs=1, save_epochs=1))
    assert trainer.state.d.mp_layers[1].fe.net[0].module.weight_bar.shape[1] == 2 * 8 + 1
    trainer.train()
    template = _jax_state(KNN_CARD)
    loaded = jckpt.load_train_state(tckpt.checkpoint_path(trainer.models_dir, 1), template)
    st = trainer.state
    ref = (jax_leaves(st.g, True) + jax_leaves(st.g, False)
           + jax_leaves(st.d, True) + jax_leaves(st.d, False))
    for a, b in zip(jax.tree.leaves(loaded), ref):
        np.testing.assert_array_equal(np.asarray(a), b.detach().numpy())

    jstate = _jax_state(dict(KNN_CARD, name="jk"), seed=5)
    models = tmp_path / "jk" / "models"
    models.mkdir(parents=True)
    jckpt.save_train_state(jckpt.checkpoint_path(models, 1), jstate)
    resumed = _trainer(tmp_path, dict(KNN_CARD, name="jk", num_epochs=2, save_epochs=2))
    assert resumed.start_epoch == 1
    for a, b in zip(tckpt.train_state_leaves(resumed.state)[:-1], jax.tree.leaves(jstate)[:-1]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    resumed.train()
    assert np.isfinite(resumed.losses["D"]).all() and len(resumed.losses["G"]) == 1


EVAL = ["--efp", "--fpd", "--cov-mmd", "--cov-mmd-num-samples", "16", "--cov-mmd-num-batches",
        "2"]


def test_train_cli_tiny_run_with_evaluation_writes_its_metrics(tmp_path):
    """``--efp --fpd --cov-mmd``: w1efp, FPD and coverage/MMD at each
    evaluation, and the real side's EFPs cached as JAX computes them."""
    argv = ["--device", "cpu", "--name", "ev", "--dir-path", str(tmp_path), *TINY, *EVAL,
            "--num-epochs", "2", "--save-epochs", "1"]
    t = ttrain_cli.main(argv)
    run = tmp_path / "ev"
    assert t.eval_keys == ["w1p", "w1m", "w1efp", "fpd", "cov_mmd"]
    assert {p.name for p in (run / "losses").iterdir()} >= {"w1efp.txt", "fpd.txt",
                                                             "cov_mmd.txt"}
    assert np.loadtxt(run / "losses" / "w1efp.txt").shape == (2, 10)
    for key in ("fpd", "cov_mmd"):
        vals = np.loadtxt(run / "losses" / f"{key}.txt")
        assert vals.shape == (2, 2) and np.isfinite(vals).all()
    assert 0 < t.losses["cov_mmd"][-1][0] <= 1
    cache = run / "real_efps_d4all_g.npy"
    ds = t.valid_dataset
    real, _ = tjetnet.gen_jet_corrections(
        ds.particle_normalisation(ds.particle_data[:64], inverse=True),
        ret_mask_separate=True, zero_mask_particles=False, zero_neg_pt=False)
    np.testing.assert_allclose(np.load(cache), jefp.efps(real, "d<=4-all", use_jax=False),
                               rtol=1e-10)
    # a resume reloads the metric histories, truncated to its epoch
    t2 = ttrain_cli.main(argv[:-4] + ["--num-epochs", "3", "--save-epochs", "1"])
    assert t2.start_epoch == 2 and len(t2.losses["fpd"]) == 3
    assert t2.losses["fpd"][:2] == t.losses["fpd"]


def test_nonfinite_fp32_efp_rows_are_recomputed_in_float64(tmp_path, monkeypatch):
    calls = []
    efps = tloop.efps

    def fp32_overflow(jets, select="d<=4", use_device=None, **kw):
        calls.append((len(jets), use_device))
        out = efps(jets, select=select, use_device=use_device, **kw)
        if len(calls) == 2:  # the generated side (the real side's cache comes first)
            out[3] = np.inf  # what an overflowing FP32 row reads
        return out

    monkeypatch.setattr(tloop, "efps", fp32_overflow)
    args = targs_cli.parse_cli(["--name", "nf", "--dir-path", str(tmp_path), *TINY, "--fpd"])
    train, valid = _datasets(args)
    t = Trainer(args, train, valid, device="cpu")
    t.eval_save_plot(1)
    n_eval = min(64, len(valid))
    assert calls == [(n_eval, None), (n_eval, None), (1, False)]
    assert np.isfinite(t.losses["fpd"][-1]).all()


BEST_FILES = ["best_epoch.txt", "best_epoch_gen_jets.npy", "best_epoch_gen_mask.npy",
              "best_epoch_losses.txt", "state_best_epoch.npz"]


def test_best_epoch_by_fpd_is_kept_and_survives_a_resume(tmp_path, monkeypatch):
    """A stand-in FPD below the reference's 10.0 sentinel writes the best
    epoch's five files; a worse one later leaves them; a resume restores the
    record, and ``state_best_epoch.npz`` is the best epoch's state."""
    scores = iter([(4.0, 0.5), (6.0, 0.5), (9.0, 0.5), (1.0, 0.25)])
    monkeypatch.setattr(tloop, "fpd", lambda *a, **kw: next(scores))
    argv = ["--device", "cpu", "--name", "be", "--dir-path", str(tmp_path), *TINY, "--fpd",
            "--save-epochs", "1"]
    t1 = ttrain_cli.main(argv + ["--num-epochs", "2"])
    run = tmp_path / "be"
    assert all((run / f).exists() for f in BEST_FILES)
    assert t1.best_epoch == [[0, 10.0], [1, 4.5]]
    np.testing.assert_array_equal(np.loadtxt(run / "best_epoch.txt"), [[0, 10.0], [1, 4.5]])
    # the epoch's own checkpoint, rng words included
    best = np.load(run / "state_best_epoch.npz")
    epoch1 = np.load(run / "models" / "state_1.npz")
    assert best.files == epoch1.files
    assert all(np.array_equal(best[k], epoch1[k]) for k in best.files)
    n_eval = min(64, len(t1.valid_dataset))
    assert np.load(run / "best_epoch_gen_jets.npy").shape == (n_eval, 8, 3)
    assert "'fpd': [4.0, 0.5]" in (run / "best_epoch_losses.txt").read_text()

    t2 = ttrain_cli.main(argv + ["--num-epochs", "4"])
    assert t2.start_epoch == 2
    assert t2.best_epoch == [[0, 10.0], [1, 4.5], [4, 1.25]]
    np.testing.assert_array_equal(np.loadtxt(run / "best_epoch.txt"), t2.best_epoch)
    # the run ends on the key its epoch-4 checkpoint holds
    words = np.load(run / "models" / "state_4.npz")[f"leaf_{len(best.files) - 1}"]
    np.testing.assert_array_equal(t2.state.rng.numpy(), words)
