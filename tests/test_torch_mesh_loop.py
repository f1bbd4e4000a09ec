"""The entry points on a mesh (``--mesh-shape``), on the CPU with gloo:

- ``cli.train --mesh-shape 2 --device cpu`` spawns two ranks and trains 2
  epochs: one set of checkpoints and loss files, the same losses on both;
- ``cli.train`` on 2 ranks for a tiny dense, knn and GAPT card
  (``tests/test_loop.py:189-230``'s families): the static-buffer epoch equals
  ``--no-epoch-scan`` (``tests/test_loop.py:332-346``'s counterpart), a resume
  continues the run, and the ranks end with equal parameters and buffers;
- ``cli.train_mnist --mesh-shape 2`` trains and generates its evaluation on
  the mesh;
- ``cli.gen --mesh-shape 2`` writes what one device writes, and a batch that
  the mesh does not split is refused with the JAX package's message.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one thread a test worker: the suite runs in parallel workers

from mpgan_tpu_torch.cli import gen as tgen_cli
from mpgan_tpu_torch.cli import train as ttrain_cli
from mpgan_tpu_torch.parallel import mesh as tmesh

import torch_mesh_ranks
from test_torch_gapt_train import TINY as TINY_GAPT
from test_torch_train_loop import TINY

CARDS = {
    "dense": TINY,
    "knn": [*TINY, "--no-fully-connected", "--num-knn", "3"],
    "gapt": TINY_GAPT,
}


@pytest.fixture(autouse=True)
def one_thread(monkeypatch):
    """One thread a rank: the spawned ranks read it at their start."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def _argv(tmp, name, card, *extra):
    return ["--name", name, "--dir-path", str(tmp), *card, "--mesh-shape", "2",
            "--save-epochs", "2", *extra]


MNIST = ["--name", "m", "--num-hits", "20", "--hidden-node-size", "8", "--fe", "12", "--fn",
         "16", "--batch-size", "64", "--num-epochs", "1", "--save-epochs", "1",
         "--fid-eval-samples", "20", "--mesh-shape", "2"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One 2-rank world running, through the entry points' ``main`` (a rank of
    a world runs in-process): for each card an epoch on the static steps, a
    resume for a second (evaluated) and an epoch of ``--no-epoch-scan``;
    ``train_mnist``; ``gen`` from the dense run's ``state_2.npz``, and the same
    on one process. Returns ``(tmp, {task: (rank 0's result, rank 1's)})``."""
    tmp = tmp_path_factory.mktemp("mesh_runs")
    names, tasks = [], []
    for card, args in CARDS.items():
        scan = _argv(tmp, f"{card}_scan", args)
        names += [(card, "one"), (card, "two"), (card, "eager")]
        tasks += [("train", [*scan, "--num-epochs", "1"]),
                  ("train", [*scan, "--num-epochs", "2"]),
                  ("train", [*_argv(tmp, f"{card}_eager", args), "--num-epochs", "1",
                             "--no-epoch-scan"])]
    names.append("mnist")
    tasks.append(("train_mnist", ["--dir-path", str(tmp), *MNIST]))
    gen = ["--g-args", str(tmp / "dense_scan" / "dense_scan_args.txt"), "--g-state",
           str(tmp / "dense_scan" / "models" / "state_2.npz"), "--num-samples", "50",
           "--batch-size", "16", "--seed", "2"]
    names.append("gen")
    tasks.append(("gen", [*gen, "--output-file", str(tmp / "two.npy"), "--mesh-shape", "2"]))
    outs = tmesh.launch(torch_mesh_ranks.run_tasks, 2, "cpu", 2, tasks)
    tgen_cli.main(["--device", "cpu", *gen, "--output-file", str(tmp / "one.npy")])
    return tmp, {name: (outs[0][i], outs[1][i]) for i, name in enumerate(names)}


def test_train_cli_on_two_ranks_trains_and_writes_one_run(tmp_path):
    """``cli.train.main`` spawns the ranks itself and returns their losses."""
    out = ttrain_cli.main(["--device", "cpu", *_argv(tmp_path, "dp", TINY), "--num-epochs", "1",
                           "--save-epochs", "1"])
    assert len(out) == 2 and out[0] == out[1]
    assert len(out[0]["G"]) == 1 and len(out[0]["w1m"]) == 1
    assert np.isfinite(out[0]["G"]).all() and np.isfinite(out[0]["D"]).all()
    run = tmp_path / "dp"
    assert sorted(p.name for p in (run / "models").iterdir()) == ["state_1.npz"]
    assert (run / "dp_args.txt").exists() and (run / "losses" / "w1m.txt").exists()
    np.testing.assert_allclose(np.loadtxt(run / "losses" / "G.txt"), out[0]["G"], rtol=1e-6)


@pytest.mark.parametrize("card", list(CARDS))
def test_mesh_trainer_static_epoch_equals_eager_and_resumes(runs, card):
    tmp, out = runs
    for r in range(2):
        one, two, eager = (out[(card, k)][r] for k in ("one", "two", "eager"))
        assert one["steps"] == 1 and one["captures"] == 0  # the D+G body, uncaptured
        assert eager["steps"] == 0
        assert two["start_epoch"] == 1 and two["losses"]["G"][:1] == one["losses"]["G"]
        assert len(two["losses"]["G"]) == 2 and len(two["losses"]["w1m"]) == 1
        assert eager["losses"] == one["losses"]
        for a, c in zip(one["state"], eager["state"]):
            np.testing.assert_array_equal(a, c)  # the static epoch is the eager one
    for k in ("one", "two", "eager"):
        r0, r1 = out[(card, k)]
        assert r0["losses"] == r1["losses"]
        for a, b in zip(r0["state"], r1["state"]):
            np.testing.assert_array_equal(a, b)  # the ranks agree
    run = tmp / f"{card}_scan"
    assert sorted(p.name for p in (run / "models").iterdir()) == ["state_1.npz", "state_2.npz"]
    np.testing.assert_allclose(np.loadtxt(run / "losses" / "G.txt"),
                               out[(card, "two")][0]["losses"]["G"], rtol=1e-6)


def test_train_mnist_cli_on_two_ranks(runs):
    tmp, out = runs
    r0, r1 = out["mnist"]
    assert r0 == r1 and np.isfinite(r0["losses"]["G"]).all()
    assert (tmp / "m" / "models" / "state_1.npz").exists()
    assert (tmp / "m" / "figs" / "1_clouds.pdf").exists()


def test_gen_cli_on_two_ranks_writes_the_single_device_jets(runs):
    tmp, _ = runs
    one, two = np.load(tmp / "one.npy"), np.load(tmp / "two.npy")
    assert two.shape == one.shape == (50, 8, 3)
    np.testing.assert_allclose(two, one, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(two == 0, one == 0)  # the masked particles


def test_gen_cli_refuses_a_batch_the_mesh_does_not_split(tmp_path):
    with pytest.raises(SystemExit, match="--batch-size 16 not divisible by --mesh-shape 3"):
        tgen_cli.main(["--g-args", "card.txt", "--g-state", "G.pt", "--device", "cpu",
                       "--batch-size", "16", "--mesh-shape", "3"])
