"""The PyTorch port's MNIST stack against the JAX package.

- synthetic clouds equal JAX's bit for bit from the same seed;
- ``build_graph``, ``normalized_cut_weights``, ``graclus``, ``max_pool``,
  ``gmm_conv`` and ``monet_activations`` equal JAX's within 1e-12 (float64,
  host) on random MoNet weights;
- ``get_fid`` on resources written here (a state dict in the
  ``C_sm_nh_75`` schema saved with ``torch.save``, and moment files) equals
  JAX's within 1e-9;
- one D step and one G step of the MNIST card (JAX's smoke size, N = 20,
  masking off as ``train_mnist`` forces it, dropout 0.5), plain and augmented,
  equal JAX's within 1e-4;
- an ``MNISTTrainer`` run at JAX's smoke size writes ``state_1.npz``, and FID
  and the best epoch with resources; ``cli.train_mnist`` on the CPU forces
  masking off and refuses ``--device cuda`` without a GPU.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one thread a test worker: the suite runs in parallel workers

from mpgan_tpu.data import mnist as jmnist
from mpgan_tpu.evaluation import mnist_fid as jfid
from mpgan_tpu_torch.cli import train_mnist as ttrain_mnist
from mpgan_tpu_torch.data import mnist as tmnist
from mpgan_tpu_torch.evaluation import mnist_fid as tfid
from mpgan_tpu_torch.training.config import from_args_dict
from mpgan_tpu_torch.training.mnist_loop import MNISTDatasetView, MNISTTrainer

from test_torch_augment import StepPair

HOST_TOL = dict(rtol=1e-12, atol=1e-12)
# the MoNet of the reference's classifier: GMMConv 1 -> 32 -> 64 -> 64, 25 kernels, fc 64 -> 128
WIDTHS, KERNELS = (1, 32, 64, 64), 25


def monet_state_dict(seed=0) -> dict:
    """Random MoNet weights in the ``C_sm_nh_*_state_dict.pt`` schema (old
    torch-geometric GMMConv: ``g [in, K*out]``)."""
    g = torch.Generator().manual_seed(seed)
    r = lambda *s, scale=1.0: torch.randn(*s, generator=g, dtype=torch.float64) * scale  # noqa
    sd = {}
    for i, (cin, cout) in enumerate(zip(WIDTHS[:-1], WIDTHS[1:]), 1):
        sd[f"conv{i}.g"] = r(cin, KERNELS * cout, scale=cin ** -0.5)
        sd[f"conv{i}.mu"] = torch.rand(KERNELS, 2, generator=g, dtype=torch.float64)
        sd[f"conv{i}.sigma"] = 0.1 + torch.rand(KERNELS, 2, generator=g, dtype=torch.float64)
        sd[f"conv{i}.root"] = r(cin, cout, scale=cin ** -0.5)
        sd[f"conv{i}.bias"] = r(cout, scale=0.1)
    sd["fc1.weight"], sd["fc1.bias"] = r(128, WIDTHS[-1], scale=0.125), r(128, scale=0.1)
    return sd


def write_resources(path, num_hits=75, num=3, seed=0):
    torch.save(monet_state_dict(seed), str(path / f"C_sm_nh_{num_hits}_state_dict.pt"))
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(300, 128))
    np.savetxt(path / f"{num}_sm_2_nh_{num_hits}_mu2.txt", a.mean(axis=0))
    np.savetxt(path / f"{num}_sm_2_nh_{num_hits}_sigma2.txt", np.cov(a, rowvar=False))
    return str(path)


@pytest.mark.parametrize("num_hits,num,train", [(75, 3, True), (100, -1, False), (20, 7, True)])
def test_synthetic_clouds_equal_jax_bit_for_bit(num_hits, num, train):
    t = tmnist.MNISTGraphDataset(None, num_hits, train=train, num=num, synthetic_num_samples=40)
    j = jmnist.MNISTGraphDataset(None, num_hits, train=train, num=num, synthetic_num_samples=40)
    assert t.X.shape == (40, num_hits, 3) and t.X.dtype == np.float32
    np.testing.assert_array_equal(t.X, j.X)


def test_csv_clouds_equal_jax(tmp_path):
    rng = np.random.default_rng(0)
    rows = np.concatenate([rng.integers(0, 10, (12, 1)), rng.integers(0, 256, (12, 784))], 1)
    np.savetxt(tmp_path / "mnist_test.csv", rows, delimiter=",", fmt="%d")
    for num in (-1, 4, [1, 2]):
        t = tmnist.MNISTGraphDataset(str(tmp_path), 75, train=False, num=num)
        j = jmnist.MNISTGraphDataset(str(tmp_path), 75, train=False, num=num)
        np.testing.assert_array_equal(t.X, j.X)


def _params(mod, sd):
    """``load_resources``'s params from a state dict, without a file."""
    params = {c: {k: sd[f"{c}.{k}"].numpy() for k in ("g", "mu", "sigma", "root", "bias")}
              for c in ("conv1", "conv2", "conv3")}
    params["fc1"] = {"w": sd["fc1.weight"].numpy(), "b": sd["fc1.bias"].numpy()}
    return params


def _cloud(seed=0, n=75):
    return np.asarray(tmnist.MNISTGraphDataset(None, n, num=seed, synthetic_num_samples=3).X[1],
                      np.float64)


def test_graph_pool_and_conv_equal_jax():
    cloud = _cloud()
    tx, tpos, te = tfid.build_graph(cloud)
    jx, jpos, je = jfid.build_graph(cloud)
    for a, b in ((tx, jx), (tpos, jpos)):
        np.testing.assert_allclose(a, b, **HOST_TOL)
    np.testing.assert_array_equal(te, je)
    assert len(te) > 0
    w = tfid.normalized_cut_weights(te, tpos, len(tx))
    np.testing.assert_allclose(w, jfid.normalized_cut_weights(je, jpos, len(jx)), **HOST_TOL)
    cluster = tfid.graclus(te, w, len(tx))
    np.testing.assert_array_equal(cluster, jfid.graclus(je, w, len(jx)))
    for a, b in zip(tfid.max_pool(cluster, tx, tpos, te), jfid.max_pool(cluster, jx, jpos, je)):
        np.testing.assert_allclose(a, b, **HOST_TOL)
    p = _params(tfid, monet_state_dict(1))["conv1"]
    pseudo = tfid._edge_attr(tpos, te)
    np.testing.assert_allclose(
        tfid.gmm_conv(tx, te, pseudo, p["g"], p["mu"], p["sigma"], p["root"], p["bias"]),
        jfid.gmm_conv(jx, je, pseudo, p["g"], p["mu"], p["sigma"], p["root"], p["bias"]),
        **HOST_TOL)


@pytest.mark.parametrize("n", [75, 100])
def test_monet_activations_equal_jax(n):
    params = _params(tfid, monet_state_dict(2))
    for seed in (0, 5):
        cloud = _cloud(seed, n)
        t = tfid.monet_activations(params, cloud)
        assert t.shape == (128,) and np.isfinite(t).all()
        np.testing.assert_allclose(t, jfid.monet_activations(params, cloud), **HOST_TOL)


def test_get_fid_equals_jax_on_written_resources(tmp_path):
    res = write_resources(tmp_path)
    clouds = tmnist.MNISTGraphDataset(None, 75, num=3, synthetic_num_samples=40).X
    t = tfid.get_fid(clouds, 75, 3, res, eval_size=40)
    j = jfid.get_fid(clouds, 75, 3, res, eval_size=40)
    assert np.isfinite(t) and t > 0
    assert t == pytest.approx(j, rel=1e-9, abs=1e-9)


# the JAX package's MNIST smoke card (tests/test_mnist.py:94-113)
MNIST_CARD = dict(model="mpgan", num_hits=20, hidden_node_size=8, fe=[12], fn=[16],
                  batch_size=16, mask_c=False)
MASK_OFF = {"mask": False, "mask_c": False, "gapt_mask": False}


@pytest.mark.parametrize("flags", [{}, dict(aug_t=True, aug_f=True, aug_r90=True, aug_s=True,
                                            aug_prob=0.5)], ids=["plain", "augmented"])
@pytest.mark.parametrize("use_pallas", [True, False])
def test_mnist_d_step_and_g_step_match_jax(use_pallas, flags):
    pair = StepPair(dict(MNIST_CARD, use_pallas=use_pallas, **flags), MASK_OFF)
    assert pair.targs.disc_dropout == 0.5 and not pair.targs.mask
    data = tmnist.MNISTGraphDataset(None, 20, num=3, synthetic_num_samples=8).X[:6]
    parts = pair.check(np.ascontiguousarray(data))
    assert set(parts) == {"Dr", "Df", "D"}


def _mnist_args(tmp_path, **kw):
    card = dict(MNIST_CARD, name="mnist_smoke", dataset="mnist", num_epochs=1, save_epochs=1,
                save_model_epochs=1, fid_eval_samples=20, dir_path=str(tmp_path),
                gen_dropout=0.0, disc_dropout=0.0, load_model=False, save_zero=False,
                mnist_eval_resources="")
    args = from_args_dict(dict(card, **kw))
    for k, v in MASK_OFF.items():
        setattr(args, k, v)
    return args


def test_mnist_trainer_smoke(tmp_path):
    view = MNISTDatasetView(tmnist.MNISTGraphDataset(None, 20, num=3, synthetic_num_samples=64))
    trainer = MNISTTrainer(_mnist_args(tmp_path), train_dataset=view, valid_dataset=view,
                           device="cpu")
    trainer.train()
    assert len(trainer.losses["G"]) == 1 and np.isfinite(trainer.losses["G"]).all()
    assert (tmp_path / "mnist_smoke" / "models" / "state_1.npz").exists()
    assert trainer.losses["fid"] == []


def test_mnist_trainer_fid_and_best_epoch(tmp_path):
    res = write_resources(tmp_path, num_hits=20)
    view = MNISTDatasetView(tmnist.MNISTGraphDataset(None, 20, num=3, synthetic_num_samples=64))
    trainer = MNISTTrainer(_mnist_args(tmp_path, num_epochs=2, mnist_eval_resources=res,
                                       mnist_num=3),
                           train_dataset=view, valid_dataset=view, device="cpu")
    trainer.best_epoch = [[0, np.inf]]  # keep every improvement, whatever the FID's scale
    trainer.train()
    assert len(trainer.losses["fid"]) == 2 and np.isfinite(trainer.losses["fid"]).all()
    assert (tmp_path / "mnist_smoke" / "state_best_epoch.npz").exists()
    assert (tmp_path / "mnist_smoke" / "figs" / "2_clouds.pdf").exists()
    assert (tmp_path / "mnist_smoke" / "losses" / "2_fid.pdf").exists()


def test_train_mnist_cli_forces_masking_off(tmp_path):
    t = ttrain_mnist.main(["--device", "cpu", "--name", "m", "--dir-path", str(tmp_path),
                           "--num-hits", "20", "--hidden-node-size", "8", "--fe", "12",
                           "--fn", "16", "--batch-size", "16", "--num-epochs", "1",
                           "--save-epochs", "1", "--fid-eval-samples", "20", "--aug-r90"])
    assert not t.args.mask and not t.args.mask_c and t.args.dataset == "mnist"
    assert not t.use_labels and t.step_cfg.augment.aug_r90
    assert (tmp_path / "m" / "models" / "state_1.npz").exists()


def test_train_mnist_cli_refuses_cuda_without_a_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit, match="no CUDA device"):
        ttrain_mnist.main(["--name", "x", "--dir-path", str(tmp_path)])
