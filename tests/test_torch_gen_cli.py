"""The PyTorch port's ``gen`` entry point on the CPU (from a reference ``.pt`` and from
either package's TrainState ``.npz``), and the package's import boundary."""

import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one thread a test worker: the suite runs in parallel workers

import jax
import jax.numpy as jnp

from mpgan_tpu.models import registry as jregistry
from mpgan_tpu.models.mpgan import mp_generator_apply
from mpgan_tpu.training import checkpoint as jckpt
from mpgan_tpu.training import config as jconfig
from mpgan_tpu.training import optimizers as jopt
from mpgan_tpu.training import train_step as jts
from mpgan_tpu.utils.torch_import import load_torch_state_dict, mp_generator_from_torch
from mpgan_tpu_torch.ops import prng
from mpgan_tpu_torch.cli import gen
from mpgan_tpu_torch.data.normalize import FPND_FEATURE_MAXES
from mpgan_tpu_torch.models.mpgan import MPGenerator
from mpgan_tpu_torch.models.registry import build_suite
from mpgan_tpu_torch.training import checkpoint as tckpt
from mpgan_tpu_torch.training import config as tconfig
from mpgan_tpu_torch.training.optimizers import build_optimizer
from mpgan_tpu_torch.training.train_step import TrainState
from mpgan_tpu_torch.training.sampling import generate, generate_multi_batch, noise_spec
from mpgan_tpu_torch.utils.weights import (
    load_reference_state_dict,
    mp_generator_to_reference_sd,
)

CARD = {"model": "mpgan", "jets": "g", "num_hits": 12, "hidden_node_size": 8,
        "fe": [12, 8], "fn": [16], "spectral_norm": True}


@pytest.fixture()
def tiny_card(tmp_path):
    args = tconfig.from_args_dict(CARD)
    card = tmp_path / "card.txt"
    card.write_text(repr(args.to_dict()))
    g = MPGenerator(tconfig.build_mpgan_generator(args), prng.PRNGKey(1))
    pt = tmp_path / "G.pt"
    torch.save(mp_generator_to_reference_sd(g), pt)
    return card, pt, g


def _run(card, pt, out, *extra):
    gen.main(["--g-args", str(card), "--g-state", str(pt), "--output-file", str(out),
              "--device", "cpu", "--num-samples", "10", "--batch-size", "4", *extra])
    return np.load(out)


def test_gen_cli_cpu_output_and_determinism(tiny_card, tmp_path):
    card, pt, g = tiny_card
    a = _run(card, pt, tmp_path / "a.npy", "--seed", "3")
    b = _run(card, pt, tmp_path / "b.npy", "--seed", "3")
    c = _run(card, pt, tmp_path / "c.npy", "--seed", "4")
    assert a.shape == (10, 12, 3) and np.isfinite(a).all()
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    assert (a[:, :, 2] >= 0).all()

    # the same draw through the sampler: masked particles are exactly zero,
    # real ones carry the unnormalized features
    args = tconfig.from_args_txt(str(card))
    from mpgan_tpu_torch.data.jetnet import JetNetDataset

    ds = JetNetDataset("g", num_particles=12, split="valid")
    labels = ds.jet_data[np.random.default_rng(3).choice(len(ds), size=10)]
    spec = noise_spec("mpgan", {"latent_node_size": 8}, 12, args.sd)
    raw = generate_multi_batch(g, spec, prng.PRNGKey(3), 10, 4, labels=labels)
    mask = raw[:, :, -1] >= 0
    assert 0 < mask.sum() < mask.size
    assert (a[~mask] == 0).all()
    maxes = FPND_FEATURE_MAXES["g"]
    expect = raw[:, :, :3].astype(np.float64) + np.array([0, 0, 0.5])
    expect *= np.array(maxes[:3])
    expect[:, :, 2] = np.maximum(expect[:, :, 2], 0)
    np.testing.assert_allclose(a[mask], expect[mask], rtol=1e-6, atol=1e-7)


def test_reference_pt_loads_equally_in_jax_and_port(tiny_card):
    card, pt, _ = tiny_card
    jcfg = jconfig.build_mpgan_generator(jconfig.from_args_dict(CARD))
    params, state = mp_generator_from_torch(load_torch_state_dict(str(pt)), jcfg)
    g = MPGenerator(tconfig.build_mpgan_generator(tconfig.from_args_dict(CARD)))
    g.load_state_dict(load_reference_state_dict(str(pt)), strict=True)

    rng = np.random.RandomState(0)
    noise = (rng.randn(5, 12, 8) * 0.2).astype(np.float32)
    labels = (rng.randint(1, 13, size=5) / 12)[:, None].astype(np.float32)
    yj, _ = mp_generator_apply(jcfg, params, state, jnp.asarray(noise), jnp.asarray(labels))
    with torch.inference_mode():
        yt = g(torch.from_numpy(noise), torch.from_numpy(labels)).numpy()
    np.testing.assert_allclose(yt, np.asarray(yj), rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(yt[..., -1], np.asarray(yj)[..., -1])


KNN_CARD = dict(CARD, fully_connected=False, num_knn=4, pos_diffs=True, deltar=True)


def test_knn_reference_pt_loads_equally_in_jax_and_port_and_runs_through_gen(tmp_path):
    """A knn generator (fe layer 1 one column wider for the distance feature):
    its reference ``.pt`` gives the same jets in both packages, and ``gen``
    samples from it."""
    args = tconfig.from_args_dict(KNN_CARD)
    tcfg = tconfig.build_mpgan_generator(args)
    g0 = MPGenerator(tcfg, prng.PRNGKey(2))
    assert g0.mp_layers[0].fe.net[0].module.weight_bar.shape[1] == 2 * 8 + 1
    pt = tmp_path / "G.pt"
    torch.save(mp_generator_to_reference_sd(g0), pt)
    jcfg = jconfig.build_mpgan_generator(jconfig.from_args_dict(KNN_CARD))
    params, state = mp_generator_from_torch(load_torch_state_dict(str(pt)), jcfg)
    g = MPGenerator(tcfg)
    g.load_state_dict(load_reference_state_dict(str(pt)), strict=True)

    rng = np.random.RandomState(0)
    noise = (rng.randn(5, 12, 8) * 0.2).astype(np.float32)
    labels = (rng.randint(6, 13, size=5) / 12)[:, None].astype(np.float32)
    yj, _ = mp_generator_apply(jcfg, params, state, jnp.asarray(noise), jnp.asarray(labels))
    with torch.inference_mode():
        yt = g(torch.from_numpy(noise), torch.from_numpy(labels)).numpy()
    np.testing.assert_allclose(yt, np.asarray(yj), rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(yt[..., -1], np.asarray(yj)[..., -1])

    card = tmp_path / "card.txt"
    card.write_text(repr(args.to_dict()))
    jets = _run(card, pt, tmp_path / "knn.npy")
    assert jets.shape == (10, 12, 3) and np.isfinite(jets).all()


def test_generate_is_one_batch_of_generate_multi_batch(tiny_card):
    """Batch 0 of ``generate_multi_batch(key)`` samples from ``split(key, nb)[0]``,
    as JAX's does: ``generate`` from that key."""
    _, _, g = tiny_card
    spec = noise_spec("mpgan", {"latent_node_size": 8}, 12)
    labels = (np.arange(1, 7) / 12)[:, None].astype(np.float32)
    one = generate(g.eval(), spec, prng.split(prng.PRNGKey(5), 1)[0], 6,
                   torch.from_numpy(labels))
    multi = generate_multi_batch(g, spec, prng.PRNGKey(5), 6, 6, labels=labels)
    assert not one.requires_grad and one.shape == (6, 12, 4)
    np.testing.assert_array_equal(one.numpy(), multi)
    np.testing.assert_array_equal(one[..., -1].numpy().sum(1) + 0.5 * 12, np.arange(1, 7))


def test_gen_cli_refuses_cuda_without_a_gpu(tiny_card, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    card, pt, _ = tiny_card
    with pytest.raises(SystemExit, match="no CUDA device"):
        gen.main(["--g-args", str(card), "--g-state", str(pt), "--device", "cuda",
                  "--output-file", str(tmp_path / "x.npy")])
    assert not (tmp_path / "x.npy").exists()


GAPT_CARD = {"model": "gapt", "num_hits": 9, "gapt_embed_dim": 8, "num_heads": 2,
             "sab_layers_gen": 2, "sab_layers_disc": 1, "sab_fc_layers": [12],
             "final_fc_layers_gen": [6], "final_fc_layers_disc": [6], "gapt_mask": True}


@pytest.mark.parametrize("card", [dict(CARD, batch_norm_gen=True), GAPT_CARD],
                         ids=["mpgan", "gapt"])
def test_jax_train_state_npz_loads_in_the_port(card, tmp_path):
    """A ``state_*.npz`` written by the JAX package's ``save_train_state`` gives
    the port's ``gen`` the JAX generator: equal outputs on the same noise."""
    jargs = jconfig.from_args_dict(card)
    jsuite = jregistry.build_suite(jargs)
    opt = jopt.build_optimizer(jargs.optimizer, 1e-4)
    jstate = jts.init_train_state(jax.random.PRNGKey(3), jsuite.g_init, jsuite.d_init,
                                  jsuite.g_cfg, jsuite.d_cfg, opt, opt)
    path = tmp_path / "state_best_epoch.npz"
    jckpt.save_train_state(path, jstate)

    args = tconfig.from_args_dict(card)
    g = gen._train_state_generator(args, build_suite(args), str(path), torch.device("cpu"))
    n, feat = args.num_hits, jsuite.noise.shape[-1]
    rng = np.random.RandomState(0)
    noise = (rng.randn(5, n, feat) * 0.2).astype(np.float32)
    labels = (rng.randint(n // 2, n + 1, size=5) / n)[:, None].astype(np.float32)
    yj, _ = jsuite.g_apply(jsuite.g_cfg, jstate.g_params, jstate.g_state, jnp.asarray(noise),
                           jnp.asarray(labels))
    with torch.inference_mode():
        yt = g.eval()(torch.from_numpy(noise), torch.from_numpy(labels)).numpy()
    np.testing.assert_allclose(yt, np.asarray(yj), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(yt[..., -1], np.asarray(yj)[..., -1])


def test_gen_cli_samples_from_a_port_written_npz(tiny_card, tmp_path):
    """``gen --g-state state_N.npz`` writes the jets that the same generator's
    ``.pt`` gives, bit for bit."""
    card, pt, g = tiny_card
    args = tconfig.from_args_txt(str(card))
    suite = build_suite(args)
    d = suite.discriminator(prng.PRNGKey(2))
    state = TrainState(g, d, build_optimizer(args.optimizer, g.parameters(), 1e-4),
                       build_optimizer(args.optimizer, d.parameters(), 1e-4),
                       prng.PRNGKey(0))
    npz = tmp_path / "state_7.npz"
    tckpt.save_train_state(npz, state)
    from_npz = _run(card, npz, tmp_path / "npz.npy", "--seed", "5")
    from_pt = _run(card, pt, tmp_path / "pt.npy", "--seed", "5")
    assert from_npz.shape == (10, 12, 3) and np.isfinite(from_npz).all()
    np.testing.assert_array_equal(from_npz, from_pt)


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import sys, pkgutil, importlib, mpgan_tpu_torch\n"
        "import mpgan_tpu_torch.cli.gen\n"
        "for m in pkgutil.walk_packages(mpgan_tpu_torch.__path__, 'mpgan_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith(('jax.', 'jaxlib'))\n"
        "             or k == 'mpgan_tpu' or k.startswith('mpgan_tpu.'))\n"
        "print(bad)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


def test_kernel_build_failures_raise(monkeypatch, tmp_path):
    from mpgan_tpu_torch.ops import _build

    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(_build, "find_nvcc", lambda: "false")  # a compiler that always fails
    with pytest.raises(RuntimeError, match="nvcc failed"):
        _build.build()
    assert not list(tmp_path.rglob("*.so"))
