"""The PyTorch port's ``gen`` entry point on the CPU, and the package's import boundary."""

import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from mpgan_tpu.models.mpgan import mp_generator_apply
from mpgan_tpu.training import config as jconfig
from mpgan_tpu.utils.torch_import import load_torch_state_dict, mp_generator_from_torch
from mpgan_tpu_torch.cli import gen
from mpgan_tpu_torch.data.normalize import FPND_FEATURE_MAXES
from mpgan_tpu_torch.models.mpgan import MPGenerator
from mpgan_tpu_torch.training import config as tconfig
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
    g = MPGenerator(tconfig.build_mpgan_generator(args), torch.Generator().manual_seed(1))
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
    raw = generate_multi_batch(g, spec, torch.Generator().manual_seed(3), 10, 4, labels=labels)
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


def test_generate_is_one_batch_of_generate_multi_batch(tiny_card):
    _, _, g = tiny_card
    spec = noise_spec("mpgan", {"latent_node_size": 8}, 12)
    labels = (np.arange(1, 7) / 12)[:, None].astype(np.float32)
    one = generate(g.eval(), spec, torch.Generator().manual_seed(5), 6, torch.from_numpy(labels))
    multi = generate_multi_batch(g, spec, torch.Generator().manual_seed(5), 6, 6, labels=labels)
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


def test_gen_cli_refuses_npz_checkpoints(tiny_card, tmp_path):
    card, _, _ = tiny_card
    with pytest.raises(SystemExit, match="ROADMAP"):
        gen.main(["--g-args", str(card), "--g-state", str(tmp_path / "state.npz"),
                  "--device", "cpu"])


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
