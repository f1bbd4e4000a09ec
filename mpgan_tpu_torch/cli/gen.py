"""Inference from a trained generator (reference gen.py:85-145;
``mpgan_tpu/cli/gen.py``): load a model card and the generator's weights, from
a TrainState ``state_*.npz`` written by either package's training loop (any
model family) or, for MPGAN and GAPT, from a reference ``G_*.pt`` state dict;
sample jets on ``--device``, unnormalize with the per-jet-type feature maxima
(gen.py:10-17, 127-143), zero masked particles, clamp pT and save ``.npy``.
A PCGAN card's latents are decoded by the ``G_pc`` in the card's
``pcgan_weights_dir`` (the JAX ``gen`` does not decode them, and fails there).
The noise comes from the key ``PRNGKey(--seed)``, as the JAX ``gen`` draws it,
so the same weights and seed give the JAX package's jets. On a GPU every batch
after the first replays one captured CUDA graph of the batch's draw and G's
forward (``training/sampling.py``). ``--mesh-shape M`` generates on ``M``
ranks (``parallel/mesh.py``), each running G on its rows of every batch, with
the single-device output; rank 0 saves it.

    python -m mpgan_tpu_torch.cli.gen --g-args card.txt --g-state G.pt \\
        --num-samples 50000 --output-file gen_jets.npy --device cuda
    python -m mpgan_tpu_torch.cli.gen --g-args run/run_args.txt \\
        --g-state run/state_best_epoch.npz
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..data.jetnet import JetNetDataset
from ..data.normalize import FPND_FEATURE_MAXES
from ..models.registry import build_suite, pcgan_weight_path
from ..ops import prng
from ..parallel.mesh import Mesh, launch, make_mesh
from ..training import checkpoint as ckpt
from ..training.config import Args, from_args_txt
from ..training.optimizers import build_optimizer
from ..training.sampling import generate_multi_batch
from ..training.train_step import TrainState
from ..utils.weights import load_reference_state_dict


def _device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {name}: no CUDA device is available")
    return device


def _train_state_generator(args: Args, suite, path: str, device: torch.device):
    """G from a TrainState checkpoint: a template state of the card's models
    (drawn from the default key, ``PRNGKey(0)``, as the JAX ``gen`` builds its
    template) and optimizer takes the file's leaves (``training/checkpoint.py``)."""
    g, d = suite.generator(device=device), suite.discriminator(device=device)
    state = TrainState(g, d, build_optimizer(args.optimizer, g.parameters(), 1e-4),
                       build_optimizer(args.optimizer, d.parameters(), 1e-4),
                       prng.PRNGKey(0, device))
    ckpt.load_train_state(path, state)
    return state.g


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--g-args", type=str, required=True, help="model card (args.txt)")
    parser.add_argument("--g-state", type=str, required=True,
                        help="reference G .pt state dict or TrainState .npz checkpoint")
    parser.add_argument("--num-samples", type=int, default=50000)
    parser.add_argument("--batch-size", type=int, default=256)
    parser.add_argument("--output-file", type=str, default="./gen_jets.npy")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", type=str, default="cuda", help="torch device, e.g. cuda or cpu")
    parser.add_argument(
        "--mesh-shape", type=int, default=0,
        help="shard generation over this many devices (0 = single device); "
        "outputs equal the single device's (training/sampling.py)",
    )
    ns = parser.parse_args(argv)

    device = _device(ns.device)
    if not ns.mesh_shape:
        return generate(ns, device)
    if ns.batch_size % ns.mesh_shape:
        raise SystemExit(
            f"--batch-size {ns.batch_size} not divisible by --mesh-shape {ns.mesh_shape}")
    launch(_generate_rank, ns.mesh_shape, device.type, ns, device.type)


def _generate_rank(ns: argparse.Namespace, device_type: str) -> None:
    mesh = make_mesh(ns.mesh_shape, device_type=device_type)
    generate(ns, mesh.device, mesh)


def generate(ns: argparse.Namespace, device: torch.device, mesh: Mesh | None = None) -> None:
    """Generate, unnormalise and (on rank 0) save the jets ``ns`` asks for."""
    args = from_args_txt(ns.g_args)
    weights_dir = args.get("pcgan_weights_dir") or None
    suite = build_suite(args, pcgan_weights_dir=weights_dir)
    if suite.model == "pcgan" and suite.decode_eval is None:
        raise SystemExit(f"pcgan: {pcgan_weight_path(args, weights_dir, 'pc')} not found "
                         "(pcgan_weights_dir in the card)")
    if ns.g_state.endswith(".npz"):
        g = _train_state_generator(args, suite, ns.g_state, device)
    elif args.model not in ("mpgan", "gapt"):
        raise SystemExit(f"torch import not supported for model {args.model!r}")
    else:
        g = suite.generator(device=device)
        g.load_state_dict(load_reference_state_dict(ns.g_state), strict=True)
    g.eval()
    spec = suite.noise

    labels = None
    if args.get("mask_c") or args.get("gapt_mask"):
        # conditioning multiplicities from real data if available, else synthetic
        # (gen.py:100-107)
        ds = JetNetDataset(
            args.jets, data_dir=args.datasets_path or None,
            num_particles=args.num_hits, split="valid",
        )
        rng = np.random.default_rng(ns.seed)
        labels = ds.jet_data[rng.choice(len(ds), size=ns.num_samples)]

    gen_jets = generate_multi_batch(
        g, spec, prng.PRNGKey(ns.seed, device), ns.num_samples, ns.batch_size, labels=labels,
        mesh=mesh, post_fn=suite.decode_eval,
    ).astype(np.float64)
    if mesh is not None and not mesh.is_main:
        return

    # unnormalize (gen.py:127-133)
    maxes = FPND_FEATURE_MAXES.get(args.jets, FPND_FEATURE_MAXES["g"])
    shifts = [0.0, 0.0, -0.5]
    for i in range(3):
        gen_jets[:, :, i] -= shifts[i]
        gen_jets[:, :, i] *= maxes[i]

    if args.get("mask"):
        mask = gen_jets[:, :, -1] >= 0.5
        gen_jets[~mask] = 0
    gen_jets[:, :, 2] = np.maximum(gen_jets[:, :, 2], 0)

    np.save(ns.output_file, gen_jets[:, :, :3])
    print(f"saved {ns.num_samples} jets to {ns.output_file}")


if __name__ == "__main__":
    main(sys.argv[1:])
