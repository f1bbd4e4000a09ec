"""Inference from a trained generator (reference gen.py:85-145;
``mpgan_tpu/cli/gen.py``): load a model card and a reference ``G_*.pt`` state
dict, sample jets on ``--device``, unnormalize with the per-jet-type feature
maxima (gen.py:10-17, 127-143), zero masked particles, clamp pT and save ``.npy``.

    python -m mpgan_tpu_torch.cli.gen --g-args card.txt --g-state G.pt \\
        --num-samples 50000 --output-file gen_jets.npy --device cuda
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..data.jetnet import JetNetDataset
from ..data.normalize import FPND_FEATURE_MAXES
from ..models.mpgan import MPGenerator
from ..training.config import build_mpgan_generator, from_args_txt
from ..training.sampling import generate_multi_batch, noise_spec
from ..utils.weights import load_reference_state_dict


def _device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {name}: no CUDA device is available")
    return device


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--g-args", type=str, required=True, help="model card (args.txt)")
    parser.add_argument("--g-state", type=str, required=True, help="reference G .pt state dict")
    parser.add_argument("--num-samples", type=int, default=50000)
    parser.add_argument("--batch-size", type=int, default=256)
    parser.add_argument("--output-file", type=str, default="./gen_jets.npy")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", type=str, default="cuda", help="torch device, e.g. cuda or cpu")
    ns = parser.parse_args(argv)

    device = _device(ns.device)
    args = from_args_txt(ns.g_args)
    if args.model != "mpgan":
        raise SystemExit(f"model {args.model!r} is not ported yet (ROADMAP.md Queue 1)")
    if ns.g_state.endswith(".npz"):
        raise SystemExit(
            f"{ns.g_state}: TrainState .npz checkpoints load once the optimizer and "
            "train state are ported (ROADMAP.md Queue 1 item 7); pass a reference G .pt"
        )

    g_cfg = build_mpgan_generator(args)
    g = MPGenerator(g_cfg, device=device).eval()
    g.load_state_dict(load_reference_state_dict(ns.g_state), strict=True)
    spec = noise_spec(
        "mpgan",
        {"lfc": args.lfc, "lfc_latent_size": args.lfc_latent_size,
         "mask_learn_sep": args.mask_learn_sep,
         "latent_node_size": args.latent_node_size or args.hidden_node_size},
        args.num_hits, args.sd,
    )

    labels = None
    if args.get("mask_c"):
        # conditioning multiplicities from real data if available, else synthetic
        # (gen.py:100-107)
        ds = JetNetDataset(
            args.jets, data_dir=args.datasets_path or None,
            num_particles=args.num_hits, split="valid",
        )
        rng = np.random.default_rng(ns.seed)
        labels = ds.jet_data[rng.choice(len(ds), size=ns.num_samples)]

    generator = torch.Generator(device=device).manual_seed(ns.seed)
    gen_jets = generate_multi_batch(
        g, spec, generator, ns.num_samples, ns.batch_size, labels=labels
    ).astype(np.float64)

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
