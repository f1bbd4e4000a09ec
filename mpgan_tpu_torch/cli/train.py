"""Jet GAN training entry point (``mpgan_tpu/cli/train.py``; train.py:27-97).

    python -m mpgan_tpu_torch.cli.train --name run1 --model mpgan --jets g
    python -m mpgan_tpu_torch.cli.train --name gapt1 --model gapt --jets g
    python -m mpgan_tpu_torch.cli.train --name fcpnet1 --model rgan --model-D pointnet
    python -m mpgan_tpu_torch.cli.train --name pcgan1 --model pcgan \
        --pcgan-weights-dir <dir with pcgan_G_inv_g.pt and pcgan_G_pc_g.pt>

The flags are the reference's (``cli/args.py``); ``--device`` (default
``cuda``, an error without a GPU) picks the torch device and is not part of
the args card. Without JetNet HDF5 files under ``--datasets-path`` the run
trains on synthetic jets (``data/jetnet.py``), ``--num-samples`` of them.
Any generator/discriminator pair of the registry trains; the external
families' presets (``training/config.py``) set the optimizer, the loss, the
batch and, with an rGAN discriminator, the epoch count, over the command line,
as the reference's do. :func:`run` trains from processed args, for a caller
that changes them after the processing.
"""

from __future__ import annotations

import argparse
import logging
import pathlib
import sys

import torch


def _reload_args_on_resume(args):
    """When resuming a run, its saved args card is authoritative
    (setup_training.py:1164-1177), except ``num_epochs``, ``dir_path``,
    ``datasets_path``, ``load_model`` and ``name``; ``--override-args`` keeps
    the command line's."""
    from ..training import checkpoint as ckpt
    from ..training.config import from_args_dict, from_args_txt

    if not args.get("load_model", True) or args.get("override_args"):
        return args
    out_dir = pathlib.Path(args.dir_path or "outputs") / args.name
    card = out_dir / f"{args.name}_args.txt"
    if not card.exists() or ckpt.latest_epoch(out_dir / "models") == 0:
        return args
    loaded = from_args_txt(str(card)).to_dict()
    loaded.update(num_epochs=args.num_epochs, dir_path=args.dir_path,
                  datasets_path=args.datasets_path, load_model=True, name=args.name)
    logging.info(f"resuming: reloaded args from {card}")
    return from_args_dict(loaded, apply_processing=False)


def main(argv: list[str] | None = None):
    from .args import parse_cli

    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--device", default="cuda", help="torch device, e.g. cuda or cpu")
    ns, rest = pre.parse_known_args(argv)
    device = torch.device(ns.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {ns.device}: no CUDA device is available")

    args = parse_cli(rest)
    level = getattr(logging, str(args.log).upper(), logging.INFO)
    handler = logging.FileHandler(args.log_file) if args.log_file not in ("", "stdout") \
        else logging.StreamHandler(sys.stdout)
    logging.basicConfig(handlers=[handler], level=level, force=True,
                        format="%(asctime)s %(message)s")
    return run(_reload_args_on_resume(args), device)


def run(args, device: torch.device | str = "cuda"):
    """Train from processed ``args`` (``cli.args.parse_cli``) on ``device``: the
    datasets (JetNet HDF5 files, else synthetic jets) and the ``Trainer``.
    Returns the trainer."""
    from ..data.jetnet import JetNetDataset
    from ..training.loop import Trainer

    data_kwargs = dict(
        jet_type=args.jets,
        data_dir=args.datasets_path or None,
        num_particles=args.num_hits,
        split_fraction=(args.ttsplit, 1 - args.ttsplit),
        mask_feature=args.get("mask", False),
        num_particles_label=bool(args.clabels or args.get("mask_c") or args.get("gapt_mask")),
        synthetic_num_jets=args.num_samples,
    )
    train_ds = JetNetDataset(**data_kwargs, split="train")
    valid_ds = JetNetDataset(**data_kwargs, split="valid")
    logging.info(f"data loaded: train {len(train_ds)}, valid {len(valid_ds)}")
    trainer = Trainer(args, train_dataset=train_ds, valid_dataset=valid_ds, device=device)
    trainer.train()
    return trainer


if __name__ == "__main__":
    main(sys.argv[1:])
