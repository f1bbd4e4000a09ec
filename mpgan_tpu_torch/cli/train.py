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

``--epoch-scan`` (the default) trains each epoch on the static-buffer steps:
on a GPU one captured CUDA graph of the D+G step replayed a batch (separate D
and G graphs for ``--num-critic``/``--num-gen`` above 1), on the CPU the same
steps run uncaptured; ``--no-epoch-scan``, ``--break-zero``, ``--bottleneck``
and ``--debug-nans`` run the eager loop. Both give the same parameters and
losses from one seed (``training/loop.py``).

``--fpnd`` (30-particle g, t and q jets) scores with jetnet's ParticleNet
from ``<datasets_path>/pnet_state_dict.pt`` when that file is there, else with
the JAX package's random trunk (drawn from ``PRNGKey(42)``), with a warning:
such a score equals the JAX package's random-trunk FPND and is not comparable
to published values. ``--aug-*``,
``--profile``, ``--debug`` and ``--debug-nans`` run as in the JAX package
(``training/loop.py``). ``--compute-dtype bfloat16`` trains in bf16 on
float32 master weights (``training/train_step.py``), on every path, the knn
and GAPT kernels' included.

``--mesh-shape M`` trains data-parallel on ``M`` ranks (``parallel/mesh.py``):
rank ``r`` on ``cuda:r`` (NCCL), or on the CPU with ``--device cpu`` (gloo).
Run alone, the command spawns the ranks itself; under ``torchrun
--nproc-per-node M`` each process is one rank. Spawned ranks give :func:`main`
their losses, a list in rank order, where one process returns its trainer.

    python -m mpgan_tpu_torch.cli.train --name dp2 --mesh-shape 2
    torchrun --nproc-per-node 2 -m mpgan_tpu_torch.cli.train --name dp2 --mesh-shape 2
"""

from __future__ import annotations

import argparse
import logging
import pathlib
import pickle
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


def parse_device(argv: list[str] | None) -> tuple[torch.device, list[str]]:
    """The ``--device`` pre-flag (default ``cuda``, an error without a GPU) and
    the rest of ``argv``."""
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--device", default="cuda", help="torch device, e.g. cuda or cpu")
    ns, rest = pre.parse_known_args(argv)
    device = torch.device(ns.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {ns.device}: no CUDA device is available")
    return device, rest


def main(argv: list[str] | None = None):
    from ..utils.logging_utils import init_logging
    from .args import parse_cli

    device, rest = parse_device(argv)
    args = parse_cli(rest)
    init_logging(args.log, args.log_file)  # before the card reload, in the reference's order
    return launch_run(run, _reload_args_on_resume(args), device)


def launch_run(run_fn, args, device: torch.device):
    """``run_fn(args, device)`` in this process (its trainer), or with
    ``--mesh-shape`` above 1, outside a ``torchrun`` world, on every rank of
    the mesh in spawned processes (``parallel.mesh.launch``): the ranks'
    losses."""
    from ..parallel.mesh import in_world, launch
    from ..training.loop import check_supported, mesh_size

    m = mesh_size(args)
    if m <= 1 or in_world():
        return run_fn(args, device)
    check_supported(args)  # before any rank starts
    return launch(_rank_losses, m, device.type, run_fn, args, device.type)


def _rank_losses(run_fn, args, device_type: str) -> dict:
    """One rank's run; rank 0 logs as configured, the others their warnings."""
    from ..parallel.mesh import world_rank
    from ..utils.logging_utils import init_logging

    main_rank = world_rank() == 0
    init_logging(args.log if main_rank else "WARNING", args.log_file if main_rank else "")
    return run_fn(args, torch.device(device_type)).losses


def fpnd_hook(args, device: torch.device | str):
    """The trainer's FPND hook for ``--fpnd``, or None: the trunk of
    ``<datasets_path>/pnet_state_dict.pt`` when present, else the seeded random
    trunk. A weights file that fails to load is logged and leaves FPND out, as
    in the JAX package; nothing else is caught."""
    from ..evaluation.fpnd import make_fpnd_fn
    from ..utils.weights import load_particlenet

    if not args.get("fpnd"):
        return None
    path = pathlib.Path(args.datasets_path or ".") / "pnet_state_dict.pt"
    if not (args.datasets_path and path.exists()):
        logging.warning(
            "FPND: no pnet_state_dict.pt under --datasets-path, so a random ParticleNet trunk "
            "(PRNGKey(42), as the JAX package's) scores the jets: not comparable to published "
            "FPND values")
        return make_fpnd_fn(None, device)
    try:
        params = load_particlenet(str(path))
    except (OSError, EOFError, KeyError, ValueError, RuntimeError, pickle.UnpicklingError) as exc:
        logging.warning(f"FPND unavailable: {path} failed to load: {exc}")
        return None
    return make_fpnd_fn(params, device)


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
    trainer = Trainer(args, train_dataset=train_ds, valid_dataset=valid_ds, device=device,
                      fpnd_fn=fpnd_hook(args, device))
    trainer.train()
    return trainer


if __name__ == "__main__":
    main(sys.argv[1:])
