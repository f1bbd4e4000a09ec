"""Sparsified-MNIST GAN training entry point (``mpgan_tpu/cli/train_mnist.py``;
train_mnist.py:70-118).

    python -m mpgan_tpu_torch.cli.train_mnist --name mnist3 --mnist-num 3 \\
        --num-hits 75 --mnist-eval-resources <path to evaluation_resources>

The flags are ``cli.train``'s, with its ``--device`` pre-flag (default
``cuda``, an error without a GPU). Masking is forced off (train_mnist.py:75-77)
and the jets' default of 30 hits becomes 75; ``--num-hits`` picks the 75- or
100-brightest-pixel variant. Without ``mnist_train.csv``/``mnist_test.csv``
under ``--datasets-path`` the run trains on synthetic clouds drawn from a
seed; without ``--mnist-eval-resources`` it computes no FID. ``--mesh-shape M``
trains on ``M`` ranks, as ``cli.train`` does.
"""

from __future__ import annotations

import logging
import sys


def main(argv: list[str] | None = None):
    from ..utils.logging_utils import init_logging
    from .args import parse_cli
    from .train import launch_run, parse_device

    device, rest = parse_device(argv)
    args = parse_cli(rest)
    # the MNIST path forces masking off (train_mnist.py:75-77)
    args.mask = False
    args.mask_c = False
    args.gapt_mask = False
    args.dataset = "mnist"
    if args.num_hits == 30:  # the jets' default; MNIST uses 75 or 100 pixels
        args.num_hits = 75
    init_logging(args.log, args.log_file)
    return launch_run(run, args, device)


def run(args, device):
    """Train on the MNIST clouds from processed ``args``; returns the trainer."""
    from ..data.mnist import MNISTGraphDataset
    from ..training.mnist_loop import MNISTDatasetView, MNISTTrainer

    data_dir = args.datasets_path or None
    train_ds = MNISTDatasetView(
        MNISTGraphDataset(data_dir, args.num_hits, train=True, num=args.mnist_num))
    valid_ds = MNISTDatasetView(
        MNISTGraphDataset(data_dir, args.num_hits, train=False, num=args.mnist_num))
    logging.info(f"MNIST clouds: train {len(train_ds)}, valid {len(valid_ds)}")

    trainer = MNISTTrainer(args, train_dataset=train_ds, valid_dataset=valid_ds, device=device)
    trainer.train()
    return trainer


if __name__ == "__main__":
    main(sys.argv[1:])
