"""PyTorch/CUDA port of mpgan_tpu for NVIDIA Hopper (H100).

Mirrors the JAX package's layout (``ops/``, ``models/``, ``training/``,
``data/``, ``evaluation/``, ``utils/``, ``cli/``). Imports ``torch`` and never ``jax`` or
``mpgan_tpu``; the hand-written CUDA kernels live in ``csrc/`` and are built
at first use (``ops/_build.py``).
"""
