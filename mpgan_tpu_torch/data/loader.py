"""Shuffled fixed-size numpy batches (``mpgan_tpu/data/loader.py``).

Training drops the trailing partial batch (the order is reshuffled every
epoch, so every sample is seen across epochs); evaluation iterators keep it.
With the same seed the order equals the JAX package's batch for batch.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np


class BatchLoader:
    def __init__(
        self,
        *arrays: np.ndarray | None,
        batch_size: int,
        shuffle: bool = False,
        drop_remainder: bool = True,
        seed: int = 0,
    ):
        self.arrays = list(arrays)
        sizes = {len(a) for a in self.arrays if a is not None}
        if len(sizes) != 1:
            raise ValueError("all arrays must share the leading dimension")
        self.n = sizes.pop()
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_remainder = drop_remainder
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        if self.drop_remainder:
            return self.n // self.batch_size
        return (self.n + self.batch_size - 1) // self.batch_size

    def epoch_indices(self) -> np.ndarray:
        """The next epoch's sample order (advances the shuffle stream)."""
        idx = np.arange(self.n, dtype=np.int64)
        if self.shuffle:
            self._rng.shuffle(idx)
        return idx

    def epoch_batch_indices(self) -> np.ndarray:
        """``[num_batches, batch_size]`` indices of one epoch (advances the
        shuffle stream); needs ``drop_remainder``."""
        if not self.drop_remainder:
            raise ValueError("epoch_batch_indices needs drop_remainder")
        num_batches = len(self)
        idx = self.epoch_indices()[: num_batches * self.batch_size]
        return idx.reshape(num_batches, self.batch_size)

    def __iter__(self) -> Iterator[tuple[np.ndarray | None, ...]]:
        idx = self.epoch_indices()
        for i in range(len(self)):
            sel = idx[i * self.batch_size : (i + 1) * self.batch_size]
            yield tuple(None if a is None else a[sel] for a in self.arrays)
