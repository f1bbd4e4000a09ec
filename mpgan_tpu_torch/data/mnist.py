"""Sparsified-MNIST point clouds (numpy; a copy of ``mpgan_tpu/data/mnist.py``,
mnist/mnist_dataset.py:8-53), the workload of ``cli.train_mnist``.

Each image becomes a cloud of the ``num_thresholded`` brightest pixels with
features ``[x, y, intensity]``: grid coordinates in [-0.5, 0.5) and
intensities normalized as ``(v - 127.5) / 255``. Without the MNIST CSVs
(``mnist_train.csv``, ``mnist_test.csv`` under ``data_dir``) a synthetic
fallback draws blob-like digits from a seed, the same clouds as the JAX
package's.
"""

from __future__ import annotations

import pathlib

import numpy as np


def _clouds_from_images(images: np.ndarray, num_thresholded: int, intensities: bool) -> np.ndarray:
    """images: [B, 784] raw pixel values 0..255 -> clouds [B, K, 3 (or 2)]."""
    x_pre = (images - 127.5) / 255.0
    imrange = np.linspace(-0.5, 0.5, num=28, endpoint=False)
    xs, ys = np.meshgrid(imrange, imrange)
    xs, ys = xs.reshape(-1), ys.reshape(-1)

    # top-K pixels by intensity, in ascending-intensity order (the reference
    # keeps argsort order, mnist/mnist_dataset.py:37-41)
    order = np.argsort(x_pre, axis=1)[:, -num_thresholded:]
    batch_idx = np.arange(images.shape[0])[:, None]
    cloud = np.stack(
        [xs[order], ys[order], x_pre[batch_idx, order]], axis=-1
    ).astype(np.float32)
    if not intensities:
        cloud = cloud[..., :2]
    return cloud


def synthetic_mnist(num: int, num_samples: int, seed: int = 0) -> np.ndarray:
    """Blob-sketch stand-ins for digits: random strokes on the 28x28 grid."""
    rng = np.random.default_rng(seed + (num if num >= 0 else 99))
    images = np.zeros((num_samples, 28, 28), dtype=np.float32)
    yy, xx = np.mgrid[0:28, 0:28]
    for i in range(num_samples):
        n_blobs = rng.integers(2, 5)
        for _ in range(n_blobs):
            cx, cy = rng.uniform(6, 22, 2)
            sx, sy = rng.uniform(1.5, 4.0, 2)
            images[i] += 255 * np.exp(
                -((xx - cx) ** 2 / (2 * sx**2) + (yy - cy) ** 2 / (2 * sy**2))
            )
    return np.clip(images, 0, 255).reshape(num_samples, 784)


class MNISTGraphDataset:
    def __init__(
        self,
        data_dir: str | None,
        num_thresholded: int,
        train: bool = True,
        intensities: bool = True,
        num: int | list[int] = -1,
        synthetic_num_samples: int = 2000,
    ):
        csv = None
        if data_dir is not None:
            name = "mnist_train.csv" if train else "mnist_test.csv"
            p = pathlib.Path(data_dir) / name
            if p.exists():
                csv = p

        if csv is not None:
            dataset = np.loadtxt(csv, delimiter=",", dtype=np.float32)
            if isinstance(num, list):
                dataset = dataset[np.isin(dataset[:, 0], num)]
            elif num > -1:
                dataset = dataset[dataset[:, 0] == num]
            images = dataset[:, 1:]
        else:
            images = synthetic_mnist(
                num if isinstance(num, int) else num[0], synthetic_num_samples
            )

        self.X = _clouds_from_images(images, num_thresholded, intensities)

    def __len__(self) -> int:
        return len(self.X)

    def __getitem__(self, idx):
        return self.X[idx]
