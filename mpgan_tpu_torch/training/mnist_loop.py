"""MNIST point-cloud GAN training (``mpgan_tpu/training/mnist_loop.py``;
train_mnist.py), the second training entry point (``cli.train_mnist``).

The jet :class:`~.loop.Trainer`'s engine (the same D and G steps on the card,
with ``--aug-*``, ``--profile``, ``--debug`` and ``--debug-nans``) with the
MNIST evaluation every ``save_epochs`` (train_mnist.py:612-693): clouds
generated on the card, their FID by the MoNet classifier on the host
(``evaluation/mnist_fid.py``) when ``--mnist-eval-resources`` names the
shipped resources, the cloud raster and the FID curve, and the best epoch by
FID instead of FPD. On a mesh (``--mesh-shape``) the clouds are generated on
every rank (``mpgan_tpu/training/mnist_loop.py:54-59``) and rank 0 saves,
scores and plots, as in the jet loop.
"""

from __future__ import annotations

import logging
import pathlib

import numpy as np

from ..evaluation.mnist_fid import get_fid
from ..ops import prng
from ..utils import plotting
from . import checkpoint as ckpt
from .loop import Trainer
from .sampling import generate_multi_batch
from .train_step import epoch_kwargs

logger = logging.getLogger(__name__)


class MNISTDatasetView:
    """``data.mnist.MNISTGraphDataset`` in the interface the Trainer reads."""

    def __init__(self, mnist_dataset):
        self.particle_data = np.asarray(mnist_dataset.X, np.float32)
        self.jet_data = None
        self.particle_normalisation = lambda x, inverse=False: x

    def __len__(self):
        return len(self.particle_data)


class MNISTTrainer(Trainer):
    def __init__(self, args, **kwargs):
        super().__init__(args, **kwargs)
        self.losses.setdefault("fid", [])
        self.eval_keys = ["fid"]
        self.resources_path = args.get("mnist_eval_resources") or None
        if self.resources_path and not pathlib.Path(self.resources_path).exists():
            logger.warning(f"MNIST eval resources not found at {self.resources_path}")
            self.resources_path = None

    def eval_save_plot(self, epoch: int) -> None:
        args = self.args
        state_path = ckpt.checkpoint_path(self.models_dir, epoch)
        if self.is_main:
            ckpt.save_train_state(state_path, self.state)

        n_eval = args.get("fid_eval_samples", 8192)
        gen_clouds = generate_multi_batch(
            self.state.g, self.spec, prng.PRNGKey(epoch, self.device),
            n_eval, args.batch_size, mesh=self.mesh,
            **epoch_kwargs(self.state.g, self.model_epoch))
        if self.is_main:
            self._score_mnist(epoch, state_path, n_eval, gen_clouds)
        self._share_losses()

    def _score_mnist(self, epoch: int, state_path, n_eval: int, gen_clouds: np.ndarray) -> None:
        args = self.args

        if self.resources_path is not None:
            fid = get_fid(gen_clouds, args.num_hits, args.mnist_num, self.resources_path,
                          eval_size=n_eval)
            self.losses["fid"].append(fid)
            logger.info(f"epoch {epoch}: FID = {fid:.3f}")

        ckpt.save_losses(self.losses, self.losses_dir)
        self._plot(lambda: self._plot_mnist(epoch, gen_clouds))

        # the best epoch by FID (train_mnist.py:680-693)
        if self.losses.get("fid") and epoch > 0:
            if self.losses["fid"][-1] < self.best_epoch[-1][1]:
                self.best_epoch.append([epoch, self.losses["fid"][-1]])
                np.savetxt(self.out_dir / "best_epoch.txt", np.asarray(self.best_epoch))
                ckpt.copy_checkpoint(state_path, self.out_dir / "state_best_epoch.npz")

    def _plot_mnist(self, epoch: int, gen_clouds: np.ndarray) -> None:
        """The JAX MNIST loop's figures (``mpgan_tpu/training/mnist_loop.py:70-75``)."""
        args = self.args
        plotting.mnist_cloud_image(gen_clouds, f"{epoch}_clouds", str(self.figs_dir))
        if len(self.losses.get("fid", [])) > 1:
            plotting.plot_fid(self.losses["fid"], str(epoch), str(self.losses_dir))
        if len(self.losses["G"]) > 1:
            plotting.plot_losses(self.losses, args.loss, str(epoch), str(self.losses_dir))
