"""Training orchestration (``mpgan_tpu/training/loop.py``; train.py:686-985):
the run directory, resume, the epoch loop with the D/G interleave, the
periodic checkpoint, evaluation and plots (W1 of particle features and jet
mass; with ``--efp``, ``--fpnd``, ``--fpd`` and ``--cov-mmd`` also w1efp,
FPND, FPD and coverage/MMD on the trainer's device; the JAX loop's figures
where matplotlib is installed), and the best epoch by FPD. Any generator and
discriminator pair of the registry trains here, with ``--aug-*``
augmentation (``training/train_step.py``).

The training set is staged on the device once and the loss sums stay on the
device, with one host sync per epoch. With ``--epoch-scan`` (the default, as
in the JAX loop, whose ``_can_scan_epoch`` gate this reads: not with
``--break-zero`` or ``--bottleneck``, and here not with ``--debug-nans``,
whose hooks sync on every module) the epoch runs the static-buffer steps of
:class:`.train_step.StepGraphs`: one D+G step a batch when ``num_critic =
num_gen = 1`` (the JAX loop's ``dg_step``), else D and G steps in the
``num_critic``/``num_gen`` interleave. On a GPU each is a CUDA graph replayed a
batch (the counterpart of the JAX epoch's one ``lax.scan`` dispatch), on the
CPU the same bodies run as they are; both give the eager loop's parameters and
losses. ``--no-epoch-scan`` runs the eager loop: each batch's shuffled
indices from one index array on the device, ``d_step``/``g_step`` per batch.

The legacy MPGAN's delayed masking (``--mask-epoch``, old_model.py:268-269)
reads the 0-based model epoch, as the JAX loop passes it: epoch ``e`` trains
with model epoch ``e - 1``, and the evaluation after it generates with the
same. The static steps and the kept sampler take the phase, the largest
threshold crossed (JAX's ``_epoch_phase``), so their graphs are captured again
when a threshold is crossed, where the JAX loop rebuilds its steps. PCGAN (``--pcgan-weights-dir``) trains on the real batches
encoded by the pre-trained ``G_inv`` and decodes its evaluation latents with
``G_pc``; without ``G_inv`` the trainer refuses to start, without ``G_pc`` the
evaluation raises, each naming the missing file.

Debugging (the JAX loop's flags):

- ``--profile`` runs the first epoch under ``torch.profiler`` (host and, on a
  GPU, device activity) and writes its Chrome trace and ``key_averages()``
  table under ``<out_dir>/profile/``, where the JAX loop writes its trace;
- ``--debug`` logs D(real) on the epoch's last batch, G's first samples from
  fixed noise (the key ``PRNGKey(0)``) and D on them, after every epoch;
- ``--debug-nans`` is the counterpart of ``jax_debug_nans``: it raises
  ``FloatingPointError`` at the first NaN. A forward hook on every submodule
  of G and D (a device sync a module) names the first module whose output
  holds a NaN, in the training steps, ``--debug`` and the evaluation alike;
  the epoch's steps run under ``torch.autograd.detect_anomaly(check_nan=True)``,
  whose error on a NaN made in the backward is raised again as
  ``FloatingPointError`` naming the backward function.

``--compute-dtype bfloat16`` trains with bf16 applies on float32 master
parameters, optimizer state and model state (``StepConfig.bf16``); the
evaluation and the checkpoints stay float32, as in the JAX package, where the
flag touches training only. It runs every family: the dense and knn edge
kernels (K2-K8) have bf16 modes, and K9 takes bf16 inputs as the JAX wrapper
does.

``--mesh-shape M`` trains data-parallel on a mesh of ``M`` ranks
(``parallel/mesh.py``; the JAX loop's ``shard_map`` epoch): every rank stages
the whole dataset, shuffles it alike and steps on its contiguous ``B/M`` rows
of every global batch, the steps averaging gradients, losses and model state
over the ranks; a batch that ``M`` does not divide is refused. Rank 0 writes
the args card, checkpoints, losses, plots and the best epoch; the evaluation
generates on the mesh and rank 0 scores it, its results then sent to every
rank. On cards of their own (NCCL) the static steps capture their reduce in
the CUDA graph; with gloo (the CPU, or ranks sharing a card) they run
uncaptured. ``--multi-gpu`` is the config check alone, as in the JAX package.
The batched real+fake D pass is no flag of the loop.
"""

from __future__ import annotations

import logging
import pathlib
import time
from typing import Any, Callable

import numpy as np
import torch

from ..data.jetnet import gen_jet_corrections
from ..data.loader import BatchLoader
from ..evaluation import cov_mmd, efps, fpd, w1efp, w1m, w1p
from ..models.registry import build_suite, pcgan_weight_path
from ..ops import prng
from ..parallel.mesh import Mesh, broadcast_modules, make_mesh
from ..utils import plotting
from . import checkpoint as ckpt
from .config import Args
from .optimizers import build_optimizer
from .sampling import generate_multi_batch
from .train_step import (
    StepGraphs,
    TrainState,
    d_step,
    epoch_kwargs,
    g_step,
    step_config,
    step_kinds,
)

logger = logging.getLogger(__name__)


def mesh_size(args: Args) -> int:
    """``--mesh-shape`` as a number of ranks (0: no mesh)."""
    return int(args.get("mesh_shape") or 0)


def check_supported(args: Args) -> None:
    """Raise ``ValueError`` for a ``--mesh-shape`` that does not divide the batch."""
    m = mesh_size(args)
    if m > 1 and args.batch_size % m:
        raise ValueError(f"--batch-size {args.batch_size} is not divisible by --mesh-shape {m}")


def _corrected(unnorm: np.ndarray, use_mask: bool, **kwargs):
    if use_mask:
        return gen_jet_corrections(unnorm, ret_mask_separate=True, **kwargs)
    return gen_jet_corrections(unnorm, ret_mask_separate=False, **kwargs), None


def _nan_check_hook(name: str):
    def hook(module, inputs, output):
        outs = output if isinstance(output, (tuple, list)) else (output,)
        if any(isinstance(o, torch.Tensor) and torch.isnan(o).any() for o in outs):
            raise FloatingPointError(f"--debug-nans: NaN in the output of {name} "
                                     f"({type(module).__name__})")
    return hook


class Trainer:
    def __init__(self, args: Args, train_dataset: Any = None, valid_dataset: Any = None,
                 device: torch.device | str = "cuda",
                 fpnd_fn: Callable[..., float] | None = None, mesh: Mesh | None = None):
        """``fpnd_fn(gen_jets, jet_type, real_jets)`` computes FPND
        (``evaluation.fpnd.make_fpnd_fn``); ``--fpnd`` without it adds no FPND,
        as in the JAX loop. ``mesh`` defaults to one of ``--mesh-shape`` ranks
        on ``device``'s type; the trainer then runs on the rank's device."""
        check_supported(args)
        self.args = args
        if mesh is None and mesh_size(args):
            mesh = make_mesh(mesh_size(args), device_type=torch.device(device).type)
        self.mesh = mesh
        self.is_main = mesh is None or mesh.is_main
        self.device = torch.device(device) if mesh is None else mesh.device
        self.train_dataset = train_dataset
        self.valid_dataset = valid_dataset
        self.fpnd_fn = fpnd_fn

        # directory scaffolding and the name-collision guard (setup_training.py:1086-1110)
        self.out_dir = pathlib.Path(args.dir_path or "outputs") / args.name
        self.models_dir = self.out_dir / "models"
        self.losses_dir = self.out_dir / "losses"
        self.figs_dir = self.out_dir / "figs"
        if (self.out_dir.exists() and args.name != "test" and not args.get("load_model", True)
                and not args.get("override_load_check")):
            raise RuntimeError(
                "A model directory of this name already exists, either change the name or use "
                "the --override-load-check flag"
            )
        if mesh is not None:  # every rank has looked before any makes the directory
            mesh.barrier()
        for d in (self.models_dir, self.losses_dir, self.figs_dir):
            d.mkdir(parents=True, exist_ok=True)

        # resume detection before the args card, which only a fresh run writes
        self.start_epoch = ckpt.latest_epoch(self.models_dir) if args.get("load_model", True) else 0
        if self.start_epoch == 0 and self.is_main:
            (self.out_dir / f"{args.name}_args.txt").write_text(str(args.to_dict()))

        # the reference's eval-time use_mask gate (train.py:703), quirk included
        self.use_labels = bool(args.get("mask_c") or args.clabels or args.get("gapt_mask"))
        self.step_cfg = step_config(args)
        self.pcgan_weights_dir = args.get("pcgan_weights_dir") or None
        suite = build_suite(args, pcgan_weights_dir=self.pcgan_weights_dir)
        if suite.model == "pcgan" and suite.encode_real is None:
            raise FileNotFoundError(
                "pcgan trains on G_inv's latents: "
                f"{pcgan_weight_path(args, self.pcgan_weights_dir, 'inv')} not found "
                "(--pcgan-weights-dir)")
        self.suite = suite
        self.spec = suite.noise
        self.post_gen = suite.post_gen  # --mask-manual
        # the evaluation's hook on generated batches: PCGAN's point decoder, or
        # the --mask-manual column
        self.eval_post_fn = suite.decode_eval
        if self.eval_post_fn is None and suite.post_gen is not None:
            self.eval_post_fn = lambda out, point_noise: suite.post_gen(out)
        # the 0-based model epoch the legacy MPGAN's --mask-epoch compares against
        self.model_epoch = self.start_epoch
        # kg, kd, krest = split(PRNGKey(seed), 3), as init_train_state splits
        # it: G and D drawn on the device from the first two, the steps' key
        # the third, so one seed gives the JAX package's weights and stream
        root = prng.PRNGKey(int(args.seed))
        g = suite.generator(prng.fold_in(root, 0), device=self.device)
        d = suite.discriminator(prng.fold_in(root, 1), device=self.device)
        opt = lambda m, lr: build_optimizer(  # noqa: E731
            args.optimizer, m.parameters(), lr, beta1=args.beta1, beta2=args.beta2)
        key = prng.fold_in(root, 2).to(self.device)
        self.state = TrainState(g, d, opt(g, args.lr_gen), opt(d, args.lr_disc), key)
        if self.start_epoch > 0:
            ckpt.load_train_state(ckpt.checkpoint_path(self.models_dir, self.start_epoch),
                                  self.state)
            logger.info(f"resumed from epoch {self.start_epoch}")
        if mesh is not None:
            broadcast_modules([g, d], mesh)
        if args.get("debug_nans"):
            for module, label in ((g, "G"), (d, "D")):
                for name, sub in module.named_modules():
                    sub.register_forward_hook(_nan_check_hook(f"{label}.{name}" if name
                                                              else label))

        self.d_loss_keys = ["Dr", "Df", "D"] + (["gp"] if args.gp else [])
        self.eval_keys = ["w1p", "w1m"] + [key for flag, key in (
            ("efp", "w1efp"), ("fpnd", "fpnd"), ("fpd", "fpd"), ("cov_mmd", "cov_mmd"))
            if args.get(flag) and (key != "fpnd" or fpnd_fn is not None)]
        self.multi_value_keys = ["w1p", "w1m", "w1efp", "fpd", "cov_mmd"]
        keys = self.d_loss_keys + ["G"] + self.eval_keys
        if self.start_epoch:
            self.losses = ckpt.load_losses(self.losses_dir, keys, self.eval_keys,
                                           self.multi_value_keys, self.start_epoch,
                                           args.save_epochs)
        else:
            self.losses = {k: [] for k in keys}
        # [[epoch, FPD + std], ...], from the reference's sentinel; a resume
        # keeps it, so a worse model never overwrites state_best_epoch.npz
        # (setup_training.py:1588-1596)
        self.best_epoch = [[0, 10.0]]
        best_file = self.out_dir / "best_epoch.txt"
        if self.start_epoch > 0 and best_file.exists():
            self.best_epoch = np.atleast_2d(np.loadtxt(best_file)).tolist()
        self._staged = None
        self._staged_loader = None
        self._no_plots_logged = False
        # --mask-epoch thresholds of the modules that read the model epoch
        self._mask_thresholds = sorted({int(m.cfg.mask_epoch) for m in (g, d)
                                        if getattr(m, "reads_epoch", False)})
        capture = self.device.type == "cuda" and (mesh is None or mesh.backend == "nccl")
        if self.device.type == "cuda" and not capture:
            logger.info("the gloo reduce stages through the host and is not captured: the "
                        "epoch's static steps run uncaptured")
        self.graphs = StepGraphs(self.state, self.step_cfg, self.spec, self.d_loss_keys + ["G"],
                                 self.device, post_gen=self.post_gen,
                                 encode_real=suite.encode_real, capture=capture, mesh=mesh)

    def _batch_indices(self, loader: BatchLoader) -> np.ndarray:
        """The epoch's ``[num_batches, B]`` indices, or this rank's ``B/M`` columns."""
        order = loader.epoch_batch_indices()
        return order if self.mesh is None else order[:, self.mesh.rows(order.shape[1])]

    # -- one epoch (train.py:812-886) ----------------------------------------

    def _stage(self, loader: BatchLoader):
        """The loader's arrays on the device, copied once per loader."""
        if self._staged_loader is not loader:
            data = torch.as_tensor(loader.arrays[0], device=self.device)
            labels = None
            if self.use_labels and len(loader.arrays) > 1 and loader.arrays[1] is not None:
                labels = torch.as_tensor(loader.arrays[1], device=self.device)
            self._staged, self._staged_loader = (data, labels), loader
        return self._staged

    def _epoch_phase(self, model_epoch: int) -> int:
        """The largest ``--mask-epoch`` threshold crossed by ``model_epoch`` (0
        before any): ``phase >= t`` exactly when ``model_epoch >= t`` for every
        threshold ``t`` (the JAX loop's ``_epoch_phase``)."""
        return max([0] + [t for t in self._mask_thresholds if t <= model_epoch])

    def can_scan_epoch(self, loader: BatchLoader) -> bool:
        """Whether the epoch runs the static-buffer steps (the JAX loop's
        ``_can_scan_epoch``, and not under ``--debug-nans``)."""
        args = self.args
        return bool(args.get("epoch_scan", True) and loader.drop_remainder
                    and not args.get("break_zero") and not args.get("bottleneck")
                    and not args.get("debug_nans"))

    def train_epoch(self, epoch: int, loader: BatchLoader) -> dict[str, float]:
        args = self.args
        if len(loader) == 0:
            raise ValueError(
                f"training dataset ({loader.n} samples) is smaller than the batch size "
                f"({loader.batch_size}): no full batch to train on"
            )
        self.model_epoch = epoch - 1
        data_all, labels_all = self._stage(loader)
        num_batches = len(loader)
        if self.can_scan_epoch(loader):
            sums = self.graphs.sums
            for v in sums.values():
                v.zero_()
            steps = step_kinds(num_batches, args.num_critic, args.num_gen)
            self.graphs.epoch(steps, data_all, labels_all, self._batch_indices(loader),
                              self._epoch_phase(self.model_epoch))
            last = self.graphs.last_batch()
            data = data_all.index_select(0, last)
            labels = None if labels_all is None else labels_all.index_select(0, last)
            return self._end_epoch(epoch, sums, num_batches, data, labels)
        order = torch.as_tensor(self._batch_indices(loader), device=self.device)
        sums = {k: torch.zeros((), device=self.device) for k in self.d_loss_keys + ["G"]}
        steps = (data_all, labels_all, order, num_batches, sums)
        if args.get("debug_nans"):
            try:
                with torch.autograd.detect_anomaly(check_nan=True):
                    data, labels = self._epoch_steps(*steps)
            except RuntimeError as err:  # anomaly mode's NaN in the backward
                if "returned nan values" not in str(err):
                    raise
                raise FloatingPointError(f"--debug-nans: {err}") from err
        else:
            data, labels = self._epoch_steps(*steps)
        return self._end_epoch(epoch, sums, num_batches, data, labels)

    def _end_epoch(self, epoch, sums, num_batches, data, labels) -> dict[str, float]:
        args = self.args
        epoch_loss = dict(zip(sums, torch.stack(list(sums.values())).tolist()))  # one sync
        bad = [k for k, v in epoch_loss.items() if not np.isfinite(v)]
        if bad:
            logger.warning(f"non-finite epoch losses at epoch {epoch}: {bad}")
        if args.get("debug"):
            self._log_d_outputs(data, labels)
        for key in self.d_loss_keys:
            self.losses[key].append(epoch_loss[key] / (num_batches / args.num_gen))
        self.losses["G"].append(epoch_loss["G"] / (num_batches / args.num_critic))
        return epoch_loss

    def _epoch_steps(self, data_all, labels_all, order, num_batches, sums):
        """The epoch's D and G steps, their losses added to ``sums``; returns the
        last batch."""
        args = self.args
        for batch_ndx in range(num_batches):
            idx = order[batch_ndx]
            data = data_all[idx]
            labels = labels_all[idx] if labels_all is not None else None
            # the num_critic / num_gen interleave (train.py:841-878)
            if args.num_critic > 1 or batch_ndx == 0 or (batch_ndx - 1) % args.num_gen == 0:
                for k, v in d_step(self.state, self.step_cfg, self.spec, data, labels,
                                   post_gen=self.post_gen, encode_real=self.suite.encode_real,
                                   epoch=self.model_epoch, mesh=self.mesh).items():
                    sums[k] += v
            if args.num_critic == 1 or (batch_ndx - 1) % args.num_critic == 0:
                sums["G"] += g_step(self.state, self.step_cfg, self.spec, data, labels,
                                    post_gen=self.post_gen, epoch=self.model_epoch,
                                    mesh=self.mesh)["G"]
            if args.get("break_zero") and batch_ndx == 0:
                break
            if args.get("bottleneck") and batch_ndx == 10:
                break
        return data, labels

    def _log_d_outputs(self, data: torch.Tensor, labels: torch.Tensor | None):
        """``--debug``: D(real) on ``data``, G's samples from fixed noise
        (the key ``PRNGKey(0)``, ``mpgan_tpu/training/loop.py:531``) and D on them,
        D and G in eval mode with
        their spectral-norm vectors left alone (train.py:413-447); returns the
        three tensors."""
        g, d, suite = self.state.g, self.state.d, self.suite
        g_kw, d_kw = epoch_kwargs(g, self.model_epoch), epoch_kwargs(d, self.model_epoch)
        with torch.no_grad():
            if suite.encode_real is not None:
                data = suite.encode_real(data)
            real_out = d(data, labels, update_sn=False, **d_kw)
            noise = self.spec.sample(prng.PRNGKey(0, self.device), data.shape[0])
            fake = g(noise, labels, update_sn=False, **g_kw)
            if self.post_gen is not None:
                fake = self.post_gen(fake)
            fake_out = d(fake, labels, update_sn=False, **d_kw)
        logger.info(f"D real output: \n {real_out[:10].cpu().numpy()}")
        logger.info(f"G output: \n {fake[:2, :10].cpu().numpy()}")
        logger.info(f"D fake output: \n {fake_out[:10].cpu().numpy()}")
        return real_out, fake, fake_out

    # -- checkpoint + evaluation (train.py:686-809) ---------------------------

    def eval_save_plot(self, epoch: int) -> None:
        """Save the state, generate the evaluation's jets and score them. On a
        mesh every rank generates (``generate_multi_batch(mesh=)``), rank 0
        saves and scores, and every rank takes rank 0's losses and best epoch."""
        args = self.args
        state_path = ckpt.checkpoint_path(self.models_dir, epoch)
        if self.is_main:
            ckpt.save_train_state(state_path, self.state)

        if self.suite.model == "pcgan" and self.suite.decode_eval is None:
            raise FileNotFoundError(
                "the pcgan evaluation decodes latents with G_pc: "
                f"{pcgan_weight_path(args, self.pcgan_weights_dir, 'pc')} not found "
                "(--pcgan-weights-dir)")
        ds = self.valid_dataset
        n_eval = min(args.eval_tot_samples, len(ds))
        if args.get("eval_shuffle"):
            sel = np.sort(np.random.default_rng(args.seed).permutation(len(ds))[:n_eval])
        else:
            sel = slice(None, n_eval)
        real_jets, real_mask = _corrected(
            ds.particle_normalisation(ds.particle_data[sel], inverse=True), self.use_labels,
            zero_mask_particles=False, zero_neg_pt=False)
        labels = ds.jet_data[sel] if self.use_labels else None
        gen_norm = generate_multi_batch(
            self.state.g, self.spec, prng.PRNGKey(epoch, self.device),
            n_eval, args.batch_size, labels=labels, mesh=self.mesh, post_fn=self.eval_post_fn,
            **epoch_kwargs(self.state.g, self._epoch_phase(self.model_epoch)),
        )
        if self.is_main:
            self._score(epoch, state_path, n_eval, real_jets, real_mask, gen_norm)
        self._share_losses()

    def _share_losses(self) -> None:
        """On a mesh, rank 0's losses and best epoch on every rank."""
        if self.mesh is not None:
            self.losses, self.best_epoch = self.mesh.broadcast_object(
                (self.losses, self.best_epoch))

    def _score(self, epoch, state_path, n_eval, real_jets, real_mask, gen_norm) -> None:
        """The evaluation's metrics of the generated jets, their files and
        figures, and the best epoch."""
        args, ds = self.args, self.valid_dataset
        gen_jets, gen_mask = _corrected(ds.particle_normalisation(gen_norm, inverse=True),
                                        self.use_labels, zero_mask_particles=self.use_labels,
                                        zero_neg_pt=False)

        num_w1 = (args.w1_num_samples[0] if isinstance(args.w1_num_samples, list)
                  else args.w1_num_samples)
        num_batches = max(len(real_jets) // num_w1, 1)
        w1pm, w1ps = w1p(real_jets, gen_jets, num_eval_samples=num_w1, num_batches=num_batches)
        self.losses["w1p"].append(np.concatenate([w1pm, w1ps]).tolist())
        w1mm, w1ms = w1m(real_jets, gen_jets, num_eval_samples=num_w1, num_batches=num_batches)
        self.losses["w1m"].append([w1mm, w1ms])
        if "w1efp" in self.eval_keys:
            w1em, w1es = w1efp(real_jets, gen_jets, num_eval_samples=num_w1,
                               num_batches=num_batches, device=self.device)
            self.losses["w1efp"].append(np.concatenate([w1em, w1es]).tolist())
        if "fpnd" in self.eval_keys:
            self.losses["fpnd"].append(float(self.fpnd_fn(gen_jets, args.jets, real_jets)))
        if "cov_mmd" in self.eval_keys:
            cov, mmd = cov_mmd(real_jets, gen_jets,
                               num_eval_samples=min(args.cov_mmd_num_samples, n_eval),
                               num_batches=args.cov_mmd_num_batches, device=self.device)
            self.losses["cov_mmd"].append([cov, mmd])
        real_efps = gen_efps = None
        if "fpd" in self.eval_keys:
            real_efps = self._cached_real_efps(real_jets)
            gen_efps = efps(gen_jets, select="d<=4-all", device=self.device)
            bad = ~np.isfinite(gen_efps).all(axis=1)
            if bad.any():
                # an early generator's negative-pT jets overflow the FP32 path;
                # the reference's float64 keeps them huge but finite, so those
                # rows alone are recomputed that way (train.py:744-757)
                gen_efps[bad] = efps(gen_jets[bad], select="d<=4-all", use_device=False)
            self.losses["fpd"].append(list(fpd(
                real_jets, gen_jets, real_efps=real_efps, gen_efps=gen_efps,
                min_samples=min(5000, n_eval // 2), max_samples=min(20000, n_eval))))
        ckpt.save_losses(self.losses, self.losses_dir)
        metrics = " ".join(f"{k} {np.asarray(self.losses[k][-1]).tolist()}"
                           for k in self.eval_keys)
        logger.info(f"epoch {epoch}: {metrics}")
        self._plot(lambda: self._plot_eval(epoch, real_jets, gen_jets, real_mask, gen_mask,
                                           real_efps, gen_efps))

        # the best epoch by FPD + std (train.py:794-809)
        if "fpd" in self.eval_keys and epoch > 0:
            score = sum(self.losses["fpd"][-1])
            if score < self.best_epoch[-1][1]:
                self.best_epoch.append([epoch, score])
                np.savetxt(self.out_dir / "best_epoch.txt", np.asarray(self.best_epoch))
                np.save(self.out_dir / "best_epoch_gen_jets.npy", gen_jets)
                if gen_mask is not None:
                    np.save(self.out_dir / "best_epoch_gen_mask.npy", gen_mask)
                (self.out_dir / "best_epoch_losses.txt").write_text(
                    str({key: vals[-1] for key, vals in self.losses.items() if vals}))
                # the state saved above: the evaluation changed nothing in it
                ckpt.copy_checkpoint(state_path, self.out_dir / "state_best_epoch.npz")

    def _plot(self, plots: Callable[[], None]) -> None:
        """Run ``plots``; plotting never stops training (the JAX loop's rule).
        Without matplotlib, one log line and no figure."""
        try:
            plots()
        except ImportError as exc:
            if not self._no_plots_logged:
                logger.warning(f"no figures are written: {exc}")
                self._no_plots_logged = True
        except Exception:
            logger.exception("plotting failed")

    def _plot_eval(self, epoch, real_jets, gen_jets, real_mask, gen_mask, real_efps, gen_efps):
        """The JAX loop's figures (``mpgan_tpu/training/loop.py:622-635``)."""
        args = self.args
        plotting.plot_part_feats_jet_mass(args.jets, real_jets, gen_jets, real_mask, gen_mask,
                                          f"{epoch}pm", str(self.figs_dir),
                                          num_particles=args.num_hits, losses=self.losses)
        if len(self.losses["G"]) > 1:
            plotting.plot_losses(self.losses, args.loss, str(epoch), str(self.losses_dir))
        if len(self.losses["w1m"]) > 1:
            plotting.plot_eval(self.losses, epoch, args.save_epochs, f"{epoch}_eval",
                               str(self.losses_dir))
        if real_efps is not None:
            plotting.plot_efps(args.jets, real_efps, gen_efps, f"{epoch}efp", str(self.figs_dir))

    def _cached_real_efps(self, real_jets: np.ndarray) -> np.ndarray:
        """The real side's EFPs, cached in the run directory (train.py:744-757)
        under the JAX package's name; a shuffled evaluation has its own file."""
        mode = f"_shuf{self.args.seed}" if self.args.get("eval_shuffle") else ""
        cache = self.out_dir / f"real_efps_d4all_{self.args.jets}{mode}.npy"
        if cache.exists():
            arr = np.load(cache)
            if len(arr) == len(real_jets):
                return arr
        arr = efps(real_jets, select="d<=4-all", device=self.device)
        np.save(cache, arr)
        return arr

    # -- full run (train.py:889-985) -----------------------------------------

    def train(self) -> None:
        args = self.args
        if self.start_epoch == 0 and args.get("save_zero"):
            self.eval_save_plot(0)
        loader = BatchLoader(
            self.train_dataset.particle_data,
            self.train_dataset.jet_data if self.use_labels else None,
            batch_size=args.batch_size, shuffle=True, seed=args.seed,
        )
        for i in range(self.start_epoch, args.num_epochs):
            epoch = i + 1
            t0 = time.time()
            if args.get("profile") and i == self.start_epoch and self.is_main:
                self._profiled_epoch(epoch, loader)
            else:
                self.train_epoch(epoch, loader)
            logger.info(
                f"epoch {epoch}: "
                + " ".join(f"{k}={self.losses[k][-1]:.4f}" for k in self.d_loss_keys + ["G"])
                + f" ({time.time() - t0:.1f}s)"
            )
            if epoch % args.save_epochs == 0:
                self.eval_save_plot(epoch)
            elif epoch % args.save_model_epochs == 0 and self.is_main:
                ckpt.save_train_state(ckpt.checkpoint_path(self.models_dir, epoch), self.state)
                ckpt.save_losses(self.losses, self.losses_dir)

    def _profiled_epoch(self, epoch: int, loader: BatchLoader) -> None:
        """``--profile``: the epoch under ``torch.profiler`` (host, and the
        device on a GPU); its Chrome trace and ``key_averages()`` table go to
        ``<out_dir>/profile/`` (the JAX loop traces its first epoch there)."""
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        out = self.out_dir / "profile"
        out.mkdir(parents=True, exist_ok=True)
        with profile(activities=activities) as prof:
            self.train_epoch(epoch, loader)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        prof.export_chrome_trace(str(out / f"epoch_{epoch}_trace.json"))
        sort = "self_cuda_time_total" if self.device.type == "cuda" else "self_cpu_time_total"
        (out / f"epoch_{epoch}_key_averages.txt").write_text(
            prof.key_averages().table(sort_by=sort, row_limit=60))
        logger.info(f"profile of epoch {epoch} written to {out}")
