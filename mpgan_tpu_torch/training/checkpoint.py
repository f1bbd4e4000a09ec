"""Checkpoint and resume (``mpgan_tpu/training/checkpoint.py``; setup_training.py:1138-1152).

A checkpoint is one ``state_<epoch>.npz`` per epoch in the JAX package's
layout: ``leaf_i`` in the ``jax.tree.flatten`` order of its ``TrainState(
g_params, g_state, d_params, d_state, g_opt_state, d_opt_state, rng)``, so
one file moves between the two packages. The leaves, in order:

- each model's parameters and mutable state in the JAX pytree order
  (``utils.weights.jax_leaves``);
- each optimizer's state per parameter in the same order: RMSprop
  ``square_avg`` (``RMSPropState.sq_avg``); Adam ``step`` once, then
  ``exp_avg``, then ``exp_avg_sq`` (``AdamState(count, mu, nu)``); Adadelta
  ``square_avg`` then ``acc_delta``. An optimizer that has not stepped yet
  saves zeros, as optax's fresh state holds;
- the rng: the state's threefry key, its two uint32 words as they are. Both
  packages read them as their PRNG key, so a JAX TrainState carries its
  stream across and a resume continues the saved run's stream. Any two words
  load as a key, those of a port checkpoint whose rng leaf holds two words
  drawn from a ``torch.Generator`` (before the port's stream was JAX's) too.

Loss histories are one ``<key>.txt`` per metric (np.savetxt, train.py:538-540),
truncated to the resume epoch on load (setup_training.py:1576-1579). Writes
are atomic (a temporary file, then a rename).
"""

from __future__ import annotations

import os
import pathlib
import re
import shutil

import numpy as np
import torch

from ..utils.weights import jax_leaves, refresh_sn_v
from .optimizers import state_names
from .train_step import TrainState, drop_graphs


def _opt_leaves(opt: torch.optim.Optimizer, params: list[torch.Tensor]) -> list[np.ndarray]:
    names = state_names(opt)
    out: list[np.ndarray] = []
    for name in names:
        if name == "step":
            st = opt.state.get(params[0], {}) if params else {}
            out.append(np.asarray(int(float(st.get("step", 0))), np.int32))
            continue
        for p in params:
            t = opt.state.get(p, {}).get(name)
            out.append(np.zeros(tuple(p.shape), np.float32) if t is None
                       else t.detach().cpu().numpy().astype(np.float32))
    return out


def train_state_leaves(state: TrainState) -> list[np.ndarray]:
    """The TrainState as the JAX package's flattened leaves."""
    g_params, d_params = jax_leaves(state.g, True), jax_leaves(state.d, True)
    leaves = [t.detach().cpu().numpy() for t in g_params]
    leaves += [t.detach().cpu().numpy() for t in jax_leaves(state.g, params=False)]
    leaves += [t.detach().cpu().numpy() for t in d_params]
    leaves += [t.detach().cpu().numpy() for t in jax_leaves(state.d, params=False)]
    leaves += _opt_leaves(state.g_opt, g_params) + _opt_leaves(state.d_opt, d_params)
    leaves.append(state.rng.detach().cpu().numpy().astype(np.uint32).reshape(2))
    return leaves


def _load_opt(opt: torch.optim.Optimizer, params: list[torch.Tensor], leaves: list,
              pos: int) -> int:
    names = state_names(opt)
    step = None
    if "step" in names:
        step = float(leaves[pos])
        pos += 1
    per_param: list[dict] = [{} for _ in params]
    for name in names:
        if name == "step":
            continue
        for k, p in enumerate(params):
            per_param[k][name] = torch.tensor(np.asarray(leaves[pos], np.float32), device=p.device)
            pos += 1
    capturable = opt.defaults.get("capturable", False)
    for p, st in zip(params, per_param):
        # torch keeps a step counter per parameter; only Adam's is part of the state.
        # A capturable optimizer keeps it on the parameter's device
        st["step"] = torch.tensor(step if step is not None else 0.0,
                                  device=p.device if capturable else None)
        opt.state[p] = st
    return pos


def load_train_state_leaves(state: TrainState, leaves: list) -> None:
    """Copy JAX-layout leaves into ``state`` (models, optimizers, rng) in place.
    The optimizer state is new tensors, so the static steps and samplers made
    for ``state`` are dropped (``train_step.drop_graphs``)."""
    drop_graphs(state)
    g_params, d_params = jax_leaves(state.g, True), jax_leaves(state.d, True)
    tensors = (g_params + jax_leaves(state.g, params=False)
               + d_params + jax_leaves(state.d, params=False))
    n_opt = sum(len(params) * len([n for n in state_names(opt) if n != "step"])
                + ("step" in state_names(opt))
                for opt, params in ((state.g_opt, g_params), (state.d_opt, d_params)))
    expected = len(tensors) + n_opt + 1
    if len(leaves) != expected:
        raise ValueError(f"checkpoint has {len(leaves)} leaves, the train state {expected} "
                         "(model/optimizer config mismatch)")
    with torch.no_grad():
        for t, leaf in zip(tensors, leaves):
            arr = np.asarray(leaf)
            if tuple(arr.shape) != tuple(t.shape):
                raise ValueError(f"checkpoint leaf shape {arr.shape} != {tuple(t.shape)}")
            t.copy_(torch.as_tensor(arr.astype(np.float32)))
    refresh_sn_v(state.g)
    refresh_sn_v(state.d)
    pos = _load_opt(state.g_opt, g_params, leaves, len(tensors))
    pos = _load_opt(state.d_opt, d_params, leaves, pos)
    words = np.asarray(leaves[pos]).astype(np.uint32).reshape(2)
    state.rng.copy_(torch.from_numpy(words.copy()).to(state.rng.device))


def save_train_state(path: str | pathlib.Path, state: TrainState) -> None:
    path = pathlib.Path(path)
    leaves = train_state_leaves(state)
    tmp = path.with_name(path.name + ".tmp")
    with open(tmp, "wb") as f:
        np.savez(f, **{f"leaf_{i}": leaf for i, leaf in enumerate(leaves)})
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def copy_checkpoint(src: str | pathlib.Path, dst: str | pathlib.Path) -> None:
    """Copy a saved checkpoint, atomically."""
    dst = pathlib.Path(dst)
    tmp = dst.with_name(dst.name + ".tmp")
    shutil.copyfile(src, tmp)
    with open(tmp, "rb+") as f:
        os.fsync(f.fileno())
    os.replace(tmp, dst)


def load_train_state(path: str | pathlib.Path, state: TrainState) -> None:
    with np.load(path) as data:
        leaves = [data[f"leaf_{i}"] for i in range(len(data.files))]
    load_train_state_leaves(state, leaves)


def checkpoint_path(models_dir: str | pathlib.Path, epoch: int) -> pathlib.Path:
    return pathlib.Path(models_dir) / f"state_{epoch}.npz"


def latest_epoch(models_dir: str | pathlib.Path) -> int:
    """Newest epoch with a saved snapshot, 0 if none (setup_training.py:1138-1152)."""
    models_dir = pathlib.Path(models_dir)
    if not models_dir.exists():
        return 0
    epochs = [
        int(m.group(1))
        for f in models_dir.iterdir()
        if (m := re.fullmatch(r"state_(\d+)\.npz", f.name))
    ]
    return max(epochs, default=0)


def save_losses(losses: dict[str, list], losses_dir: str | pathlib.Path) -> None:
    losses_dir = pathlib.Path(losses_dir)
    losses_dir.mkdir(parents=True, exist_ok=True)
    for key, vals in losses.items():
        path = losses_dir / f"{key}.txt"
        tmp = path.with_name(path.name + ".tmp")
        np.savetxt(tmp, np.asarray(vals))
        os.replace(tmp, path)


def load_losses(losses_dir: str | pathlib.Path, keys: list[str], eval_keys: list[str],
                multi_value_keys: list[str], start_epoch: int, save_epochs: int
                ) -> dict[str, list]:
    """Reload metric histories, truncated to the resume epoch (setup_training.py:1566-1584)."""
    losses_dir = pathlib.Path(losses_dir)
    losses: dict[str, list] = {}
    for key in keys:
        path = losses_dir / f"{key}.txt"
        # an empty file is an empty history: a run stopped before its first
        # evaluation epoch saves w1p.txt so. The JAX package reads it as [[]],
        # and its next save_losses raises (ragged rows); the port resumes
        if not path.exists() or not path.read_text().strip():
            losses[key] = []
            continue
        arr = np.loadtxt(path)
        if (arr.ndim == 1 and key in multi_value_keys) or (
            arr.ndim == 0 and key not in multi_value_keys
        ):
            arr = np.expand_dims(arr, 0)
        vals = arr.tolist()
        if key in eval_keys:
            losses[key] = vals[: start_epoch // save_epochs + 1]
        else:
            losses[key] = vals[: start_epoch + 1]
    return losses
