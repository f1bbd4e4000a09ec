"""Optimizers (``mpgan_tpu/training/optimizers.py``; setup_training.py:1500-1539).

The reference uses ``torch.optim`` directly; the JAX package re-derives the
same update rules as optax transformations. The port builds the torch
optimizers with the reference's settings:

- RMSprop (the default): alpha 0.99, eps 1e-8, no momentum, not centered;
- Adadelta: rho 0.9, eps 1e-6;
- Adam with L2 weight decay 5e-4 coupled into the gradient (not AdamW),
  eps 1e-8.

The per-parameter state (``square_avg``; ``exp_avg``/``exp_avg_sq`` and
``step``; ``square_avg``/``acc_delta``) maps one to one onto the JAX states'
leaves (``RMSPropState.sq_avg``, ``AdamState(count, mu, nu)``,
``AdadeltaState(sq_avg, acc_delta)``): see ``training/checkpoint.py``.

On a GPU each is built with ``capturable=True`` (its step counter on the
device, no host sync in ``step()``), so that a CUDA graph can capture the
update; the eager loop on the GPU takes the same optimizers, so the two give
the same parameters. Capturable Adam folds its bias corrections otherwise
than the default, so its updates differ from a CPU run's in the last bits.
"""

from __future__ import annotations

from typing import Iterable

import torch


def build_optimizer(
    name: str,
    params: Iterable[torch.nn.Parameter],
    lr: float,
    *,
    beta1: float = 0.9,
    beta2: float = 0.999,
    weight_decay: float = 5e-4,
) -> torch.optim.Optimizer:
    """Optimizer factory mirroring setup_training.optimizers
    (setup_training.py:1511-1523; the Adam branch always uses wd=5e-4),
    capturable where the parameters lie on a GPU."""
    params = list(params)
    capturable = bool(params) and params[0].is_cuda
    if name == "rmsprop":
        return torch.optim.RMSprop(params, lr=lr, alpha=0.99, eps=1e-8, capturable=capturable)
    if name == "adadelta":
        return torch.optim.Adadelta(params, lr=lr, rho=0.9, eps=1e-6, capturable=capturable)
    if name in ("adam", "None"):
        return torch.optim.Adam(params, lr=lr, betas=(beta1, beta2), eps=1e-8,
                                weight_decay=weight_decay, capturable=capturable)
    raise ValueError(f"unknown optimizer {name!r}")


def state_names(opt: torch.optim.Optimizer) -> tuple[str, ...]:
    """The per-parameter state tensors, in the JAX state's leaf order
    (``step`` stands for Adam's shared ``count``)."""
    if isinstance(opt, torch.optim.RMSprop):
        return ("square_avg",)
    if isinstance(opt, torch.optim.Adadelta):
        return ("square_avg", "acc_delta")
    if isinstance(opt, torch.optim.Adam):
        return ("step", "exp_avg", "exp_avg_sq")
    raise TypeError(f"no JAX state layout for {type(opt).__name__}")
