"""GAN losses (``mpgan_tpu/training/losses.py``; train.py:286-476): og (BCE),
ls (MSE, the default), w and hinge, with optional label smoothing, label
flipping and the WGAN-GP gradient penalty.

As in the JAX package, targets are ``[B, 1]``: the reference draws ``[B]``
targets against ``[B, 1]`` outputs under label smoothing (train.py:354-358),
which broadcasts to ``[B, B]`` inside its loss; that quirk is not reproduced.
Random draws (smoothed targets, flips, the GP interpolation weight) come from
the caller's ``torch.Generator`` on the CPU; the train step copies them to the
device.
"""

from __future__ import annotations

from typing import Callable

import torch


def _bce(outputs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    eps = 1e-12
    outputs = outputs.clamp(eps, 1.0 - eps)
    return -torch.mean(targets * torch.log(outputs) + (1 - targets) * torch.log(1 - outputs))


def _mse(outputs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    return torch.mean((outputs - targets) ** 2)


def d_targets(generator: torch.Generator | None, batch_size: int, label_smoothing: bool,
              label_noise: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Real/fake targets ``[B, 1]``: 1 and 0, or with smoothing U(0.7, 1.2) and
    U(0, 0.3), then flipped with probability ``label_noise`` (train.py:352-363)."""
    y_real = torch.ones(batch_size, 1)
    y_fake = torch.zeros(batch_size, 1)
    if label_smoothing:
        y_real = 0.7 + 0.5 * torch.rand(batch_size, 1, generator=generator)
        y_fake = 0.3 * torch.rand(batch_size, 1, generator=generator)
    if label_noise:
        flip_r = torch.rand(batch_size, 1, generator=generator) < label_noise
        flip_f = torch.rand(batch_size, 1, generator=generator) < label_noise
        y_real = torch.where(flip_r, torch.zeros(()), y_real)
        y_fake = torch.where(flip_f, torch.ones(()), y_fake)
    return y_real, y_fake


def d_loss(loss: str, real_outputs: torch.Tensor, fake_outputs: torch.Tensor,
           targets: tuple[torch.Tensor, torch.Tensor] | None = None
           ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Discriminator loss (train.py:331-395); returns ``(total, {Dr, Df, D})``.
    ``targets`` are ``d_targets``'s; None means plain 1 and 0."""
    if loss in ("og", "ls"):
        if targets is None:
            targets = (torch.ones_like(real_outputs), torch.zeros_like(fake_outputs))
        fn = _bce if loss == "og" else _mse
        d_real = fn(real_outputs, targets[0])
        d_fake = fn(fake_outputs, targets[1])
    elif loss == "w":
        d_real = -torch.mean(real_outputs)
        d_fake = torch.mean(fake_outputs)
    elif loss == "hinge":
        d_real = torch.mean(torch.relu(1.0 - real_outputs))
        d_fake = torch.mean(torch.relu(1.0 + fake_outputs))
    else:
        raise ValueError(f"unknown loss {loss!r}")
    total = d_real + d_fake
    return total, {"Dr": d_real, "Df": d_fake, "D": total}


def g_loss(loss: str, fake_outputs: torch.Tensor) -> torch.Tensor:
    """Generator loss (train.py:465-476)."""
    if loss == "og":
        return _bce(fake_outputs, torch.ones_like(fake_outputs))
    if loss == "ls":
        return _mse(fake_outputs, torch.ones_like(fake_outputs))
    if loss in ("w", "hinge"):
        return -torch.mean(fake_outputs)
    raise ValueError(f"unknown loss {loss!r}")


def gradient_penalty(d_fn: Callable[[torch.Tensor], torch.Tensor], alpha: torch.Tensor,
                     real_data: torch.Tensor, gen_data: torch.Tensor,
                     gp_lambda: float) -> torch.Tensor:
    """WGAN-GP penalty (train.py:286-324) at ``alpha * real + (1 - alpha) *
    fake``, ``alpha`` ``[B, 1, 1]`` (``[B, 1]`` for latent data). The input
    gradient is taken with ``create_graph=True``, so the penalty's own backward
    is a double backward through ``d_fn``."""
    interpolated = alpha * real_data + (1 - alpha) * gen_data
    if not interpolated.requires_grad:
        interpolated.requires_grad_(True)
    (grads,) = torch.autograd.grad(d_fn(interpolated).sum(), interpolated, create_graph=True)
    grads = grads.reshape(grads.shape[0], -1)
    grad_norm = torch.sqrt(torch.sum(grads**2, dim=1) + 1e-12)
    return gp_lambda * torch.mean((grad_norm - 1.0) ** 2)


def gp_alpha(generator: torch.Generator | None, like: torch.Tensor) -> torch.Tensor:
    """The per-sample interpolation weight U(0, 1), shaped ``[B, 1, ...]`` like ``like``."""
    shape = (like.shape[0],) + (1,) * (like.dim() - 1)
    return torch.rand(shape, generator=generator, dtype=like.dtype)
