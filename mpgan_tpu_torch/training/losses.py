"""GAN losses (``mpgan_tpu/training/losses.py``; train.py:286-476): og (BCE),
ls (MSE, the default), w and hinge, with optional label smoothing, label
flipping and the WGAN-GP gradient penalty.

As in the JAX package, targets are ``[B, 1]``: the reference draws ``[B]``
targets against ``[B, 1]`` outputs under label smoothing (train.py:354-358),
which broadcasts to ``[B, B]`` inside its loss; that quirk is not reproduced.
Random draws (smoothed targets, flips, the GP interpolation weight) come from
a threefry key (:mod:`..ops.prng`) in JAX's shapes and order, so a key draws
the JAX package's values: :func:`target_rows` and :func:`targets_from` split
``d_targets`` into its plan rows and the targets made from their draws, for a
step that draws every part in one plan.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..ops import prng


def _bce(outputs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    eps = 1e-12
    outputs = outputs.clamp(eps, 1.0 - eps)
    return -torch.mean(targets * torch.log(outputs) + (1 - targets) * torch.log(1 - outputs))


def _mse(outputs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    return torch.mean((outputs - targets) ** 2)


def target_rows(path: tuple, batch_size: int, label_smoothing: bool,
                label_noise: float) -> list[prng.Row]:
    """``d_targets``' draws below the key at ``path``: with smoothing U(0.7, 1.2)
    and U(0, 0.3) ``[B, 1]`` from children 0 and 1, with label noise two
    uniforms from children 0 and 1 of child 2 (of the key itself without
    smoothing), as ``mpgan_tpu/training/losses.py:43-49`` splits."""
    rows, rng = [], tuple(path)
    if label_smoothing:
        rows += [prng.Row("uniform", (batch_size, 1), rng + (0,), 0.7, 1.2),
                 prng.Row("uniform", (batch_size, 1), rng + (1,), 0.0, 0.3)]
        rng = rng + (2,)
    if label_noise:
        rows += [prng.Row("uniform", (batch_size, 1), rng + (i,)) for i in (0, 1)]
    return rows


def targets_from(draws: list[torch.Tensor], batch_size: int, label_smoothing: bool,
                 label_noise: float, device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """The targets ``[B, 1]`` from :func:`target_rows`' draws: 1 and 0, or the
    smoothed uniforms, then flipped where the flip uniforms fall below
    ``label_noise`` (train.py:352-363)."""
    device = draws[0].device if draws else device
    y_real = torch.ones(batch_size, 1, device=device)
    y_fake = torch.zeros(batch_size, 1, device=device)
    draws = list(draws)
    if label_smoothing:
        y_real, y_fake = draws.pop(0), draws.pop(0)
    if label_noise:
        flip_r, flip_f = draws
        y_real = torch.where(flip_r < label_noise, torch.zeros((), device=device), y_real)
        y_fake = torch.where(flip_f < label_noise, torch.ones((), device=device), y_fake)
    return y_real, y_fake


def d_targets(key: torch.Tensor | None, batch_size: int, label_smoothing: bool,
              label_noise: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Real/fake targets ``[B, 1]`` drawn from ``key`` (unused without smoothing
    and noise): 1 and 0, or with smoothing U(0.7, 1.2) and U(0, 0.3), then
    flipped with probability ``label_noise`` (train.py:352-363), on the key's device."""
    rows = target_rows((), batch_size, label_smoothing, label_noise)
    draws = prng.draw(key, rows) if rows else []
    return targets_from(draws, batch_size, label_smoothing, label_noise,
                        None if key is None else key.device)


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


def alpha_shape(like_shape: tuple) -> tuple:
    """The GP weight's shape for a real batch shaped ``like_shape``: ``[B, 1, ...]``."""
    return (like_shape[0],) + (1,) * (len(like_shape) - 1)


def gp_alpha(key: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """The per-sample interpolation weight U(0, 1) from ``key``, shaped ``[B, 1, ...]``
    like ``like`` (``mpgan_tpu/training/losses.py:108``)."""
    return prng.uniform(key.to(like.device), alpha_shape(tuple(like.shape)))
