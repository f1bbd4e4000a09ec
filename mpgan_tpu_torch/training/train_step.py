"""The GAN train step: the D update and the G update (``mpgan_tpu/training/train_step.py``;
the reference's ``train_D`` / ``train_G``, train.py:398-523).

Kept from the reference, as the JAX package keeps them:

- during the D step the generator runs in eval mode (``G.eval()``,
  train.py:421): no dropout, but its spectral-norm vectors still advance;
- during the G step the discriminator stays in train mode (the reference never
  calls ``D.eval()`` in ``train_G``), so D's dropout is on and its
  spectral-norm vectors advance;
- with augmentation (``--aug-*``, each transform mixed in with probability
  ``aug_prob``) the real pass runs on unaugmented data (train.py:425), the
  fake pass on augmented fakes, the gradient penalty interpolates between the
  augmented real and the augmented fake batch, and the G step augments G's
  output before D (train.py:439-442, 509-511); ``--adaptive-prob`` is
  ignored, as in the JAX package;
- with ``gp_lambda`` the WGAN-GP penalty differentiates through a third D
  forward on interpolated samples (a double backward).

The G step differentiates through D with respect to D's *input* only. D's
parameters have ``requires_grad`` off for that pass, so the edge kernel's
backward (K3) runs without its weight contractions: the counterpart of the
JAX package's ``skip_weight_grads``.

With ``encode_real`` (PCGAN's pre-trained encoder) the D step maps the real
batch into the training representation before D sees it (the JAX package's
``train_step.py:185-186``), without gradients. A model with ``reads_epoch``
(the legacy MPGAN) takes the model epoch, ``epoch=``, in both steps.

Every random draw of a step (noise, smoothed targets, the GP weight, the
augmentation's uniforms and normals, the dropout key words and in-kernel
seeds) comes from ``TrainState.generator``, a
CPU ``torch.Generator``, in a fixed order. A test can pass the draws instead
(``DDraws``/``GDraws``), for example the JAX package's own.

Not ported here (each raises ``NotImplementedError``): bf16 training, the
batched real+fake D pass and data-parallel steps (ROADMAP.md Queue 1,
train-step leftovers and multi-device).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from ..ops.augment import AugmentConfig, AugmentDraws, augment, draw_augment
from ..ops.keys import GeneratorKeys
from .losses import d_loss, d_targets, g_loss, gp_alpha, gradient_penalty
from .sampling import NoiseSpec


@dataclasses.dataclass
class TrainState:
    g: torch.nn.Module
    d: torch.nn.Module
    g_opt: torch.optim.Optimizer
    d_opt: torch.optim.Optimizer
    generator: torch.Generator  # CPU; every draw of the step


@dataclasses.dataclass(frozen=True)
class StepConfig:
    loss: str = "ls"
    gp_lambda: float = 0.0
    label_smoothing: bool = False
    label_noise: float = 0.0
    augment: AugmentConfig | None = None
    aug_prob: float = 1.0
    bf16: bool = False
    batched_d: bool = False

    def __post_init__(self):
        refused = [k for k in ("bf16", "batched_d") if getattr(self, k)]
        if refused:
            raise NotImplementedError(
                f"{', '.join(refused)} in the train step: not ported yet, ROADMAP.md Queue 1, "
                "train-step leftovers"
            )


def step_config(args: Any) -> StepConfig:
    """The step config of processed args (the loss, the GP, the targets' noise,
    ``--aug-*`` and ``aug_prob``; ``augment`` None where no transform is on), as
    the training loop builds it."""
    augment = AugmentConfig(aug_t=args.aug_t, aug_f=args.aug_f, aug_r90=args.aug_r90,
                            aug_s=args.aug_s, translate_ratio=args.translate_ratio,
                            scale_sd=args.scale_sd)
    return StepConfig(
        loss=args.loss, gp_lambda=args.gp, label_smoothing=args.label_smoothing,
        label_noise=args.label_noise, augment=augment if augment.any else None,
        aug_prob=args.aug_prob,
    )


@dataclasses.dataclass
class DDraws:
    """The draws of one D step: G's noise, the dropout keys of the real and the
    fake pass, the loss targets (None: plain 1 and 0), the GP's keys and
    interpolation weight, and the augmentation's of the real and the fake batch."""

    noise: torch.Tensor
    real: Any
    fake: Any
    targets: tuple[torch.Tensor, torch.Tensor] | None = None
    gp: Any = None
    gp_alpha: torch.Tensor | None = None
    aug_real: AugmentDraws | None = None
    aug_fake: AugmentDraws | None = None


@dataclasses.dataclass
class GDraws:
    """The draws of one G step: the noise, the dropout keys of G and of D, and
    the augmentation's of G's output."""

    noise: torch.Tensor
    g: Any
    d: Any
    aug: AugmentDraws | None = None


def to_device(t: torch.Tensor, device) -> torch.Tensor:
    """Copy a host draw to ``device`` without making the host wait for the
    device's queue (a pageable copy would drain it every step)."""
    device = torch.device(device)
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def draw_d(state: TrainState, cfg: StepConfig, spec: NoiseSpec, data: torch.Tensor) -> DDraws:
    gen = state.generator
    b = data.shape[0]
    noise = to_device(spec.sample(gen, b, "cpu"), data.device)
    targets = None
    if cfg.loss in ("og", "ls") and (cfg.label_smoothing or cfg.label_noise):
        targets = tuple(to_device(t, data.device)
                        for t in d_targets(gen, b, cfg.label_smoothing, cfg.label_noise))
    alpha = to_device(gp_alpha(gen, data), data.device) if cfg.gp_lambda else None
    aug_real = aug_fake = None
    if cfg.augment is not None:
        aug_real, aug_fake = (draw_augment(cfg.augment, gen, b).map(
            lambda t: to_device(t, data.device)) for _ in range(2))
    keys = GeneratorKeys(gen)
    return DDraws(noise, keys, keys, targets, keys, alpha, aug_real, aug_fake)


def draw_g(state: TrainState, cfg: StepConfig, spec: NoiseSpec, batch_size: int,
           device) -> GDraws:
    gen = state.generator
    noise = to_device(spec.sample(gen, batch_size, "cpu"), device)
    aug = None
    if cfg.augment is not None:
        aug = draw_augment(cfg.augment, gen, batch_size).map(lambda t: to_device(t, device))
    keys = GeneratorKeys(gen)
    return GDraws(noise, keys, keys, aug)


def _maybe_aug(cfg: StepConfig, x: torch.Tensor, draws: AugmentDraws | None) -> torch.Tensor:
    return x if cfg.augment is None else augment(cfg.augment, x, cfg.aug_prob, draws)


PostGen = Callable[[torch.Tensor], torch.Tensor]


def epoch_kwargs(module: torch.nn.Module, epoch: int) -> dict[str, int]:
    """``{"epoch": epoch}`` for a module that reads the model epoch, else ``{}``."""
    return {"epoch": epoch} if getattr(module, "reads_epoch", False) else {}


def d_step(state: TrainState, cfg: StepConfig, spec: NoiseSpec, data: torch.Tensor,
           labels: torch.Tensor | None = None, draws: DDraws | None = None,
           post_gen: PostGen | None = None, encode_real: PostGen | None = None,
           epoch: int = 0) -> dict[str, torch.Tensor]:
    """One D update; returns the loss parts ``{Dr, Df, D(, gp)}`` as device scalars.
    ``post_gen`` is applied to G's output (the ``--mask-manual`` hook, train.py:208-210),
    ``encode_real`` to the real batch."""
    if encode_real is not None:
        with torch.no_grad():
            data = encode_real(data)
    draws = draws if draws is not None else draw_d(state, cfg, spec, data)
    g, d = state.g, state.d
    g_kw, d_kw = epoch_kwargs(g, epoch), epoch_kwargs(d, epoch)
    with torch.no_grad():
        # fresh fake batch, G in eval mode with spectral norm advancing (train.py:421,428)
        fake = g(draws.noise, labels, train=False, **g_kw)
        if post_gen is not None:
            fake = post_gen(fake)
        fake = _maybe_aug(cfg, fake, draws.aug_fake)
    real_out = d(data, labels, train=True, rng=draws.real, **d_kw)  # unaugmented (train.py:425)
    fake_out = d(fake, labels, train=True, rng=draws.fake, **d_kw)
    total, parts = d_loss(cfg.loss, real_out, fake_out, draws.targets)
    if cfg.gp_lambda:
        gp = gradient_penalty(lambda x: d(x, labels, train=True, rng=draws.gp, **d_kw),
                              draws.gp_alpha, _maybe_aug(cfg, data, draws.aug_real), fake,
                              cfg.gp_lambda)
        parts = dict(parts, gp=gp)
        total = total + gp
    state.d_opt.zero_grad(set_to_none=True)
    total.backward()
    state.d_opt.step()
    return {k: v.detach() for k, v in parts.items()}


def g_step(state: TrainState, cfg: StepConfig, spec: NoiseSpec, data: torch.Tensor,
           labels: torch.Tensor | None = None, draws: GDraws | None = None,
           post_gen: PostGen | None = None, epoch: int = 0) -> dict[str, torch.Tensor]:
    """One G update (``data`` only sets the batch size, train.py:497); returns ``{G}``.
    ``post_gen`` and ``epoch`` as in :func:`d_step`."""
    batch_size = labels.shape[0] if labels is not None else data.shape[0]
    draws = draws if draws is not None else draw_g(state, cfg, spec, batch_size, data.device)
    g, d = state.g, state.d
    fake = g(draws.noise, labels, train=True, rng=draws.g, **epoch_kwargs(g, epoch))
    if post_gen is not None:
        fake = post_gen(fake)
    fake = _maybe_aug(cfg, fake, draws.aug)
    # D in train mode; only its input gradient is used, so its parameters stay
    # out of the graph and the edge kernel's backward skips the weight contractions
    flags = [p.requires_grad for p in d.parameters()]
    d.requires_grad_(False)
    try:
        fake_out = d(fake, labels, train=True, rng=draws.d, **epoch_kwargs(d, epoch))
    finally:
        for p, flag in zip(d.parameters(), flags):
            p.requires_grad_(flag)
    loss = g_loss(cfg.loss, fake_out)
    state.g_opt.zero_grad(set_to_none=True)
    loss.backward()
    state.g_opt.step()
    return {"G": loss.detach()}
