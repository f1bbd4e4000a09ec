"""Symmetry augmentations for point clouds (``mpgan_tpu/ops/augment.py``;
mpgan/augment.py).

Per-sample random 90-degree rotations, axis flips, translations and
log-normal scalings of the two coordinates, each mixed in with probability
``p`` (``rand_mix``, mpgan/augment.py:5-16), in the reference's order: r90,
flip, translate, scale (mpgan/augment.py:19-29). Every later feature (the
intensity of an MNIST cloud, a jet's pT and mask) is left as it is.

The functions are plain functions of tensors: they take their uniforms and
normals as arguments (:class:`AugmentDraws`, with JAX's shapes ``[B, 1, 1]``
and ``[B, 1, 2]``), so no key lives inside them. :func:`draw_augment` draws
one batch's from a threefry key as the JAX package does (``split(rng, 8)``:
children 0-1 for r90, 2-3 flip, 4-5 translate, 6-7 scale), through the plan
rows of :func:`augment_rows`; a test can hand over other draws instead.

The JAX package builds each transform as a 3-column factor, so it raises on a
cloud with a fourth feature (the mask column of every masked jet card); here
the transform touches the first two columns only, which is the same function
on 3-feature clouds (ROADMAP.md Queue 3).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from . import prng

Pair = tuple[torch.Tensor, torch.Tensor]  # (mix uniforms [B,1,1], the transform's draws)


@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    aug_t: bool = False
    aug_f: bool = False
    aug_r90: bool = False
    aug_s: bool = False
    translate_ratio: float = 0.125
    scale_sd: float = 0.125

    @property
    def any(self) -> bool:
        return self.aug_t or self.aug_f or self.aug_r90 or self.aug_s


@dataclasses.dataclass
class AugmentDraws:
    """One batch's draws, per enabled transform: the mix uniforms ``[B,1,1]``
    and the transform's own (r90: uniforms ``[B,1,1]``; flip and translate:
    uniforms ``[B,1,2]``; scale: normals ``[B,1,1]``)."""

    r90: Pair | None = None
    flip: Pair | None = None
    translate: Pair | None = None
    scale: Pair | None = None


def augment_rows(cfg: AugmentConfig, path: tuple, batch_size: int) -> list[prng.Row]:
    """The enabled transforms' draws below the key at ``path``, in the reference's
    order: each a mix uniform ``[B,1,1]`` and its own draw from children ``2t``
    and ``2t + 1`` of the key (``mpgan_tpu/ops/augment.py:33-75``)."""
    b, path, rows = batch_size, tuple(path), []
    for t, (on, shape) in enumerate(((cfg.aug_r90, (b, 1, 1)), (cfg.aug_f, (b, 1, 2)),
                                     (cfg.aug_t, (b, 1, 2)), (cfg.aug_s, (b, 1, 1)))):
        if on:
            own = prng.Row("normal", shape, path + (2 * t + 1,), 1.0) if t == 3 else \
                prng.Row("uniform", shape, path + (2 * t + 1,))
            rows += [prng.Row("uniform", (b, 1, 1), path + (2 * t,)), own]
    return rows


def augment_from(cfg: AugmentConfig, draws: list[torch.Tensor]) -> AugmentDraws:
    """:class:`AugmentDraws` from :func:`augment_rows`' draws."""
    it = iter(draws)
    out = AugmentDraws()
    for name, on in (("r90", cfg.aug_r90), ("flip", cfg.aug_f), ("translate", cfg.aug_t),
                     ("scale", cfg.aug_s)):
        if on:
            setattr(out, name, (next(it), next(it)))
    return out


def draw_augment(cfg: AugmentConfig, key: torch.Tensor, batch_size: int) -> AugmentDraws:
    """The draws of the enabled transforms from ``key``, on its device."""
    rows = augment_rows(cfg, (), batch_size)
    return augment_from(cfg, prng.draw(key, rows) if rows else [])


def _xy(x: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """``x`` with its first two features replaced by ``xy``."""
    return torch.cat([xy, x[..., 2:]], dim=-1)


def _rand_mix(u: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor, p: float) -> torch.Tensor:
    return torch.where(u < p, x2, x1)


def _rand_flip(u: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return _xy(x, x[..., :2] * (torch.round(u) * 2 - 1))


def _rand_90_rotation(u: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    angle = torch.floor(u * 4) * (math.pi / 2)  # [B, 1, 1]
    sin, cos = torch.sin(angle), torch.cos(angle)
    px, py = x[..., :1], x[..., 1:2]
    return _xy(x, torch.cat([cos * px - sin * py, sin * px + cos * py], dim=-1))


def _rand_translate(u: torch.Tensor, x: torch.Tensor, ratio: float) -> torch.Tensor:
    return _xy(x, x[..., :2] + (u - 0.5) * ratio)


def _rand_scale(z: torch.Tensor, x: torch.Tensor, sd: float) -> torch.Tensor:
    return _xy(x, x[..., :2] * torch.exp(z * sd))


def augment(cfg: AugmentConfig, x: torch.Tensor, p: float, draws: AugmentDraws) -> torch.Tensor:
    """Apply the enabled transforms in the reference's order (r90, flip,
    translate, scale), each mixed in with probability ``p``."""
    if cfg.aug_r90:
        mix, u = draws.r90
        x = _rand_mix(mix, x, _rand_90_rotation(u, x), p)
    if cfg.aug_f:
        mix, u = draws.flip
        x = _rand_mix(mix, x, _rand_flip(u, x), p)
    if cfg.aug_t:
        mix, u = draws.translate
        x = _rand_mix(mix, x, _rand_translate(u, x, cfg.translate_ratio), p)
    if cfg.aug_s:
        mix, z = draws.scale
        x = _rand_mix(mix, x, _rand_scale(z, x, cfg.scale_sd), p)
    return x
