"""Noise sampling and jet generation (``mpgan_tpu/training/sampling.py``, train.py:100-282).

Per-model noise shapes follow ``get_gen_noise`` (train.py:116-141):

- mpgan / old_mpgan: ``[B, N(+1 if mask_learn_sep), latent_node_size]`` or
  ``[B, lfc_latent_size]`` with lfc, scaled by ``noise_std`` (default 0.2),
- gapt: ``[B, N, embed_dim]``,
- rgan / graphcnngan: ``[B, latent_dim]``,
- treegan: ``[B, 1, treegang_features[0]]``,
- pcgan: ``[B, pcgan_latent_dim]``, and unit-std point noise ``[B, N, z2_dim]``
  for the point decoder (``point_shape``, with ``sample_points``).

All randomness comes from an explicit
``torch.Generator`` on the device the noise is drawn on. Generation runs in
eval mode under ``torch.inference_mode()`` and leaves the spectral-norm
vectors where they were (``update_sn=False``), as the JAX package discards
the advanced state there.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class NoiseSpec:
    """Static description of the generator's input noise."""

    shape: tuple[int, ...]  # per-sample shape (without batch dim)
    std: float = 0.2
    point_shape: tuple[int, ...] | None = None  # PCGAN's point-decoder noise

    def sample(
        self, generator: torch.Generator, num_samples: int, device: torch.device | str
    ) -> torch.Tensor:
        return torch.randn(
            (num_samples,) + self.shape, generator=generator, device=device
        ) * self.std

    def sample_points(
        self, generator: torch.Generator, num_samples: int, device: torch.device | str
    ) -> torch.Tensor | None:
        """Unit-std point noise ``[B, *point_shape]``, or None without ``point_shape``."""
        if self.point_shape is None:
            return None
        return torch.randn((num_samples,) + self.point_shape, generator=generator,
                           device=device)


def noise_spec(model: str, model_args: dict[str, Any], num_particles: int,
               noise_std: float = 0.2) -> NoiseSpec:
    """Mirror of get_gen_noise's shape logic (train.py:116-141)."""
    if model in ("mpgan", "old_mpgan"):
        if model_args.get("lfc"):
            return NoiseSpec((model_args["lfc_latent_size"],), noise_std)
        extra = int(bool(model_args.get("mask_learn_sep")))
        return NoiseSpec((num_particles + extra, model_args["latent_node_size"]), noise_std)
    if model == "gapt":
        return NoiseSpec((num_particles, model_args["embed_dim"]), noise_std)
    if model in ("rgan", "graphcnngan"):
        return NoiseSpec((model_args["latent_dim"],), noise_std)
    if model == "treegan":
        return NoiseSpec((1, model_args["treegang_features"][0]), noise_std)
    if model == "pcgan":
        point_shape = None
        if model_args.get("sample_points"):
            point_shape = (num_particles, model_args["pcgan_z2_dim"])
        return NoiseSpec((model_args["pcgan_latent_dim"],), noise_std, point_shape)
    raise ValueError(f"unknown model {model!r}")


def _device_of(g: torch.nn.Module) -> torch.device:
    return next(g.parameters()).device


def generate(
    g: torch.nn.Module,
    spec: NoiseSpec,
    generator: torch.Generator,
    num_samples: int,
    labels: torch.Tensor | None = None,
) -> torch.Tensor:
    """Generate ``num_samples`` clouds in one batch, on the generator's device."""
    with torch.inference_mode():
        return g(spec.sample(generator, num_samples, _device_of(g)), labels, update_sn=False)


def generate_multi_batch(
    g: torch.nn.Module,
    spec: NoiseSpec,
    generator: torch.Generator,
    num_samples: int,
    batch_size: int,
    labels: np.ndarray | None = None,
    mesh=None,
    post_fn: Callable[[torch.Tensor, torch.Tensor | None], torch.Tensor] | None = None,
    **g_kwargs: Any,
) -> np.ndarray:
    """Batched generation (train.py:226-282): fixed-size batches, the last one
    over-generated and truncated. ``post_fn(out, point_noise)`` is applied to
    each batch's output (the ``--mask-manual`` hook, PCGAN's point decoder);
    ``point_noise`` is drawn after each batch's noise when ``spec`` has a
    ``point_shape`` and ``post_fn`` is given, else None. ``g_kwargs`` go to
    every generator call (``epoch=`` for the legacy model). Outputs stay on
    the device and reach the host in one copy at the end. Sharding over
    several devices (``mesh``) comes with DDP."""
    if mesh is not None:
        raise NotImplementedError(
            "multi-device generation comes with DDP, ROADMAP.md Queue 1, multi-device"
        )
    device = _device_of(g)
    num_batches = (num_samples + batch_size - 1) // batch_size
    labels_all = None
    if labels is not None:
        labels = np.asarray(labels)[:num_samples]
        pad = np.repeat(labels[-1:], num_batches * batch_size - len(labels), axis=0)
        labels_all = torch.as_tensor(np.concatenate([labels, pad], axis=0), device=device)
    outs = []
    with torch.inference_mode():
        for i in range(num_batches):
            batch_labels = None
            if labels_all is not None:
                batch_labels = labels_all[i * batch_size : (i + 1) * batch_size]
            out = g(spec.sample(generator, batch_size, device), batch_labels, update_sn=False,
                    **g_kwargs)
            if post_fn is not None:
                out = post_fn(out, spec.sample_points(generator, batch_size, device))
            outs.append(out)
        out = torch.cat(outs, dim=0)[:num_samples]
    return out.cpu().numpy()
