"""Noise sampling and jet generation (``mpgan_tpu/training/sampling.py``, train.py:100-282).

The MPGAN and GAPT noise shapes follow ``get_gen_noise`` (train.py:116-141);
the other model families come with their ports. All randomness comes from an explicit
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

    def sample(
        self, generator: torch.Generator, num_samples: int, device: torch.device | str
    ) -> torch.Tensor:
        return torch.randn(
            (num_samples,) + self.shape, generator=generator, device=device
        ) * self.std


def noise_spec(model: str, model_args: dict[str, Any], num_particles: int,
               noise_std: float = 0.2) -> NoiseSpec:
    """Mirror of get_gen_noise's shape logic (train.py:116-141). MPGAN:
    ``[N(+1 if mask_learn_sep), latent_node_size]`` or ``[lfc_latent_size]``;
    GAPT: ``[N, embed_dim]``."""
    if model == "gapt":
        return NoiseSpec((num_particles, model_args["embed_dim"]), noise_std)
    if model != "mpgan":
        raise ValueError(f"noise for model {model!r} is not ported yet (ROADMAP.md Queue 1)")
    if model_args.get("lfc"):
        return NoiseSpec((model_args["lfc_latent_size"],), noise_std)
    extra = int(bool(model_args.get("mask_learn_sep")))
    return NoiseSpec((num_particles + extra, model_args["latent_node_size"]), noise_std)


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
    post_fn: Callable[[torch.Tensor], torch.Tensor] | None = None,
) -> np.ndarray:
    """Batched generation (train.py:226-282): fixed-size batches, the last one
    over-generated and truncated. ``post_fn`` is applied to each batch's
    output (the ``--mask-manual`` hook). Outputs stay on the device and reach
    the host in one copy at the end. Sharding over several devices (``mesh``)
    comes with DDP."""
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
            out = g(spec.sample(generator, batch_size, device), batch_labels, update_sn=False)
            outs.append(out if post_fn is None else post_fn(out))
        out = torch.cat(outs, dim=0)[:num_samples]
    return out.cpu().numpy()
