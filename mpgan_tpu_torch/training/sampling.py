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

``generate_multi_batch`` runs G's forward on static buffers, one batch at a
time; on a GPU it captures that forward into a CUDA graph and replays it a
batch, and keeps the graph for later calls (the counterpart of the JAX
sampler's one-dispatch ``lax.scan`` and its ``_SAMPLER_CACHE``).
On a mesh every rank draws each batch's whole noise and runs G on its own
rows of it; the ranks' rows are gathered at the end, so the output is the
single-device output (``mpgan_tpu/training/sampling.py:105-146``).
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Any, Callable

import numpy as np
import torch

from ..ops.mp import knn_route
from ..ops.mp_kernels import CountedGraph, graph_pool, warm_up


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


def route_key(*modules: torch.nn.Module) -> tuple:
    """What a captured forward of ``modules`` depends on besides its inputs
    and the values of its weights: each module's config (``use_kernels``
    among it), the knn kernel route, which the layers read from the
    environment at call time, and where the parameters and buffers lie (a
    graph reads them in place; ``.to()`` or an assigning load moves them)."""
    return (tuple(repr(getattr(m, "cfg", None)) for m in modules) + knn_route()
            + tuple(t.data_ptr() for m in modules for t in (*m.parameters(), *m.buffers())))


PostFn = Callable[[torch.Tensor, torch.Tensor | None], torch.Tensor]

# kept samplers: generator module -> {key: _StaticSampler}
_SAMPLERS: "weakref.WeakKeyDictionary[torch.nn.Module, dict]" = weakref.WeakKeyDictionary()


def drop_samplers(g: torch.nn.Module) -> None:
    """Forget the samplers (and their CUDA graphs) kept for ``g``."""
    _SAMPLERS.pop(g, None)


class _StaticSampler:
    """G's forward on one batch on static buffers: the noise, PCGAN's point
    noise and the labels are written into them before each run. On a GPU the
    first run is ordinary, on a side stream, and the second captures the
    forward into a CUDA graph that every later run replays; on the CPU every
    run is ordinary. The noise is the whole batch's, G runs on its ``rows``."""

    def __init__(self, g, spec: NoiseSpec, batch_size: int, labels: torch.Tensor | None,
                 post_fn: PostFn | None, g_kwargs: dict, device: torch.device,
                 rows: slice = slice(None)):
        self.device, self.spec = device, spec
        self.noise = torch.empty((batch_size,) + spec.shape, device=device)
        self.points = None
        if post_fn is not None and spec.point_shape is not None:
            self.points = torch.empty((batch_size,) + spec.point_shape, device=device)
        self.labels = None if labels is None else torch.empty(
            (len(range(batch_size)[rows]),) + tuple(labels.shape[1:]), dtype=labels.dtype,
            device=device)
        self.capture = device.type == "cuda"
        self.graph: CountedGraph | None = None
        self.runs = 0
        g_ref = weakref.ref(g)  # the cache is keyed on g: no reference back to it

        def forward():
            out = g_ref()(self.noise[rows] * spec.std, self.labels, update_sn=False, **g_kwargs)
            return out if post_fn is None else post_fn(
                out, None if self.points is None else self.points[rows])
        self._forward = forward

    def __call__(self, generator: torch.Generator, labels: torch.Tensor | None) -> torch.Tensor:
        # the eager loop's draws, in its order: the noise, then the point noise
        torch.randn(self.noise.shape, generator=generator, device=self.device, out=self.noise)
        if self.points is not None:
            torch.randn(self.points.shape, generator=generator, device=self.device,
                        out=self.points)
        if self.labels is not None:
            self.labels.copy_(labels)
        self.runs += 1
        if not self.capture:
            return self._forward()
        if self.graph is None and self.runs == 1:
            return warm_up(self._forward, self.device)
        if self.graph is None:
            self.graph = CountedGraph(self._forward, pool=graph_pool())
            self._forward = None
        self.graph.replay()
        return self.graph.out


def generate_multi_batch(
    g: torch.nn.Module,
    spec: NoiseSpec,
    generator: torch.Generator,
    num_samples: int,
    batch_size: int,
    labels: np.ndarray | None = None,
    mesh=None,
    post_fn: PostFn | None = None,
    static: bool = True,
    **g_kwargs: Any,
) -> np.ndarray:
    """Batched generation (train.py:226-282): fixed-size batches, the last one
    over-generated and truncated. ``post_fn(out, point_noise)`` is applied to
    each batch's output (the ``--mask-manual`` hook, PCGAN's point decoder);
    ``point_noise`` is drawn after each batch's noise when ``spec`` has a
    ``point_shape`` and ``post_fn`` is given, else None. ``g_kwargs`` go to
    every generator call (``epoch=`` for the legacy model). Outputs stay on
    the device and reach the host in one copy at the end.

    With ``mesh`` (a :class:`..parallel.mesh.Mesh`) every rank draws each
    batch's noise (and point noise) whole from ``generator``, as one device
    does, runs G on its ``batch_size / M`` rows and gets every rank's rows by
    one ``all_gather`` at the end: the single-device output on every rank. A
    batch size that ``M`` does not divide falls back to every rank generating
    the whole batch (``mpgan_tpu/training/sampling.py:179-180``).

    With ``static`` (the default) each batch runs on a kept
    :class:`_StaticSampler` (a CUDA graph's replay on a GPU), keyed as the JAX
    package keys its samplers: the generator, the batch size, ``post_fn``,
    the labels' shape or none, ``g_kwargs``, and the route (:func:`route_key`).
    The weights are read in place, so a kept graph follows training; a load
    drops it (:func:`drop_samplers`). ``static=False`` runs the eager loop, the
    reference the static path is held to bit for bit."""
    if mesh is not None and batch_size % mesh.size:
        mesh = None  # the batch does not split: every rank generates all of it
    rows = slice(None) if mesh is None else mesh.rows(batch_size)
    device = _device_of(g)
    num_batches = (num_samples + batch_size - 1) // batch_size
    labels_all = None
    if labels is not None:
        labels = np.asarray(labels)[:num_samples]
        pad = np.repeat(labels[-1:], num_batches * batch_size - len(labels), axis=0)
        labels_all = torch.as_tensor(np.concatenate([labels, pad], axis=0), device=device)
    if static:
        outs = _generate_static(g, spec, generator, batch_size, labels_all, post_fn, g_kwargs,
                                num_batches, device, rows)
    else:
        outs = []
        with torch.inference_mode():
            for i in range(num_batches):
                batch_labels = None
                if labels_all is not None:
                    batch_labels = labels_all[i * batch_size : (i + 1) * batch_size][rows]
                noise = spec.sample(generator, batch_size, device)
                out = g(noise[rows], batch_labels, update_sn=False, **g_kwargs)
                if post_fn is not None:
                    points = spec.sample_points(generator, batch_size, device)
                    out = post_fn(out, None if points is None else points[rows])
                outs.append(out)
        outs = torch.stack(outs)
    if mesh is not None:  # [batches, B/M, ...] a rank -> [batches, B, ...]
        outs = torch.cat(mesh.all_gather(outs), dim=1)
    return outs.flatten(0, 1)[:num_samples].cpu().numpy()


def _generate_static(g, spec, generator, batch_size, labels_all, post_fn, g_kwargs,
                     num_batches, device, rows) -> torch.Tensor:
    """Every batch's output rows ``rows``, ``[num_batches, rows, ...]``."""
    label_key = None if labels_all is None else (tuple(labels_all.shape[1:]), labels_all.dtype)
    key = (spec, batch_size, post_fn, label_key, tuple(sorted(g_kwargs.items())), route_key(g),
           (rows.start, rows.stop))
    with torch.inference_mode():
        kept = _SAMPLERS.setdefault(g, {})
        if key not in kept:
            kept[key] = _StaticSampler(g, spec, batch_size, labels_all, post_fn, g_kwargs,
                                       device, rows)
        sampler = kept[key]
        outs = None
        for i in range(num_batches):
            batch = slice(i * batch_size, (i + 1) * batch_size)
            out = sampler(generator, None if labels_all is None else labels_all[batch][rows])
            if outs is None:
                outs = torch.empty((num_batches,) + tuple(out.shape), dtype=out.dtype,
                                   device=out.device)
            outs[i].copy_(out)
        return outs
