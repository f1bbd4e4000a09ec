"""Noise sampling and jet generation (``mpgan_tpu/training/sampling.py``, train.py:100-282).

Per-model noise shapes follow ``get_gen_noise`` (train.py:116-141):

- mpgan / old_mpgan: ``[B, N(+1 if mask_learn_sep), latent_node_size]`` or
  ``[B, lfc_latent_size]`` with lfc, scaled by ``noise_std`` (default 0.2),
- gapt: ``[B, N, embed_dim]``,
- rgan / graphcnngan: ``[B, latent_dim]``,
- treegan: ``[B, 1, treegang_features[0]]``,
- pcgan: ``[B, pcgan_latent_dim]``, and unit-std point noise ``[B, N, z2_dim]``
  for the point decoder (``point_shape``, with ``sample_points``).

All randomness comes from a threefry key (:mod:`..ops.prng`, a uint32 ``[2]``
tensor), drawn as the JAX package draws: ``sample`` splits its key into two and
draws the noise from the first child and PCGAN's point noise from the second;
batch ``i`` of ``generate_multi_batch`` samples from ``split(key, nb)[i]``, which
is child ``i`` of the key whatever ``nb`` is. Generation runs in
eval mode under ``torch.inference_mode()`` and leaves the spectral-norm
vectors where they were (``update_sn=False``), as the JAX package discards
the advanced state there.

``generate_multi_batch`` runs G's forward on static buffers, one batch at a
time: the batch's noise is drawn on the device by one ``threefry_draws`` launch
from the call's key at a device batch counter, which the launch advances; on a
GPU it captures the draw and the forward into a CUDA graph and replays it a
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

from ..ops import prng
from ..ops.mp import knn_route
from ..ops.mp_kernels import CountedGraph, graph_pool, warm_up


@dataclasses.dataclass(frozen=True)
class NoiseSpec:
    """Static description of the generator's input noise."""

    shape: tuple[int, ...]  # per-sample shape (without batch dim)
    std: float = 0.2
    point_shape: tuple[int, ...] | None = None  # PCGAN's point-decoder noise

    def rows(self, num_samples: int, path: tuple = (), points: bool = False) -> list[prng.Row]:
        """The plan rows of :meth:`sample` (and, with ``points``, :meth:`sample_points`)
        from the key at ``path``: the noise from its child 0, times ``std``, the
        point noise from child 1 (``mpgan_tpu/training/sampling.py:37-41``)."""
        rows = [prng.Row("normal", (num_samples,) + self.shape, tuple(path) + (0,), self.std)]
        if points and self.point_shape is not None:
            rows.append(prng.Row("normal", (num_samples,) + self.point_shape,
                                 tuple(path) + (1,), 1.0))
        return rows

    def sample(self, key: torch.Tensor, num_samples: int,
               device: torch.device | str | None = None) -> torch.Tensor:
        """The noise ``[B, *shape]`` of ``key`` on ``device`` (the key's by default)."""
        key = key if device is None else key.to(device)
        return prng.draw(key, self.rows(num_samples))[0]

    def sample_points(self, key: torch.Tensor, num_samples: int,
                      device: torch.device | str | None = None) -> torch.Tensor | None:
        """Unit-std point noise ``[B, *point_shape]`` of ``key``, or None without
        ``point_shape``."""
        if self.point_shape is None:
            return None
        key = key if device is None else key.to(device)
        return prng.draw(key, self.rows(num_samples, points=True)[1:])[0]


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
    key: torch.Tensor,
    num_samples: int,
    labels: torch.Tensor | None = None,
) -> torch.Tensor:
    """Generate ``num_samples`` clouds in one batch from ``key``, on the generator's device."""
    with torch.inference_mode():
        return g(spec.sample(key, num_samples, _device_of(g)), labels, update_sn=False)


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
    """G's forward on one batch on static buffers. Each run draws the batch's
    noise (and PCGAN's point noise) from :attr:`key` at the batch counter
    :attr:`counter` into them (one ``threefry_draws`` launch, which adds one to
    the counter), and the labels are copied into theirs. On a GPU the first run
    is ordinary, on a side stream, and the second captures the draw and the
    forward into a CUDA graph that every later run replays; on the CPU every
    run is ordinary. The noise is the whole batch's, G runs on its ``rows``."""

    def __init__(self, g, spec: NoiseSpec, batch_size: int, labels: torch.Tensor | None,
                 post_fn: PostFn | None, g_kwargs: dict, device: torch.device,
                 rows: slice = slice(None)):
        self.device, self.spec = device, spec
        self.plan = prng.Plan(spec.rows(batch_size, (prng.COUNTER,), points=post_fn is not None),
                              device)
        self.buffer = torch.empty(self.plan.words, dtype=torch.int32, device=device)
        views = self.plan.views(self.buffer)
        self.noise, self.points = views[0], views[1] if len(views) > 1 else None
        self.key = torch.zeros(2, dtype=torch.uint32, device=device)
        self.counter = torch.zeros(1, dtype=torch.int32, device=device)
        self.labels = None if labels is None else torch.empty(
            (len(range(batch_size)[rows]),) + tuple(labels.shape[1:]), dtype=labels.dtype,
            device=device)
        self.capture = device.type == "cuda"
        self.graph: CountedGraph | None = None
        self.runs = 0
        g_ref = weakref.ref(g)  # the cache is keyed on g: no reference back to it

        def forward():
            self.plan.run(self.key, self.buffer, self.counter, bump=True)
            out = g_ref()(self.noise[rows], self.labels, update_sn=False, **g_kwargs)
            return out if post_fn is None else post_fn(
                out, None if self.points is None else self.points[rows])
        self._forward = forward

    def start(self, key: torch.Tensor) -> None:
        """Draw the next batches from ``key``, from batch 0 on."""
        self.key.copy_(key)
        self.counter.zero_()

    def __call__(self, labels: torch.Tensor | None) -> torch.Tensor:
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
    key: torch.Tensor,
    num_samples: int,
    batch_size: int,
    labels: np.ndarray | None = None,
    mesh=None,
    post_fn: PostFn | None = None,
    static: bool = True,
    **g_kwargs: Any,
) -> np.ndarray:
    """Batched generation (train.py:226-282): fixed-size batches, the last one
    over-generated and truncated; batch ``i`` samples from child ``i`` of ``key``
    (a uint32 ``[2]`` key, ``split(key, nb)[i]`` in JAX). ``post_fn(out,
    point_noise)`` is applied to each batch's output (the ``--mask-manual`` hook,
    PCGAN's point decoder); ``point_noise`` is drawn when ``spec`` has a
    ``point_shape`` and ``post_fn`` is given, else None. ``g_kwargs`` go to
    every generator call (``epoch=`` for the legacy model). Outputs stay on
    the device and reach the host in one copy at the end.

    With ``mesh`` (a :class:`..parallel.mesh.Mesh`) every rank draws each
    batch's noise (and point noise) whole from ``key``, as one device
    does, runs G on its ``batch_size / M`` rows and gets every rank's rows by
    one ``all_gather`` at the end: the single-device output on every rank. A
    batch size that ``M`` does not divide falls back to every rank generating
    the whole batch (``mpgan_tpu/training/sampling.py:179-180``).

    With ``static`` (the default) each batch runs on a kept
    :class:`_StaticSampler` (a CUDA graph's replay on a GPU), keyed as the JAX
    package keys its samplers: the generator module, the batch size, ``post_fn``,
    the labels' shape or none, ``g_kwargs``, and the route (:func:`route_key`).
    The weights are read in place, so a kept graph follows training; a load
    drops it (:func:`drop_samplers`). ``static=False`` runs the eager loop, the
    reference the static path is held to bit for bit."""
    if mesh is not None and batch_size % mesh.size:
        mesh = None  # the batch does not split: every rank generates all of it
    rows = slice(None) if mesh is None else mesh.rows(batch_size)
    device = _device_of(g)
    key = key.to(device)
    num_batches = (num_samples + batch_size - 1) // batch_size
    labels_all = None
    if labels is not None:
        labels = np.asarray(labels)[:num_samples]
        pad = np.repeat(labels[-1:], num_batches * batch_size - len(labels), axis=0)
        labels_all = torch.as_tensor(np.concatenate([labels, pad], axis=0), device=device)
    if static:
        outs = _generate_static(g, spec, key, batch_size, labels_all, post_fn, g_kwargs,
                                num_batches, device, rows)
    else:
        outs = []
        with torch.inference_mode():
            for i in range(num_batches):
                batch_labels = None
                if labels_all is not None:
                    batch_labels = labels_all[i * batch_size : (i + 1) * batch_size][rows]
                draws = prng.draw(key, spec.rows(batch_size, (i,), points=post_fn is not None))
                out = g(draws[0][rows], batch_labels, update_sn=False, **g_kwargs)
                if post_fn is not None:
                    out = post_fn(out, draws[1][rows] if len(draws) > 1 else None)
                outs.append(out)
        outs = torch.stack(outs)
    if mesh is not None:  # [batches, B/M, ...] a rank -> [batches, B, ...]
        outs = torch.cat(mesh.all_gather(outs), dim=1)
    return outs.flatten(0, 1)[:num_samples].cpu().numpy()


def _generate_static(g, spec, key, batch_size, labels_all, post_fn, g_kwargs,
                     num_batches, device, rows) -> torch.Tensor:
    """Every batch's output rows ``rows``, ``[num_batches, rows, ...]``."""
    label_key = None if labels_all is None else (tuple(labels_all.shape[1:]), labels_all.dtype)
    cache_key = (spec, batch_size, post_fn, label_key, tuple(sorted(g_kwargs.items())),
                 route_key(g), (rows.start, rows.stop))
    with torch.inference_mode():
        kept = _SAMPLERS.setdefault(g, {})
        if cache_key not in kept:
            kept[cache_key] = _StaticSampler(g, spec, batch_size, labels_all, post_fn, g_kwargs,
                                       device, rows)
        sampler = kept[cache_key]
        sampler.start(key)
        outs = None
        for i in range(num_batches):
            batch = slice(i * batch_size, (i + 1) * batch_size)
            out = sampler(None if labels_all is None else labels_all[batch][rows])
            if outs is None:
                outs = torch.empty((num_batches,) + tuple(out.shape), dtype=out.dtype,
                                   device=out.device)
            outs[i].copy_(out)
        return outs
