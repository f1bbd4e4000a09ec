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

:class:`StaticStep` takes the same steps on static buffers, so that a CUDA
graph can replay them (the counterpart of the JAX epoch's ``lax.scan`` body
and its fused ``dg_step``): the host draws what the eager step draws, in its
order, the dropout keys included (:class:`..ops.keys.KeySlots`), and copies
them into the buffers before each run. :class:`StepGraphs` keeps the epoch
loop's static steps.

Mixed precision (``StepConfig.bf16``, ``--compute-dtype bfloat16``; the JAX
package's ``train_step.py:148-166``): every G and D apply of the step runs on
bf16 copies of the parameters, buffers and float inputs (noise, data) through
``torch.func.functional_call``; the casts are differentiable, so the gradients
land on the float32 parameters. The output comes back as float32, and the
buffers' new values (BN running statistics, SN vectors) are copied back into
the float32 buffers, so they pass through bf16 every step, as the JAX state
does. Labels pass as they are. Losses, the GP, augmentation, ``post_gen`` and
the optimizers stay float32; the draws and the dropout keys are the float32
step's. On the card the dense edge layers then run the bf16 modes of K2, K3
and K4, the knn edge layers those of K5, K6, K7 and K8, and GAPT's D-step G
forward (under ``no_grad``) K9 on bf16 inputs.

``StepConfig.batched_d`` runs the D step's real and fake passes as one pass over
``[real | fake]`` (2B rows) with the real pass's keys, labels concatenated and
the output split at B (``train_step.py:199-214``): legal only where D's output
per jet does not depend on the batch and D keeps no state across passes (no BN,
no SN), as the JAX package documents. The loop keeps it off, as the JAX loop does.

Data parallelism (``mesh=``, a :class:`..parallel.mesh.Mesh`; the JAX step
built with ``pmean_axis`` under ``shard_map``): every rank takes the step on
its rows of the global batch, and after the backward, before the optimizer's
update, one :func:`..parallel.mesh.pmean_` averages over the ranks the stepped
model's gradients, the loss parts and every floating buffer of both models
(BN running statistics, SN vectors), as ``train_step.py:244-248, 287-291`` do,
so that the parameters and optimizer states stay replicated. Each part of a
step draws one word from the replicated generator and takes its draws from a
generator seeded by that word and the rank (:func:`..parallel.mesh.fold_in`,
JAX's ``_localize``); without a mesh no word is drawn.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import weakref
from typing import Any, Callable, Sequence

import numpy as np
import torch

from ..ops.augment import AugmentConfig, AugmentDraws, augment, draw_augment
from ..ops.keys import GeneratorKeys, KeySlots
from ..ops.mp_kernels import CountedGraph, graph_pool, warm_up
from ..parallel.mesh import Mesh, fold_in, pmean_
from .losses import d_loss, d_targets, g_loss, gp_alpha, gradient_penalty
from .sampling import NoiseSpec, drop_samplers, route_key

logger = logging.getLogger(__name__)


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
    bf16: bool = False  # --compute-dtype bfloat16: bf16 applies, float32 master state
    batched_d: bool = False  # one D pass over [real | fake]


def step_config(args: Any) -> StepConfig:
    """The step config of processed args (the loss, the GP, the targets' noise,
    ``--aug-*`` and ``aug_prob``; ``augment`` None where no transform is on;
    ``bf16`` from ``--compute-dtype``), as the training loop builds it;
    ``batched_d`` stays off."""
    augment = AugmentConfig(aug_t=args.aug_t, aug_f=args.aug_f, aug_r90=args.aug_r90,
                            aug_s=args.aug_s, translate_ratio=args.translate_ratio,
                            scale_sd=args.scale_sd)
    return StepConfig(
        loss=args.loss, gp_lambda=args.gp, label_smoothing=args.label_smoothing,
        label_noise=args.label_noise, augment=augment if augment.any else None,
        aug_prob=args.aug_prob, bf16=getattr(args, "compute_dtype", "float32") == "bfloat16",
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


# the fields of a step's draws that hold tensors, and those that hold keys
DRAW_TENSORS = {DDraws: ("noise", "targets", "gp_alpha", "aug_real", "aug_fake"),
                GDraws: ("noise", "aug")}
DRAW_KEYS = {DDraws: ("real", "fake", "gp"), GDraws: ("g", "d")}


def map_draws(fn: Callable[[torch.Tensor], torch.Tensor], draws):
    """``draws`` (a ``DDraws`` or ``GDraws``) with ``fn`` applied to every tensor,
    field by field in ``DRAW_TENSORS`` order."""
    def tree(obj):
        if obj is None:
            return None
        if isinstance(obj, torch.Tensor):
            return fn(obj)
        if isinstance(obj, AugmentDraws):
            return obj.map(fn)
        return tuple(tree(o) for o in obj)
    return dataclasses.replace(draws, **{f: tree(getattr(draws, f))
                                         for f in DRAW_TENSORS[type(draws)]})


def host_draw_d(gen: torch.Generator, cfg: StepConfig, spec: NoiseSpec,
                like: torch.Tensor) -> DDraws:
    """The draws of a D step on the host, for a real batch shaped like ``like``
    (the GP weight takes its shape and dtype), with ``GeneratorKeys`` for the
    dropout keys."""
    b = like.shape[0]
    noise = spec.sample(gen, b, "cpu")
    targets = None
    if cfg.loss in ("og", "ls") and (cfg.label_smoothing or cfg.label_noise):
        targets = d_targets(gen, b, cfg.label_smoothing, cfg.label_noise)
    alpha = gp_alpha(gen, like) if cfg.gp_lambda else None
    aug_real = aug_fake = None
    if cfg.augment is not None:
        aug_real, aug_fake = (draw_augment(cfg.augment, gen, b) for _ in range(2))
    keys = GeneratorKeys(gen)
    return DDraws(noise, keys, keys, targets, keys, alpha, aug_real, aug_fake)


def host_draw_g(gen: torch.Generator, cfg: StepConfig, spec: NoiseSpec,
                batch_size: int) -> GDraws:
    """The draws of a G step on the host, with ``GeneratorKeys``."""
    noise = spec.sample(gen, batch_size, "cpu")
    aug = draw_augment(cfg.augment, gen, batch_size) if cfg.augment is not None else None
    keys = GeneratorKeys(gen)
    return GDraws(noise, keys, keys, aug)


def step_generator(state: TrainState, mesh: Mesh | None) -> torch.Generator:
    """Where a step part's draws come from: the state's generator, or with a
    mesh this rank's generator folded from it (one word drawn)."""
    return state.generator if mesh is None else fold_in(state.generator, mesh)


def draw_d(state: TrainState, cfg: StepConfig, spec: NoiseSpec, data: torch.Tensor,
           mesh: Mesh | None = None) -> DDraws:
    return map_draws(lambda t: to_device(t, data.device),
                     host_draw_d(step_generator(state, mesh), cfg, spec, data))


def draw_g(state: TrainState, cfg: StepConfig, spec: NoiseSpec, batch_size: int,
           device, mesh: Mesh | None = None) -> GDraws:
    return map_draws(lambda t: to_device(t, device),
                     host_draw_g(step_generator(state, mesh), cfg, spec, batch_size))


def reduce_step(mesh: Mesh | None, model: torch.nn.Module, losses: Sequence[torch.Tensor],
                state: TrainState, name: str) -> None:
    """With a mesh, the step's pmean before the update: ``model``'s gradients,
    the detached ``losses`` and both models' floating buffers, in one bucket."""
    if mesh is not None:
        grads = [p.grad for p in model.parameters()]
        buffers = [b for m in (state.g, state.d) for b in m.buffers() if b.is_floating_point()]
        pmean_(grads + list(losses) + buffers, mesh, name)


def bf16_apply(module: torch.nn.Module, x: torch.Tensor, labels: torch.Tensor | None,
               **kwargs) -> torch.Tensor:
    """``module(x, labels, **kwargs)`` in bf16: on bf16 copies of its parameters
    (differentiable casts) and floating buffers, with ``x`` cast to bf16; returns
    the output as float32 and copies the buffers' new values back into the
    float32 buffers (in-place updates such as BN's running statistics land on
    the copies)."""
    bf16 = torch.bfloat16
    tensors = {name: p.to(bf16) for name, p in module.named_parameters()}
    buffers = {name: b for name, b in module.named_buffers() if b.is_floating_point()}
    copies = {name: b.to(bf16) for name, b in buffers.items()}
    out = torch.func.functional_call(module, {**tensors, **copies}, (x.to(bf16), labels), kwargs)
    with torch.no_grad():
        for name, b in buffers.items():
            b.copy_(copies[name])
    return out.float()


def _apply(cfg: StepConfig, module: torch.nn.Module, x: torch.Tensor,
           labels: torch.Tensor | None, **kwargs) -> torch.Tensor:
    """An apply of G or D in the step: :func:`bf16_apply` with ``cfg.bf16``."""
    if cfg.bf16:
        return bf16_apply(module, x, labels, **kwargs)
    return module(x, labels, **kwargs)


def _maybe_aug(cfg: StepConfig, x: torch.Tensor, draws: AugmentDraws | None) -> torch.Tensor:
    return x if cfg.augment is None else augment(cfg.augment, x, cfg.aug_prob, draws)


PostGen = Callable[[torch.Tensor], torch.Tensor]


def epoch_kwargs(module: torch.nn.Module, epoch: int) -> dict[str, int]:
    """``{"epoch": epoch}`` for a module that reads the model epoch, else ``{}``."""
    return {"epoch": epoch} if getattr(module, "reads_epoch", False) else {}


def d_step(state: TrainState, cfg: StepConfig, spec: NoiseSpec, data: torch.Tensor,
           labels: torch.Tensor | None = None,
           draws: DDraws | Callable[[torch.Tensor], DDraws] | None = None,
           post_gen: PostGen | None = None, encode_real: PostGen | None = None,
           epoch: int = 0, mesh: Mesh | None = None) -> dict[str, torch.Tensor]:
    """One D update; returns the loss parts ``{Dr, Df, D(, gp)}`` as device scalars.
    ``post_gen`` is applied to G's output (the ``--mask-manual`` hook, train.py:208-210),
    ``encode_real`` to the real batch. ``draws`` may be a function of the
    (encoded) real batch that returns them. With ``mesh`` the gradients, the
    loss parts and both models' buffers are averaged over the ranks."""
    if encode_real is not None:
        with torch.no_grad():
            data = encode_real(data)
    if callable(draws):  # made from the (encoded) real batch
        draws = draws(data)
    draws = draws if draws is not None else draw_d(state, cfg, spec, data, mesh)
    g, d = state.g, state.d
    g_kw, d_kw = epoch_kwargs(g, epoch), epoch_kwargs(d, epoch)
    with torch.no_grad():
        # fresh fake batch, G in eval mode with spectral norm advancing (train.py:421,428)
        fake = _apply(cfg, g, draws.noise, labels, train=False, **g_kw)
        if post_gen is not None:
            fake = post_gen(fake)
        fake = _maybe_aug(cfg, fake, draws.aug_fake)
    if cfg.batched_d:
        # one pass over [real | fake] with the real pass's keys (the real rows unaugmented)
        b = data.shape[0]
        both = torch.cat([data, fake], dim=0)
        labels2 = None if labels is None else torch.cat([labels, labels], dim=0)
        out = _apply(cfg, d, both, labels2, train=True, rng=draws.real, **d_kw)
        real_out, fake_out = out[:b], out[b:]
    else:
        # real pass on unaugmented data (train.py:425)
        real_out = _apply(cfg, d, data, labels, train=True, rng=draws.real, **d_kw)
        fake_out = _apply(cfg, d, fake, labels, train=True, rng=draws.fake, **d_kw)
    total, parts = d_loss(cfg.loss, real_out, fake_out, draws.targets)
    if cfg.gp_lambda:
        gp = gradient_penalty(lambda x: _apply(cfg, d, x, labels, train=True, rng=draws.gp,
                                               **d_kw),
                              draws.gp_alpha, _maybe_aug(cfg, data, draws.aug_real), fake,
                              cfg.gp_lambda)
        parts = dict(parts, gp=gp)
        total = total + gp
    state.d_opt.zero_grad(set_to_none=True)
    total.backward()
    parts = {k: v.detach() for k, v in parts.items()}
    reduce_step(mesh, d, list(parts.values()), state, "d")
    state.d_opt.step()
    return parts


def g_step(state: TrainState, cfg: StepConfig, spec: NoiseSpec, data: torch.Tensor,
           labels: torch.Tensor | None = None, draws: GDraws | None = None,
           post_gen: PostGen | None = None, epoch: int = 0,
           mesh: Mesh | None = None) -> dict[str, torch.Tensor]:
    """One G update (``data`` only sets the batch size, train.py:497); returns ``{G}``.
    ``post_gen``, ``epoch`` and ``mesh`` as in :func:`d_step`."""
    batch_size = labels.shape[0] if labels is not None else data.shape[0]
    draws = draws if draws is not None else draw_g(state, cfg, spec, batch_size, data.device,
                                                   mesh)
    g, d = state.g, state.d
    fake = _apply(cfg, g, draws.noise, labels, train=True, rng=draws.g, **epoch_kwargs(g, epoch))
    if post_gen is not None:
        fake = post_gen(fake)
    fake = _maybe_aug(cfg, fake, draws.aug)
    # D in train mode; only its input gradient is used, so its parameters stay
    # out of the graph and the edge kernel's backward skips the weight contractions
    flags = [p.requires_grad for p in d.parameters()]
    d.requires_grad_(False)
    try:
        fake_out = _apply(cfg, d, fake, labels, train=True, rng=draws.d,
                          **epoch_kwargs(d, epoch))
    finally:
        for p, flag in zip(d.parameters(), flags):
            p.requires_grad_(flag)
    loss = g_loss(cfg.loss, fake_out)
    state.g_opt.zero_grad(set_to_none=True)
    loss.backward()
    loss = loss.detach()
    reduce_step(mesh, g, [loss], state, "g")
    state.g_opt.step()
    return {"G": loss}


# ---------------------------------------------------------------------------
# the static-buffer step and its CUDA graph
# ---------------------------------------------------------------------------


class StaticStep:
    """A D step, a G step or both on one batch (``kind`` "d", "g" or "dg", the
    JAX loop's ``dg_step``) on static buffers. Each call takes one step on the
    batch ``data_all[idx]`` (``labels_all`` likewise) and adds its loss parts to
    ``sums``, device scalars:

    - the first call records: an ordinary step (:func:`d_step`, :func:`g_step`)
      whose dropout keys :class:`KeySlots` logs as they are drawn; it fixes the
      layout of the static buffer;
    - every later call draws on the host what the eager step draws, in its
      order (per part: noise, targets, GP weight, augmentation, then the logged
      keys) into one fresh pinned tensor, with the batch's indices in front, and
      one non-blocking copy moves it into the static buffer, where the step's
      body reads its inputs. The body runs as it is (the CPU), or, with
      ``capture``, runs once on a side stream (torch.cuda.graphs' warm-up
      rule), is captured at the next call into a CUDA graph
      (:class:`CountedGraph`, in :func:`graph_pool`) and replayed from then on.

    A call gives the eager step's parameters, optimizer state, loss parts and
    generator state. ``draws``, one per part, replaces the generator's draws
    (host tensors and keys objects, e.g. a test's JAX-replay keys). With
    ``mesh`` the body holds the steps' reduces (a captured graph holds the
    NCCL all-reduce) and ``idx`` is this rank's rows of the batch."""

    def __init__(self, kind: str, state: TrainState, cfg: StepConfig, spec: NoiseSpec,
                 data_all: torch.Tensor, labels_all: torch.Tensor | None,
                 sums: dict[str, torch.Tensor], post_gen: PostGen | None = None,
                 encode_real: PostGen | None = None, epoch: int = 0, capture: bool = False,
                 mesh: Mesh | None = None):
        if kind not in ("d", "g", "dg"):
            raise ValueError(f"step kind {kind!r}: expected d, g or dg")
        self.kind, self.state, self.cfg, self.spec = kind, state, cfg, spec
        self.data_all, self.labels_all, self.sums = data_all, labels_all, sums
        self.post_gen, self.encode_real, self.epoch = post_gen, encode_real, epoch
        self.capture, self.mesh = capture, mesh
        self.device = data_all.device
        self.slots = [KeySlots(self.device) for _ in kind]
        self.calls = 0
        self.graph: CountedGraph | None = None
        self._templates: list = [None] * len(kind)
        self._like: tuple | None = None  # the (encoded) real batch's shape and dtype

    def __call__(self, idx, draws: Sequence | None = None) -> None:
        idx = torch.as_tensor(np.asarray(idx), dtype=torch.int32)
        if self.calls == 0:
            self._record(idx, draws)
        else:
            self.buffer.copy_(self._fill(idx, draws), non_blocking=True)
            if self.graph is not None:
                self.graph.replay()
            elif not self.capture:
                self._body()
            elif self.calls == 1:
                warm_up(self._body, self.device)
            else:
                self.graph = CountedGraph(self._body, pool=graph_pool())
                self.graph.replay()
                logger.info(f"captured the {self.kind} step (batch {idx.shape[0]}) in a CUDA "
                            f"graph, replayed from its next batch on; hand-written kernel "
                            f"launches a replay: {self.graph.launches}")
        self.calls += 1

    def _batch(self, idx: torch.Tensor):
        labels = None if self.labels_all is None else self.labels_all.index_select(0, idx)
        return self.data_all.index_select(0, idx), labels

    def _run(self, part: str, data, labels, draws) -> None:
        st, cfg, spec = self.state, self.cfg, self.spec
        if part == "d":
            out = d_step(st, cfg, spec, data, labels, draws=draws, post_gen=self.post_gen,
                         encode_real=self.encode_real, epoch=self.epoch, mesh=self.mesh)
        else:
            out = g_step(st, cfg, spec, data, labels, draws=draws, post_gen=self.post_gen,
                         epoch=self.epoch, mesh=self.mesh)
        for k, v in out.items():
            self.sums[k].add_(v)

    def _host_draws(self, i: int, like: torch.Tensor, b: int, draws: Sequence | None):
        if draws is not None and draws[i] is not None:
            return draws[i]
        gen = step_generator(self.state, self.mesh)
        if self.kind[i] == "d":
            return host_draw_d(gen, self.cfg, self.spec, like)
        return host_draw_g(gen, self.cfg, self.spec, b)

    def _with_slots(self, i: int, host):
        return dataclasses.replace(host, **{f: self.slots[i].root(f)
                                            for f in DRAW_KEYS[type(host)]})

    def _record(self, idx: torch.Tensor, draws: Sequence | None) -> None:
        data, labels = self._batch(to_device(idx, self.device))
        b = idx.shape[0]
        for i, part in enumerate(self.kind):
            sources: dict = {}

            def made(like, i=i, sources=sources):
                host = self._host_draws(i, like, b, draws)
                self._templates[i] = host
                if like is not None:
                    self._like = (tuple(like.shape), like.dtype)
                sources.update({f: getattr(host, f) for f in DRAW_KEYS[type(host)]})
                return self._with_slots(i, map_draws(lambda t: to_device(t, self.device), host))

            with self.slots[i].recording(sources):
                self._run(part, data, labels, made if part == "d" else made(None))
        self._layout(b)

    def _layout(self, b: int) -> None:
        """Carve the static buffer: the batch's indices, then per part its
        tensors' leaves (float32) and its key slots."""
        off, self._parts, static = b, [], []
        for i, host in enumerate(self._templates):
            leaves: list[torch.Tensor] = []
            map_draws(lambda t: leaves.append(t) or t, host)
            if any(t.dtype != torch.float32 for t in leaves):
                raise TypeError("static step: every draw must be float32")
            shapes = [tuple(t.shape) for t in leaves]
            keys_off = off + sum(math.prod(sh) for sh in shapes)
            self._parts.append((off, shapes, keys_off))
            off = keys_off + len(self.slots[i].log)
        self.buffer = torch.empty(off, dtype=torch.int32, device=self.device)
        self.idx = self.buffer[:b]
        for i, (off, shapes, keys_off) in enumerate(self._parts):
            views = []
            for sh in shapes:
                views.append(self.buffer[off:off + math.prod(sh)].view(torch.float32).view(sh))
                off += math.prod(sh)
            it = iter(views)
            static.append(self._with_slots(i, map_draws(lambda t: next(it), self._templates[i])))
            self.slots[i].buffer = self.buffer[keys_off:keys_off + len(self.slots[i].log)]
        self._static = static

    def _fill(self, idx: torch.Tensor, draws: Sequence | None) -> torch.Tensor:
        host = torch.empty(self.buffer.numel(), dtype=torch.int32,
                           pin_memory=self.device.type == "cuda")
        b = idx.shape[0]
        host[:b].copy_(idx)
        like = None if self._like is None else torch.empty(self._like[0], dtype=self._like[1],
                                                           device="meta")
        for i, (off, shapes, keys_off) in enumerate(self._parts):
            d = self._host_draws(i, like, b, draws)
            leaves: list[torch.Tensor] = []
            map_draws(lambda t: leaves.append(t) or t, d)
            if [tuple(t.shape) for t in leaves] != shapes:
                raise ValueError("static step: the draws' shapes differ from the recorded step's")
            for t in leaves:
                host[off:off + t.numel()].view(torch.float32).copy_(t.reshape(-1))
                off += t.numel()
            self.slots[i].fill({f: getattr(d, f) for f in DRAW_KEYS[type(d)]},
                               host[keys_off:keys_off + len(self.slots[i].log)])
        return host

    def _body(self) -> None:
        data, labels = self._batch(self.idx)
        for i, part in enumerate(self.kind):
            with self.slots[i].serving():
                self._run(part, data, labels, self._static[i])


_LIVE_STEP_GRAPHS: "weakref.WeakSet[StepGraphs]" = weakref.WeakSet()


class StepGraphs:
    """The epoch loop's static steps (:class:`StaticStep`), one per kind, with
    the loss sums they add to. They hold for one staged dataset, batch size,
    model phase (the legacy model's ``--mask-epoch``) and kernel route; a step
    on any other drops them (and their graphs) and records anew. ``capture``:
    replay CUDA graphs (all in :func:`graph_pool`), else run the bodies as they
    are (the CPU). ``captures`` and ``replays`` count the graphs' captures and
    the steps that replayed one. ``mesh``: the steps reduce over its ranks."""

    def __init__(self, state: TrainState, cfg: StepConfig, spec: NoiseSpec,
                 loss_keys: Sequence[str], device, post_gen: PostGen | None = None,
                 encode_real: PostGen | None = None, capture: bool = False,
                 mesh: Mesh | None = None):
        self.state, self.cfg, self.spec = state, cfg, spec
        self.post_gen, self.encode_real = post_gen, encode_real
        self.capture, self.mesh = capture, mesh
        self.sums = {k: torch.zeros((), device=device) for k in loss_keys}
        self.steps: dict[str, StaticStep] = {}
        self.captures = self.replays = 0
        self._key = None
        _LIVE_STEP_GRAPHS.add(self)

    def step(self, kind: str, data_all: torch.Tensor, labels_all: torch.Tensor | None,
             idx, epoch: int = 0) -> None:
        key = (id(data_all), id(labels_all), len(idx), epoch,
               route_key(self.state.g, self.state.d))
        if key != self._key:
            self.drop()
            self._key = key
        if kind not in self.steps:
            self.steps[kind] = StaticStep(
                kind, self.state, self.cfg, self.spec, data_all, labels_all, self.sums,
                post_gen=self.post_gen, encode_real=self.encode_real, epoch=epoch,
                capture=self.capture, mesh=self.mesh)
        step = self.steps[kind]
        captured = step.graph is not None
        step(idx)
        if step.graph is not None:
            self.replays += 1
            self.captures += not captured

    def drop(self) -> None:
        self.steps.clear()
        self._key = None


def drop_graphs(state: TrainState) -> None:
    """Drop every static step and sampler made for ``state`` (a load replaces
    the optimizer state that their graphs read)."""
    for graphs in list(_LIVE_STEP_GRAPHS):
        if graphs.state is state:
            graphs.drop()
    drop_samplers(state.g)
