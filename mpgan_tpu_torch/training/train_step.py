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

Every random draw of a step comes from ``TrainState.rng``, a threefry key
(:mod:`..ops.prng`, a uint32 ``[2]`` tensor on the models' device), as the JAX
step draws from its state's key (``mpgan_tpu/training/train_step.py:182,
261``): the D step splits it 9 ways (the next key; G's noise, the real, fake
and GP passes' dropout keys, the GP weight, the targets, the augmentation of
the real and of the fake batch), the G step 5 ways (the next key; the noise,
G's and D's dropout keys, the augmentation). A step's draws are one plan
(:func:`part_draws`) drawn on the device by one ``threefry_draws`` launch,
which writes the next key over the state's; the dropout keys are keys below
the step's key (:class:`..ops.keys.Keys`), drawn in the same launch from a
part's second step on (:class:`..ops.keys.KeyLog`). A test can pass the draws
instead (``DDraws``/``GDraws``).

:class:`StaticStep` takes the same steps on static buffers, so that a CUDA
graph can replay them (the counterpart of the JAX epoch's ``lax.scan`` body
and its fused ``dg_step``): one ``threefry_draws`` launch at the start of the
body draws the batch's rows from the epoch's order at a device batch counter,
every draw of the step, the dropout keys included
(:class:`..ops.keys.KeySlots`), into one buffer, writes the next key and
advances the counter. :class:`StepGraphs` keeps the epoch loop's static steps;
an epoch copies its order to the device once and then replays.

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
so that the parameters and optimizer states stay replicated. The key is
replicated; each rank folds its rank into each of a step's split keys (but not
the next key), as JAX's ``_localize`` does (:func:`..parallel.mesh.local_path`).
"""

from __future__ import annotations

import dataclasses
import logging
import weakref
from typing import Any, Callable, Sequence

import numpy as np
import torch

from ..ops import prng
from ..ops.augment import AugmentConfig, AugmentDraws, augment, augment_from, augment_rows
from ..ops.keys import KeyLog, Keys, KeySlots
from ..ops.mp_kernels import CountedGraph, graph_pool, warm_up
from ..parallel.mesh import Mesh, local_path, pmean_
from .losses import alpha_shape, d_loss, g_loss, gradient_penalty, target_rows, targets_from
from .sampling import NoiseSpec, drop_samplers, route_key

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class TrainState:
    g: torch.nn.Module
    d: torch.nn.Module
    g_opt: torch.optim.Optimizer
    d_opt: torch.optim.Optimizer
    rng: torch.Tensor  # the threefry key (uint32 [2]); every draw of the steps
    # the eager parts' dropout key requests, drawn with their draws (KeyLog)
    key_logs: dict = dataclasses.field(default_factory=dict, repr=False, compare=False)


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
    fake pass, the loss targets (None: plain 1 and 0; or a function that makes
    them), the GP's keys and interpolation weight, and the augmentation's of the
    real and the fake batch."""

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


@dataclasses.dataclass
class PartDraws:
    """A step part's draws as plan rows below the step's key: ``rows``, the
    path of each dropout key field (``keys``), and ``make(views, keys)``, which
    builds the ``DDraws``/``GDraws`` from the rows' draws and a keys object a field."""

    rows: list
    keys: dict
    make: Callable[[Sequence[torch.Tensor], dict], Any]


def part_draws(part: str, cfg: StepConfig, spec: NoiseSpec, batch_size: int,
               like_shape: tuple | None = None, prefix: tuple = (),
               mesh: Mesh | None = None) -> PartDraws:
    """The draws of a D (``part`` "d") or G ("g") step whose key is the one at
    ``prefix`` below the plan's (``(0,)`` for the G part of a D+G step), as the
    JAX step splits it: D's children 1-8 are the noise, real, fake and GP
    passes' keys, the GP weight, the targets and the two augmentations'; G's
    1-4 the noise, G's and D's keys and the augmentation's. With ``mesh`` each
    child is folded with the rank. ``like_shape``: the (encoded) real batch's
    shape, which the GP weight takes."""
    b, local = batch_size, local_path(mesh)
    k = lambda i: tuple(prefix) + (i,) + local  # noqa: E731
    rows: list = []
    spans: dict = {}

    def add(name, new):
        spans[name] = (len(rows), len(rows) + len(new))
        rows.extend(new)

    add("noise", spec.rows(b, k(1)))
    if part == "d":
        targets = cfg.loss in ("og", "ls") and (cfg.label_smoothing or cfg.label_noise)
        if targets:
            add("targets", target_rows(k(6), b, cfg.label_smoothing, cfg.label_noise))
        if cfg.gp_lambda:
            add("gp_alpha", [prng.Row("uniform", alpha_shape(tuple(like_shape)), k(5))])
        if cfg.augment is not None:
            add("aug_real", augment_rows(cfg.augment, k(7), b))
            add("aug_fake", augment_rows(cfg.augment, k(8), b))
        keys = {"real": k(2), "fake": k(3), "gp": k(4)}
    else:
        if cfg.augment is not None:
            add("aug", augment_rows(cfg.augment, k(4), b))
        keys = {"g": k(2), "d": k(3)}

    def make(views, key_objs):
        got = {name: list(views[lo:hi]) for name, (lo, hi) in spans.items()}

        def aug(name):
            return augment_from(cfg.augment, got[name]) if name in got else None

        if part == "g":
            return GDraws(got["noise"][0], key_objs["g"], key_objs["d"], aug("aug"))
        tgt = None
        if "targets" in got:  # made in the step from the buffer's draws, each run
            tgt = lambda: targets_from(got["targets"], b, cfg.label_smoothing,  # noqa: E731
                                       cfg.label_noise)
        alpha = got["gp_alpha"][0] if "gp_alpha" in got else None
        return DDraws(got["noise"][0], key_objs["real"], key_objs["fake"], tgt, key_objs["gp"],
                      alpha, aug("aug_real"), aug("aug_fake"))

    return PartDraws(rows, keys, make)


def _state_key(state: TrainState, device) -> torch.Tensor:
    """The state's key, moved once to ``device`` (where the step's tensors are)."""
    if state.rng.device != torch.device(device):
        state.rng = state.rng.to(device)
    return state.rng


def draw_part(state: TrainState, pd: PartDraws, device, part: str = "",
              serve: Callable[[dict], dict] | None = None):
    """A step part's draws from the state's key in one launch, which writes the
    next key over it. The dropout keys are :class:`Keys` below the old key, or
    what ``serve`` makes of them (a static step's recorded slots); with
    ``part`` (an eager step's "d" or "g") they are served from the same launch,
    which also draws the requests of the part's last run
    (:class:`..ops.keys.KeyLog`, kept in ``state.key_logs``)."""
    key = _state_key(state, device)
    root = key.clone()
    keys = {f: Keys(root, p) for f, p in pd.keys.items()}
    logs = getattr(state, "key_logs", None)
    if serve is not None or not part or logs is None:
        views = prng.draw(key, pd.rows, advance=1)
        return pd.make(views, keys if serve is None else serve(keys))
    log = logs.setdefault(part, KeyLog())
    log.renew()
    views = prng.draw(key, pd.rows + log.rows(pd.keys), advance=1)
    log.begin(keys, views[len(pd.rows):])
    return pd.make(views[:len(pd.rows)], {f: log.root(f) for f in pd.keys})


def draw_d(state: TrainState, cfg: StepConfig, spec: NoiseSpec, data: torch.Tensor,
           mesh: Mesh | None = None) -> DDraws:
    """A D step's draws for the (encoded) real batch ``data``; advances the key."""
    pd = part_draws("d", cfg, spec, data.shape[0], tuple(data.shape), mesh=mesh)
    return draw_part(state, pd, data.device, "d")


def draw_g(state: TrainState, cfg: StepConfig, spec: NoiseSpec, batch_size: int,
           device, mesh: Mesh | None = None) -> GDraws:
    """A G step's draws; advances the key."""
    return draw_part(state, part_draws("g", cfg, spec, batch_size, mesh=mesh), device, "g")


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
    targets = draws.targets() if callable(draws.targets) else draws.targets
    total, parts = d_loss(cfg.loss, real_out, fake_out, targets)
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
    batch ``data_all[order[counter]]`` (``labels_all`` likewise), adds its loss
    parts to ``sums``, device scalars, and adds one to ``counter`` (int32
    ``[1]`` on the device; ``order`` the epoch's ``[steps, B]`` int32 rows):

    - the first call records: an ordinary step (:func:`d_step`, :func:`g_step`,
      drawing from the state's key) whose dropout keys :class:`KeySlots` logs;
      it fixes the plan of the static buffer: the batch's row of ``order``, then
      per part its draws (:func:`part_draws`, the G part of "dg" below child 0)
      and its logged keys;
    - every later call runs the body: one ``threefry_draws`` launch of that
      plan from the state's key, which writes the buffer, the next key (child 0
      once a part) and the counter, then the step on views of the buffer. The
      body runs as it is (the CPU), or, with ``capture``, runs once on a side
      stream (torch.cuda.graphs' warm-up rule), is captured at the next call
      into a CUDA graph (:class:`CountedGraph`, in :func:`graph_pool`) and
      replayed from then on: no host work but the replay.

    A call gives the eager step's parameters, optimizer state, loss parts and
    key. With ``mesh`` the body holds the steps' reduces (a captured graph
    holds the NCCL all-reduce) and ``order`` holds this rank's rows."""

    def __init__(self, kind: str, state: TrainState, cfg: StepConfig, spec: NoiseSpec,
                 data_all: torch.Tensor, labels_all: torch.Tensor | None,
                 sums: dict[str, torch.Tensor], order: torch.Tensor, counter: torch.Tensor,
                 post_gen: PostGen | None = None, encode_real: PostGen | None = None,
                 epoch: int = 0, capture: bool = False, mesh: Mesh | None = None):
        if kind not in ("d", "g", "dg"):
            raise ValueError(f"step kind {kind!r}: expected d, g or dg")
        self.kind, self.state, self.cfg, self.spec = kind, state, cfg, spec
        self.data_all, self.labels_all, self.sums = data_all, labels_all, sums
        self.order, self.counter = order, counter
        self.post_gen, self.encode_real, self.epoch = post_gen, encode_real, epoch
        self.capture, self.mesh = capture, mesh
        self.device = data_all.device
        self.slots = [KeySlots() for _ in kind]
        self.calls = 0
        self.graph: CountedGraph | None = None
        self._like: tuple | None = None  # the (encoded) real batch's shape

    def __call__(self) -> None:
        if self.calls == 0:
            self._record()
        elif self.graph is not None:
            self.graph.replay()
        elif not self.capture:
            self._body()
        elif self.calls == 1:
            warm_up(self._body, self.device)
        else:
            self.graph = CountedGraph(self._body, pool=graph_pool())
            self.graph.replay()
            logger.info(f"captured the {self.kind} step (batch {self.order.shape[1]}) in a "
                        f"CUDA graph, replayed from its next batch on; hand-written kernel "
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

    def _part(self, i: int, prefix: tuple) -> PartDraws:
        b = self.order.shape[1]
        return part_draws(self.kind[i], self.cfg, self.spec, b, self._like, prefix, self.mesh)

    def _record(self) -> None:
        idx = self.order.index_select(0, self.counter.long()).reshape(-1)
        data, labels = self._batch(idx)
        for i, part in enumerate(self.kind):
            sources: dict = {}

            def made(like, i=i, sources=sources):
                if like is not None:
                    self._like = tuple(like.shape)

                def serve(keys):  # the slots log the keys' requests
                    sources.update(keys)
                    return {f: self.slots[i].root(f) for f in keys}
                return draw_part(self.state, self._part(i, ()), self.device, serve=serve)

            with self.slots[i].recording(sources):
                self._run(part, data, labels, made if part == "d" else made(None))
        self.counter.add_(1)
        self._layout()

    def _layout(self) -> None:
        """The plan: the batch's row of the order, then each part's draws, then
        each part's logged keys; the static draws are views of its buffer."""
        parts = [self._part(i, (0,) * i) for i in range(len(self.kind))]
        rows = [prng.Row("order", (self.order.shape[1],))]
        for pd in parts:
            rows += pd.rows
        first_slot = len(rows)
        for i, pd in enumerate(parts):
            rows += self.slots[i].rows(pd.keys)
        self.plan = prng.Plan(rows, self.device)
        self.buffer = torch.empty(self.plan.words, dtype=torch.int32, device=self.device)
        views = self.plan.views(self.buffer)
        self.idx = views[0]
        self._static, lo = [], 1
        for i, pd in enumerate(parts):
            self._static.append(pd.make(views[lo:lo + len(pd.rows)],
                                        {f: self.slots[i].root(f) for f in pd.keys}))
            lo += len(pd.rows)
        off = self.plan.offsets[first_slot] if first_slot < len(rows) else self.plan.words
        for slots in self.slots:
            slots.buffer = self.buffer[off:off + len(slots.log)]
            off += len(slots.log)

    def _body(self) -> None:
        self.plan.run(self.state.rng, self.buffer, self.counter, self.order,
                      advance=len(self.kind), bump=True)
        data, labels = self._batch(self.idx)
        for i, part in enumerate(self.kind):
            with self.slots[i].serving():
                self._run(part, data, labels, self._static[i])


_LIVE_STEP_GRAPHS: "weakref.WeakSet[StepGraphs]" = weakref.WeakSet()


def step_kinds(num_batches: int, num_critic: int = 1, num_gen: int = 1) -> list[tuple[int, str]]:
    """The epoch's steps as ``(batch, kind)``: one "dg" a batch with ``num_critic =
    num_gen = 1``, else the eager loop's interleave of "d" and "g" steps
    (train.py:841-878)."""
    if num_critic == 1 and num_gen == 1:
        return [(b, "dg") for b in range(num_batches)]
    steps = []
    for b in range(num_batches):
        if num_critic > 1 or b == 0 or (b - 1) % num_gen == 0:
            steps.append((b, "d"))
        if num_critic == 1 or (b - 1) % num_critic == 0:
            steps.append((b, "g"))
    return steps


class StepGraphs:
    """The epoch loop's static steps (:class:`StaticStep`), one per kind, with
    the loss sums they add to, the epoch's order (one row a step) and the batch
    counter, all on the device. They hold for one staged dataset, order shape,
    model phase (the legacy model's ``--mask-epoch``) and kernel route; an
    epoch on any other drops them (and their graphs) and records anew.
    ``capture``: replay CUDA graphs (all in :func:`graph_pool`), else run the
    bodies as they are (the CPU). ``captures`` and ``replays`` count the graphs'
    captures and the steps that replayed one. ``mesh``: the steps reduce over
    its ranks."""

    def __init__(self, state: TrainState, cfg: StepConfig, spec: NoiseSpec,
                 loss_keys: Sequence[str], device, post_gen: PostGen | None = None,
                 encode_real: PostGen | None = None, capture: bool = False,
                 mesh: Mesh | None = None):
        self.state, self.cfg, self.spec = state, cfg, spec
        self.post_gen, self.encode_real = post_gen, encode_real
        self.capture, self.mesh, self.device = capture, mesh, torch.device(device)
        self.sums = {k: torch.zeros((), device=device) for k in loss_keys}
        self.counter = torch.zeros(1, dtype=torch.int32, device=device)
        self.order: torch.Tensor | None = None
        self.steps: dict[str, StaticStep] = {}
        self.captures = self.replays = 0
        self._key = None
        _LIVE_STEP_GRAPHS.add(self)

    def epoch(self, steps: Sequence[tuple[int, str]], data_all: torch.Tensor,
              labels_all: torch.Tensor | None, order: np.ndarray, epoch: int = 0) -> None:
        """Take ``steps`` (``(batch, kind)``, :func:`step_kinds`) on the batches of
        ``order`` (``[batches, B]``): one copy of their rows to the device, then a
        replay (or a body) a step. The loss sums are added to, not zeroed."""
        rows = np.ascontiguousarray(np.asarray(order)[[b for b, _ in steps]], dtype=np.int32)
        key = (id(data_all), id(labels_all), rows.shape, epoch,
               route_key(self.state.g, self.state.d))
        if key != self._key:
            self.drop()
            self._key = key
            self.order = torch.empty(rows.shape, dtype=torch.int32, device=self.device)
        self.order.copy_(torch.from_numpy(rows))
        self.counter.zero_()
        for _, kind in steps:
            if kind not in self.steps:
                self.steps[kind] = StaticStep(
                    kind, self.state, self.cfg, self.spec, data_all, labels_all, self.sums,
                    self.order, self.counter, post_gen=self.post_gen,
                    encode_real=self.encode_real, epoch=epoch, capture=self.capture,
                    mesh=self.mesh)
            step = self.steps[kind]
            captured = step.graph is not None
            step()
            if step.graph is not None:
                self.replays += 1
                self.captures += not captured

    def last_batch(self) -> torch.Tensor:
        """The last step's batch rows (device int32), as the order holds them."""
        return self.order[-1]

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
