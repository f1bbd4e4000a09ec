"""The traffic generator's loops: one class for each kind of traffic mix,
driven by the mix's parameters (``benchmark/traffic/<mix>.json``, whose
``loop`` names the class) and a configuration (``benchmark/configs/<config>.json``,
whose ``reference`` and ``work`` name the modules that a loop hands the
reference's work and the work counts to).

- :class:`TrainEpochs`: the training loop as ``cli/train.py --epoch-scan``
  runs it. Set-up builds the trainer (``training/loop.py::Trainer``) on the
  cell's staged jets, writes the seed's weights into its models and starts the
  first epoch, whose first ``check_steps`` step calls are read for the check;
  it stops that epoch as soon as those calls are made and the step's graph is
  captured. The window then calls ``Trainer.train_epoch`` epoch after epoch
  (each an order copy, a CUDA graph replay a step, one sync at its end) and
  ends at the first epoch end after ``--seconds``.
- :class:`GenRequests`: one client in a closed loop, as ``cli/gen.py`` and the
  evaluation call generation: requests of ``request_jets`` jets, back to back,
  each ``generate_multi_batch`` at the configuration's batch on the kept
  sampler, ending in numpy on the host; the labels drawn from the staged
  jets' particle counts. Set-up makes a request of two batches (the sampler
  records on its first call and captures its graph on the second); the window
  ends at the first request end after ``--seconds``. One batch of each
  request, drawn from the seed, is kept for the check; a kept batch that
  holds a value that is not finite counts its request as failed.

Each step call (``StaticStep.__call__``) and each sampler call
(``_StaticSampler.__call__``) goes through a wrapper of the benchmark's own,
which in the window records a CUDA event after it returns (a step is the gap
between two such events, so that an epoch end's host work and any stall land
in a step) and, in a traced run's drained calls after the window, waits for
the device before each call and times the host inside it.
"""

from __future__ import annotations

import contextlib
import gc
import shutil
import tempfile
import time
import types

import numpy as np
import torch

from . import correct, jets, weights
from .reference import rng as ref_rng

GEN_KEY_CHILD = 7  # the requests' keys lie below this child of the seed's key
LABEL_SETS = 8  # the requests cycle through this many label draws


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Enough(Exception):
    """Raised after a wrapped call to end the epoch or request around it early."""


class CallTimer:
    """The wrapped calls' count; from :meth:`start_window` on, a CUDA event
    recorded after each call returns; with :attr:`drain`, the host seconds
    inside each call, the device waited for before it (:attr:`drained`)."""

    def __init__(self, device):
        self.device = device
        self.calls = 0
        self.events: list | None = None
        self.drain = False
        self.drained: list[float] = []
        self.after = None  # a function of the call's number, run after it (may raise Enough)

    def wrap(self, fn):
        timer = self

        def inner(*a, **kw):
            if timer.drain:
                _sync(timer.device)
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            if timer.drain:
                timer.drained.append(time.perf_counter() - t0)
            timer.calls += 1
            if timer.events is not None:
                timer.events.append(timer.mark())
            if timer.after is not None:
                timer.after(timer.calls)
            return out
        return inner

    def mark(self):
        """A CUDA event recorded now on the current stream (the host's clock on the CPU)."""
        if self.device.type != "cuda":
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def start_window(self):
        self.calls = 0
        self.events = [self.mark()]

    def stop_after(self, calls: int):
        """Count the calls from here and end the epoch or request after ``calls``."""
        self.calls = 0

        def after(n):
            if n >= calls:
                raise Enough
        self.after = after

    def gaps_ms(self) -> list[float]:
        """The ms between consecutive marks (the device's clock on a GPU)."""
        ev = self.events or []
        if self.device.type != "cuda":
            return [1e3 * (b - a) for a, b in zip(ev[:-1], ev[1:])]
        return [a.elapsed_time(b) for a, b in zip(ev[:-1], ev[1:])]


@contextlib.contextmanager
def wrapped(cls, timer: CallTimer):
    original = cls.__call__
    cls.__call__ = timer.wrap(original)
    try:
        yield
    finally:
        cls.__call__ = original


def _key_tensor(key, device) -> torch.Tensor:
    return torch.tensor(list(key), dtype=torch.int64).to(torch.uint32).to(device)


def _args(config: dict, seed: int, out_dir: str):
    from mpgan_tpu_torch.training.config import from_args_dict
    return from_args_dict({**config["args"], "seed": int(seed), "dir_path": out_dir,
                           "name": "bench", "load_model": False})


def _kernel_path(*modules):
    """On the CPU, the kernel path's plain versions (what the card runs)."""
    import dataclasses
    for m in modules:
        m.cfg = dataclasses.replace(m.cfg, use_kernels=True)


def first_grad_norm(opt: torch.optim.RMSprop, p: torch.Tensor) -> float:
    """The norm of ``p``'s first gradient, from RMSprop's state after one step
    (``square_avg / (1 - alpha)``); 0 where the step never ran."""
    sq = opt.state.get(p, {}).get("square_avg")
    if sq is None:
        return 0.0
    alpha = next(g for g in opt.param_groups if any(q is p for q in g["params"]))["alpha"]
    return float(torch.sqrt(sq.double().sum() / (1 - alpha)))


class Loop:
    """What every kind shares: the configuration, the seed, the device, the
    configuration's reference (``ref``) and work-count (``work_counts``)
    modules, a scratch directory under ``TMPDIR``, and the window's counts.
    ``work_fn`` names the function of the work module that counts one unit
    (a step, a batch) from the configuration's arguments."""

    unit = ""
    work_fn = ""

    def __init__(self, config: dict, params: dict, seed: int, device: torch.device,
                 reference, work_counts):
        if int(seed) < 0:
            raise ValueError("--seed is a whole number, 0 or more")
        self.config, self.params, self.seed, self.device = config, params, int(seed), device
        self.ref, self.work_counts = reference, work_counts
        self.args_dict = config["args"]
        self.batch = int(self.args_dict["batch_size"])
        self.n = int(self.args_dict["num_hits"])
        self.jet_type = self.args_dict["jets"]
        self.tmp = tempfile.mkdtemp(prefix="mpgan-bench-")
        self.timer = CallTimer(device)
        self.attempted = self.failed = 0
        self.units = 0  # steps or batches completed in the window
        self.wall_s = 0.0
        self.extra: dict = {}

    def work(self) -> dict:
        """One unit's needed work by operation family."""
        return getattr(self.work_counts, self.work_fn)(self.args_dict)

    def close(self):
        shutil.rmtree(self.tmp, ignore_errors=True)


class TrainEpochs(Loop):
    unit = "step"
    work_fn = "train_step"

    def __init__(self, config, params, seed, device, reference, work_counts):
        super().__init__(config, params, seed, device, reference, work_counts)
        from mpgan_tpu_torch.data.loader import BatchLoader
        from mpgan_tpu_torch.training.loop import Trainer
        self.args = _args(config, seed, self.tmp)
        n_train = int(config["train_jets"])
        if n_train % self.batch:
            raise ValueError(f"train_jets {n_train} is not a whole number of batches")
        particles, cnt = jets.synthetic_jets(self.jet_type, n_train, self.n, seed)
        self.data = jets.normalise(self.jet_type, particles)
        self.labels = jets.labels(cnt, self.n)
        ds = types.SimpleNamespace(particle_data=self.data, jet_data=self.labels)
        self.trainer = Trainer(self.args, train_dataset=ds, device=device)
        st = self.trainer.state
        if device.type == "cpu":
            _kernel_path(st.g, st.d)
        gen = weights.generator_for(seed, device)
        scales = config.get("init_scales", {})
        self.init = {m: weights.draw_into(mod, gen, scales.get(m))
                     for m, mod in (("g", st.g), ("d", st.d))}
        self.loader = BatchLoader(self.data, self.labels if self.trainer.use_labels else None,
                                  batch_size=self.batch, shuffle=True, seed=self.seed)
        self.epoch = 0
        self.snapshots: dict = {"sums": [], "params": {}}
        self.first_rows = self.first_order()

    def patch(self):
        from mpgan_tpu_torch.training.train_step import StaticStep
        return wrapped(StaticStep, self.timer)

    def _snapshot(self, call: int):
        """After step call ``call`` of the first epoch: its loss sums and both
        models' parameters; after the first, each leaf's first gradient from
        the optimizer's state. Once the checked calls are made and the step's
        graph is captured, ends the epoch (:class:`Enough`)."""
        steps = int(self.params["check_steps"])
        st = self.trainer.state
        if call <= steps:
            _sync(self.device)
            sums = self.trainer.graphs.sums
            self.snapshots["sums"].append({k: float(v) for k, v in sums.items()})
            self.snapshots["params"][call] = {
                m: {name: p.detach().to("cpu", copy=True) for name, p in mod.named_parameters()}
                for m, mod in (("g", st.g), ("d", st.d))}
            if call == 1:
                self.snapshots["grad_norm"] = {
                    m: {name: first_grad_norm(opt, p) for name, p in mod.named_parameters()}
                    for m, mod, opt in (("g", st.g, st.g_opt), ("d", st.d, st.d_opt))}
        graphs = self.trainer.graphs
        if call >= steps and (not graphs.capture or all(
                s.graph is not None for s in graphs.steps.values())):
            raise Enough

    def setup(self):
        self.timer.after = self._snapshot
        self.epoch = 1
        d = self.trainer.state.d
        hook = d.register_forward_hook(self._first_d_output)
        try:
            self.trainer.train_epoch(self.epoch, self.loader)
        except Enough:
            pass
        finally:
            hook.remove()
            self.timer.after = None
        _sync(self.device)

    def _first_d_output(self, module, inputs, output):
        """D's first output of the run: the first step's real pass, one value a jet."""
        if "d_real1" not in self.snapshots:
            self.snapshots["d_real1"] = output.detach().to("cpu", copy=True).reshape(-1)

    def first_order(self) -> list:
        """The first epoch's batches, as a fresh shuffle of the seed gives them."""
        rng = np.random.default_rng(self.seed)
        idx = np.arange(len(self.data), dtype=np.int64)
        rng.shuffle(idx)
        steps = int(self.params["check_steps"])
        return [idx[s * self.batch:(s + 1) * self.batch] for s in range(steps)]

    def window(self, seconds: float):
        from torch.profiler import record_function
        self.timer.start_window()
        t0 = time.perf_counter()
        with record_function("bench.window"):
            while True:
                self.epoch += 1
                with record_function("bench.epoch"):
                    losses = self.trainer.train_epoch(self.epoch, self.loader)
                steps = len(self.loader)
                self.attempted += steps
                if not all(np.isfinite(v) for v in losses.values()):
                    self.failed += steps
                if time.perf_counter() - t0 >= seconds:
                    break
            _sync(self.device)
        self.wall_s = time.perf_counter() - t0
        self.units = self.attempted

    def drained(self, calls: int):
        """``calls`` step calls of one more epoch, each timed with the device idle."""
        self.timer.drain = True
        self.timer.stop_after(calls)
        try:
            self.trainer.train_epoch(self.epoch + 1, self.loader)
        except Enough:
            pass
        finally:
            self.timer.drain, self.timer.after = False, None
        _sync(self.device)

    def end_to_end(self) -> dict:
        gaps = self.timer.gaps_ms()
        out = {"train_jets_per_s": self.units * self.batch / self.wall_s}
        if gaps:
            out["train_step_ms_p95"] = float(np.percentile(gaps, 95))
        return out

    def free(self):
        """Keep the program's readings, drop its state."""
        if self.snapshots["sums"]:
            self.program = {"losses": self._step_losses(),
                            "grad_norm": self.snapshots["grad_norm"],
                            "final": self.snapshots["params"][len(self.first_rows)],
                            "d_real1": self.snapshots["d_real1"]}
        del self.trainer
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _step_losses(self) -> list:
        out, prev = [], {k: 0.0 for k in self.snapshots["sums"][0]}
        for s in self.snapshots["sums"]:
            out.append([s["Dr"] - prev["Dr"], s["Df"] - prev["Df"], s["G"] - prev["G"]])
            prev = s
        return out

    def reference(self, mm=None, half_batch=False) -> dict:
        return self.reference_steps(len(self.first_rows), mm, half_batch)

    def reference_steps(self, steps: int, mm=None, half_batch=False, d_after=None) -> dict:
        """The reference's first ``steps`` steps from the cell's weights and data
        (``mm``: the reference's product, float32 by default; ``d_after``, a
        witness: D's parameters to go on from after each step's D update)."""
        spec = self.ref.spec(self.config)
        dev = self.device
        data = torch.as_tensor(self.data, device=dev)
        labels = torch.as_tensor(self.labels, device=dev)
        g = {k: v.to(dev) for k, v in self.init["g"].items()}
        d = {k: v.to(dev) for k, v in self.init["d"].items()}
        return self.ref.run_steps(spec, g, d, data, labels, self.first_rows[:steps], self.seed,
                                  mm or self.ref.matmul, half_batch, d_after)

    def numbers(self, ref: dict) -> dict:
        return correct.train_numbers(self.program, ref, self.init)


class GenRequests(Loop):
    unit = "batch"
    work_fn = "gen_batch"

    def __init__(self, config, params, seed, device, reference, work_counts):
        super().__init__(config, params, seed, device, reference, work_counts)
        from mpgan_tpu_torch.models.registry import build_suite
        self.args = _args(config, seed, self.tmp)
        suite = build_suite(self.args)
        self.g = suite.generator(device=device)
        if device.type == "cpu":
            _kernel_path(self.g)
        self.spec = suite.noise
        gen = weights.generator_for(seed, device)
        self.init = {"g": weights.draw_into(self.g, gen, config.get("init_scales", {}).get("g"))}
        self.request_jets = int(params["request_jets"])
        cnt = jets.counts(self.jet_type, int(config["label_jets"]), self.n, seed)
        pool = jets.labels(cnt, self.n)
        self.label_sets = []
        for i in range(LABEL_SETS):
            pick = np.random.default_rng([self.seed, i]).choice(len(pool), size=self.request_jets)
            self.label_sets.append(pool[pick])
        self.root = ref_rng.child(ref_rng.root_key(seed), GEN_KEY_CHILD)
        self.batches = -(-self.request_jets // self.batch)
        self.kept: list = []  # (request, batch, jets)
        self.requests = 0

    def patch(self):
        from mpgan_tpu_torch.training.sampling import _StaticSampler
        return wrapped(_StaticSampler, self.timer)

    def pick(self, r: int) -> int:
        """The batch of request ``r`` that the check compares (one not cut short)."""
        full = max(1, self.request_jets // self.batch)
        return int(np.random.default_rng([self.seed, 1000 + r]).integers(full))

    def _request(self, r: int, jets_: int | None = None) -> np.ndarray:
        from mpgan_tpu_torch.training.sampling import generate_multi_batch
        n = jets_ or self.request_jets
        key = _key_tensor(ref_rng.child(self.root, r), self.device)
        return generate_multi_batch(self.g, self.spec, key, n, self.batch,
                                    labels=self.label_sets[r % LABEL_SETS][:n])

    def setup(self):
        out = self._request(0, 2 * self.batch)
        # the requests' output on the device, allocated here once: the allocator keeps the block
        torch.empty((self.batches * self.batch,) + out.shape[1:],
                    dtype=torch.from_numpy(out[:1]).dtype, device=self.device)
        _sync(self.device)

    def drained(self, calls: int):
        """A request of ``calls`` batches, each sampler call timed with the device idle."""
        self.timer.drain = True
        try:
            self._request(0, calls * self.batch)
        finally:
            self.timer.drain = False

    def window(self, seconds: float):
        from torch.profiler import record_function
        self.timer.start_window()
        t0 = time.perf_counter()
        r = 0
        with record_function("bench.window"):
            while True:
                r += 1
                with record_function("bench.request"):
                    out = self._request(r)
                self.attempted += 1
                pick = self.pick(r)
                self.kept.append((r, pick, out[pick * self.batch:(pick + 1) * self.batch].copy()))
                if time.perf_counter() - t0 >= seconds:
                    break
            _sync(self.device)
        self.wall_s = time.perf_counter() - t0
        self.requests = r
        self.units = r * self.batches

    def end_to_end(self) -> dict:
        return {"gen_jets_per_s": self.requests * self.request_jets / self.wall_s}

    def free(self):
        del self.g
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, mm=None) -> dict:
        ref = self.ref
        spec, mm = ref.spec(self.config), mm or ref.matmul
        dev = self.device
        params = ref.params_of({k: v.to(dev) for k, v in self.init["g"].items()}, "g")
        outs, risky = [], []
        with torch.no_grad():
            for r, bi, _ in self.kept:
                noise = ref_rng.normal(ref_rng.at(ref_rng.child(self.root, r), (bi, 0)),
                                       (self.batch, self.n, spec.latent), spec.noise_std, dev)
                lab = torch.as_tensor(
                    self.label_sets[r % LABEL_SETS][bi * self.batch:(bi + 1) * self.batch],
                    device=dev)
                outs.append(ref.generator(params, noise, lab, spec, mm).cpu())
                risky.append(ref.gen_risky_rows(params, noise, lab, spec).cpu())
        return {"jets": torch.cat(outs), "risky": torch.cat(risky)}

    def numbers(self, ref: dict) -> dict:
        self.failed = sum(not np.isfinite(k[2]).all() for k in self.kept)
        prog = torch.as_tensor(np.concatenate([k[2] for k in self.kept]))
        out = correct.gen_numbers(prog, ref["jets"], ref["risky"])
        self.extra["rows_left_out"] = float(ref["risky"].float().mean())
        return out

