"""The harness: finds a cell's pieces by name and runs it once.

``BENCHMARK.json`` names the cells (``workloads``), the configurations and the
metrics; everything else is a file of its own, found by name:

- a configuration: the ``file`` its entry names, ``benchmark/configs/<config>.json``;
- a traffic mix: ``benchmark/traffic/<traffic>.json``, whose ``loop`` names
  the class that reads its parameters (``<file>:<class>``, the file relative
  to the checkout, as :func:`code` loads it);
- a configuration's plain reference and its work counts: the modules its
  ``reference`` and ``work`` name (``<file>``, likewise);
- a per-layer metric: ``benchmark/metrics/<metric>.py``, a reader with
  ``read(reading) -> float | None`` (None: nothing to read in this cell);
- a cell's limits: ``benchmark/limits/<workload>.json``, each number that
  decides ``correct`` with its limit and the readings it was set from.

A new configuration, mix, loop, reference, work count, metric or cell is new
files and entries: nothing here names one.
"""

from __future__ import annotations

import dataclasses
import hashlib
import importlib
import importlib.util
import json
import pathlib
import re
import statistics
import sys
import time

import torch

from . import correct, trace
from .peaks import PEAK_FP32, PEAK_HBM

PACKAGE = pathlib.Path(__file__).resolve().parent
ISSUE_CALLS = 15  # the drained step or sampler calls a traced run times after its window


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: list
    per_layer: list
    limits: dict
    loop: type  # the mix's loop class
    reference: object  # the configuration's reference module
    work: object  # the configuration's work-count module


def code(root: pathlib.Path, ref: str):
    """The module of ``<file>`` or its attribute ``<file>:<name>``, ``<file>`` a
    ``.py`` under ``benchmark/`` of the checkout ``root``. In this checkout it
    is imported as a module of the package (``benchmark/loops.py`` is
    ``benchmark.loops``); in a copy elsewhere it is loaded from its file under
    a name of its own, its relative imports taken from this package."""
    file, _, attr = ref.partition(":")
    if not (file.startswith("benchmark/") and file.endswith(".py")) or ".." in file:
        raise ValueError(f"{ref!r}: not a .py file under benchmark/")
    dotted = file[:-3].replace("/", ".")
    if (root / "benchmark").resolve() == PACKAGE:
        mod = importlib.import_module(dotted)
    else:
        path = (root / file).resolve()
        name = f"{dotted}_{hashlib.sha1(str(path).encode()).hexdigest()[:12]}"
        mod = sys.modules.get(name)
        if mod is None:
            spec = importlib.util.spec_from_file_location(name, path)
            mod = importlib.util.module_from_spec(spec)
            sys.modules[name] = mod
            spec.loader.exec_module(mod)
    return getattr(mod, attr) if attr else mod


def manifest(root: pathlib.Path) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell(root: pathlib.Path, workload: str) -> Cell:
    m = manifest(root)
    entry = {w["name"]: w for w in m["workloads"]}.get(workload)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    conf = {c["name"]: c for c in m["configs"]}[entry["config"]]
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads((root / "benchmark" / "traffic" / f"{entry['traffic']}.json").read_text())
    e2e = [x for x in m["end_to_end"] if workload in x.get("workloads", [workload])]
    reported = {x["name"] for x in e2e}

    def applies(metric):
        return workload in metric["workloads"] if "workloads" in metric else \
            metric["moves"] in reported
    per_layer = [x for x in m["per_layer"] if applies(x)]
    limits = correct.load_limits(root / "benchmark" / "limits" / f"{workload}.json")
    return Cell(workload, config, traffic, int(entry["chips"]), e2e, per_layer, limits,
                code(root, traffic["loop"]), code(root, config["reference"]),
                code(root, config["work"]))


def make_loop(c: Cell, seed: int, device: torch.device):
    """The cell's loop, built (its set-up not yet run)."""
    return c.loop(c.config, c.traffic, seed, device, c.reference, c.work)


def metric_module(root: pathlib.Path, name: str):
    path = root / "benchmark" / "metrics" / f"{name}.py"
    module = "benchmark_metric_" + re.sub(r"\W", "_", name)
    spec = importlib.util.spec_from_file_location(module, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Reading:
    """What a per-layer metric's reader reads: the traced window (``trace``,
    None without one), the units it completed (``units``: D+G steps or
    generated batches) over ``wall_s`` of the host's clock, the host's ms in
    each of a few step or sampler calls made after the window, each with the
    device idle before it (``issue_ms``), and the needed work of one unit by
    operation family (``work``, the configuration's work module)."""

    units: int
    wall_s: float
    issue: list
    work: dict
    trace: trace.Trace | None

    def roofline(self, family: str, kernels) -> float | None:
        """The family's least time on the card (FLOPs over the FP32 peak or
        bytes over the memory rate, whichever is larger) over the traced time
        of ``kernels``, in percent; None where either is missing."""
        w = self.work.get(family)
        if w is None or self.trace is None or not self.units:
            return None
        spent = self.trace.seconds_of(kernels)
        if spent <= 0:
            return None
        least = self.units * max(w.flops / PEAK_FP32, w.bytes / PEAK_HBM)
        return 100.0 * least / spent

    def bound_by(self, family: str) -> str:
        w = self.work[family]
        return "operations" if w.flops / PEAK_FP32 >= w.bytes / PEAK_HBM else "bytes"

    def mfu(self) -> float | None:
        if not self.units or self.wall_s <= 0:
            return None
        return 100.0 * self.units * self.work["model"].flops / self.wall_s / PEAK_FP32

    def idle_pct(self) -> float | None:
        if self.trace is None or self.trace.window_s <= 0 or self.trace.busy_s <= 0:
            return None
        return 100.0 * (1.0 - self.trace.busy_s / self.trace.window_s)

    def device_ms(self) -> float | None:
        if self.trace is None or not self.units or self.trace.busy_s <= 0:
            return None
        return 1e3 * self.trace.busy_s / self.units

    def issue_ms(self) -> float | None:
        """The median host ms of one call with the launch queue empty: the host's
        own work to issue a step or a batch, none of it a wait for the device."""
        return 1e3 * statistics.median(self.issue) if self.issue else None


def run(root: pathlib.Path, workload: str, seed: int, seconds: float, traced: bool,
        device: torch.device, t_start: float, after_window=None) -> dict:
    """One run of the cell: set-up, the window (traced with ``traced``), then,
    with the program's state freed, the check. ``after_window()`` runs as the
    window closes (the run's check of what the process has loaded). Returns
    the result's keys; ``checks`` last."""
    c = cell(root, workload)
    t_built = time.perf_counter()
    loop = make_loop(c, seed, device)
    try:
        with loop.patch():
            t_setup = time.perf_counter()
            loop.setup()
            setup_s = time.perf_counter() - t_start
            setup_parts = {"start_s": t_built - t_start, "build_s": t_setup - t_built,
                           "first_s": time.perf_counter() - t_setup}
            with trace.profiled(traced) as prof:
                loop.window(seconds)
        if after_window is not None:
            after_window()
        tr = trace.read(prof) if traced else None
        if traced:
            with loop.patch():
                loop.drained(ISSUE_CALLS)
        peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
        reading = Reading(loop.units, loop.wall_s, loop.timer.drained, loop.work(), tr)
        metrics, notes = {}, {}
        if traced:
            for entry in c.per_layer:
                mod = metric_module(root, entry["name"])
                value = mod.read(reading)
                if value is not None:
                    metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
                for pattern in getattr(mod, "KERNELS", []):  # what each roofline summed
                    notes[f"kernels.{entry['name']}.{pattern}"] = tr.seconds_of([pattern])
            for fam in reading.work:
                if fam != "model":
                    notes[f"bound_by.{fam}"] = reading.bound_by(fam)
        else:
            e2e = dict(loop.end_to_end(), setup_s=setup_s)
            for entry in c.end_to_end:
                if entry["name"] in e2e:
                    metrics[entry["name"]] = {"value": e2e[entry["name"]], "unit": entry["unit"]}
        loop.free()
        numbers = loop.numbers(loop.reference())
        ok, checks = correct.judge(numbers, c.limits)
        dev = {"platform": "gpu" if device.type == "cuda" else device.type,
               "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
               "count": c.chips, "memory_peak_bytes": int(peak)}
        result = {"correct": ok and loop.failed == 0, "attempted": loop.attempted,
                  "failed": loop.failed, "metrics": metrics, "device": dev}
        if tr is not None:
            dev.update(busy_s=tr.busy_s, window_s=tr.window_s)
            result["breakdown"] = tr.breakdown()
        result["notes"] = dict(notes, **loop.extra, units=loop.units, wall_s=loop.wall_s,
                               setup_parts=setup_parts)
        result["checks"] = checks
        return result
    finally:
        loop.close()
