"""The harness finds every piece of a cell from files, takes new ones without
a code edit, and the manifest keeps to the benchmark's contract."""

from __future__ import annotations

import json
import re

import pytest
import torch

from benchmark import harness, loops
from benchmark.tests.tiny import REPO, tiny_root

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
MANIFEST = json.loads((REPO / "BENCHMARK.json").read_text())


def _metric_entries():
    return MANIFEST["end_to_end"] + MANIFEST["per_layer"]


def test_manifest_keys_and_limits():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert 1 <= MANIFEST["run_seconds"] <= 51 and isinstance(MANIFEST["run_seconds"], int)
    assert 1 <= len(MANIFEST["paths"]) <= 16 and len(MANIFEST["command"]) <= 32
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and len(c["reduced"]) <= 16
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
    for m in MANIFEST["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in MANIFEST["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
    names = [m["name"] for m in _metric_entries()]
    assert len(names) == len(set(names)) and "setup_s" in names
    assert len(json.dumps(MANIFEST)) <= 64 * 1024


@pytest.mark.parametrize("entry", _metric_entries() + MANIFEST["configs"] + MANIFEST["workloads"],
                         ids=lambda e: e["name"])
def test_names_and_units_use_allowed_characters(entry):
    assert NAME.match(entry["name"])
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.match(entry[key])
    for key in ("why", "layer", "source"):
        if key in entry:
            assert TEXT.match(entry[key])
    for key in entry.get("reduced", []):
        assert NAME.match(key)
    if "unit" in entry:
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")
    if "file" in entry:
        assert PATH.match(entry["file"])


def test_files_under_paths_are_named_from_name_characters():
    for path in (REPO / "benchmark").rglob("*"):
        if "__pycache__" in path.parts:
            continue
        rel = str(path.relative_to(REPO))
        assert PATH.match(rel), rel


@pytest.mark.parametrize("workload", [w["name"] for w in MANIFEST["workloads"]])
def test_each_cell_is_found_from_files(workload):
    c = harness.cell(REPO, workload)
    assert issubclass(c.loop, loops.Loop) and c.loop.work_fn
    assert callable(getattr(c.work, c.loop.work_fn)) and callable(c.reference.spec)
    assert c.config["name"] == {w["name"]: w for w in MANIFEST["workloads"]}[workload]["config"]
    assert c.limits, "every cell has limits"
    reported = {m["name"] for m in c.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert m["moves"] in reported
        assert callable(harness.metric_module(REPO, m["name"]).read)


def test_metrics_of_one_layer_name_it_alike():
    by_layer = {}
    for m in MANIFEST["per_layer"]:
        by_layer.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_layer.values())


def test_new_config_mix_and_metric_are_taken_from_files(tmp_path):
    """A configuration, a traffic mix and a per-layer metric added as files and
    entries alone run through the harness unchanged."""
    root = tiny_root(tmp_path)
    (root / "benchmark/metrics/tiny_units.py").write_text(
        '"""Units a window completed."""\n\n\ndef read(r):\n    return float(r.units)\n')
    m = json.loads((root / "BENCHMARK.json").read_text())
    m["per_layer"].append({"name": "tiny_units", "unit": "batches", "better": "higher",
                           "source": "program_counter", "layer": "whole step",
                           "moves": "gen_jets_per_s", "workloads": ["tiny-gen"]})
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    out = harness.run(root, "tiny-gen", 5, 0.2, True, torch.device("cpu"), 0.0)
    assert out["correct"] is True
    assert out["metrics"]["tiny_units"]["value"] == out["notes"]["units"] > 0
    assert list(out)[-1] == "checks"


NEW_LOOP = '''"""A kind of traffic the benchmark did not have: requests of a size that
alternates between two of the mix's parameters."""

from .loops import GenRequests


class Alternating(GenRequests):
    def _request(self, r, jets_=None):
        sizes = self.params["sizes"]
        return super()._request(r, jets_ or sizes[r % len(sizes)])

    def end_to_end(self):
        self.extra["alternating_requests"] = self.requests
        return {"gen_jets_per_s": 1.0}
'''

NEW_REFERENCE = '''"""A configuration's reference of its own: MPGAN's, counting its uses."""

from .mpgan import *  # noqa: F401,F403
from .mpgan import generator as _generator

USES = []


def generator(*a, **kw):
    USES.append(1)
    return _generator(*a, **kw)
'''

NEW_WORK = '''"""A configuration's work counts of its own."""

from .work import Work


def gen_batch(args):
    return {"model": Work(1e9, 0.0)}
'''


def test_new_loop_reference_and_work_are_taken_from_files(tmp_path):
    """A kind of traffic (its loop class), a configuration's reference module
    and its work counts added as new files, named by a new mix and a new
    configuration, run through the harness unchanged."""
    root = tiny_root(tmp_path)
    (root / "benchmark/loops_alternating.py").write_text(NEW_LOOP)
    (root / "benchmark/reference/counted.py").write_text(NEW_REFERENCE)
    (root / "benchmark/work_fixed.py").write_text(NEW_WORK)
    (root / "benchmark/traffic/alternating.json").write_text(json.dumps(
        {"loop": "benchmark/loops_alternating.py:Alternating", "request_jets": 24,
         "sizes": [24, 48], "why": "requests of two sizes"}))
    cfg = json.loads((root / "benchmark/configs/tiny.json").read_text())
    cfg.update(name="tiny-own", reference="benchmark/reference/counted.py",
               work="benchmark/work_fixed.py")
    (root / "benchmark/configs/tiny-own.json").write_text(json.dumps(cfg))
    m = json.loads((root / "BENCHMARK.json").read_text())
    m["configs"].append(dict(m["configs"][0], name="tiny-own",
                             file="benchmark/configs/tiny-own.json"))
    m["workloads"].append({"name": "tiny-alt", "config": "tiny-own", "traffic": "alternating",
                           "chips": 1, "why": "a"})
    for x in m["end_to_end"] + m["per_layer"]:
        if "tiny-gen" in x.get("workloads", []):
            x["workloads"].append("tiny-alt")
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    (root / "benchmark/limits/tiny-alt.json").write_text(
        (root / "benchmark/limits/tiny-gen.json").read_text())
    c = harness.cell(root, "tiny-alt")
    assert c.loop.__name__ == "Alternating" and c.loop.__module__ != "benchmark.loops"
    out = harness.run(root, "tiny-alt", 6, 0.2, False, torch.device("cpu"), 0.0)
    assert out["correct"] is True, out["checks"]
    assert out["metrics"]["gen_jets_per_s"]["value"] == 1.0
    assert out["notes"]["alternating_requests"] >= 1
    assert c.reference.USES, "the configuration's own reference ran"
    traced = harness.run(root, "tiny-alt", 6, 0.2, True, torch.device("cpu"), 0.0)
    assert traced["metrics"]["gen_mfu"]["value"] > 0  # from the configuration's own work count
