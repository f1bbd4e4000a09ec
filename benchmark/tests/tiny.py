"""A copy of the benchmark at a size the CPU runs in seconds: the real
manifest's metrics, with tiny configurations and cells of their own, each a
new file beside the copied ones."""

from __future__ import annotations

import json
import pathlib
import shutil

REPO = pathlib.Path(__file__).resolve().parents[2]

TINY_ARGS = {
    "fe": [12, 10, 14], "fn": [16], "hidden_node_size": 6, "latent_node_size": 6,
    "batch_size": 8, "num_hits": 10,
}


def tiny_root(tmp: pathlib.Path, knn: bool = False) -> pathlib.Path:
    """A checkout-like directory: ``benchmark/`` copied, a tiny configuration
    (fully connected, or knn with ``k = 4``), the mixes ``train_epochs`` and a
    small ``gen_requests`` mix, cells ``tiny-train`` and ``tiny-gen``."""
    root = tmp / "root"
    shutil.copytree(REPO / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    m = json.loads((REPO / "BENCHMARK.json").read_text())
    base = json.loads((REPO / "benchmark/configs/mpgan-30p-flagship.json").read_text())
    cfg = dict(base, name="tiny", train_jets=32, label_jets=100)
    cfg["args"] = dict(base["args"], **TINY_ARGS)
    if knn:
        cfg["args"].update(fully_connected=False, num_knn=4)
    (root / "benchmark/configs/tiny.json").write_text(json.dumps(cfg))
    (root / "benchmark/traffic/gen_small.json").write_text(json.dumps(
        {"loop": "benchmark/loops.py:GenRequests", "request_jets": 20, "why": "a small request"}))
    m["configs"] = [dict(m["configs"][0], name="tiny", file="benchmark/configs/tiny.json")]
    m["workloads"] = [
        {"name": "tiny-train", "config": "tiny", "traffic": "train_epochs", "chips": 1, "why": "t"},
        {"name": "tiny-gen", "config": "tiny", "traffic": "gen_small", "chips": 1, "why": "g"}]
    for x in m["end_to_end"] + m["per_layer"]:
        if "workloads" in x:
            x["workloads"] = ["tiny-train" if "train" in w else "tiny-gen" for w in x["workloads"]]
            x["workloads"] = sorted(set(x["workloads"]))
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    limits = {"tiny-train": {"real1_gap": 1e-5, "real1_jets": 0.05, "loss1_gap": 1e-5, "dgrad_gap": 1e-5, "loss_gap": 1e-5,
                            "grad_gap": 1e-4, "change_gap": 1e-2},
              "tiny-gen": {"max_err": 1e-5}}
    for w, nums in limits.items():
        (root / f"benchmark/limits/{w}.json").write_text(json.dumps(
            {"numbers": {k: {"limit": v} for k, v in nums.items()}}))
    return root
