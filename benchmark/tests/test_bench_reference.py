"""The reference stands apart from the program and agrees with it at a tiny
size on the CPU; nothing the benchmark runs loads JAX or the JAX package."""

from __future__ import annotations

import ast
import json
import subprocess
import sys

import pytest
import torch

from benchmark.reference import rng
from benchmark.tests.tiny import REPO, tiny_root

FORBIDDEN_IN_REFERENCE = {"mpgan_tpu_torch", "mpgan_tpu", "jax", "jaxlib", "flax"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".", 1)[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".", 1)[0]


@pytest.mark.parametrize("path", sorted((REPO / "benchmark/reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert not set(_imports(path)) & FORBIDDEN_IN_REFERENCE


def test_reference_loads_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "import benchmark.reference.step, benchmark.reference.model; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'mpgan_tpu_torch', 'mpgan_tpu', 'jax'}))")
    out = subprocess.run([sys.executable, "-c", code, str(REPO)], capture_output=True,
                         text=True, check=True).stdout.strip()
    assert out == "[]"


def test_a_cpu_cell_loads_no_jax(tmp_path):
    """The harness and a whole CPU-sized run leave no module whose top-level
    name is ``jax`` or ``mpgan_tpu`` (compared whole: ``mpgan_tpu_torch`` is
    the program)."""
    root = tiny_root(tmp_path)
    code = ("import sys, torch; sys.path.insert(0, sys.argv[1]); from benchmark import harness;"
            "import pathlib;"
            "r = harness.run(pathlib.Path(sys.argv[2]), 'tiny-train', 3, 0.1, False, "
            "torch.device('cpu'), 0.0); "
            "top = {m.split('.')[0] for m in sys.modules}; "
            "print(r['correct'], sorted(top & {'jax', 'jaxlib', 'flax', 'mpgan_tpu'}), "
            "'mpgan_tpu_torch' in top)")
    out = subprocess.run([sys.executable, "-c", code, str(REPO), str(root)],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()
    assert out[-1] == "True [] True"


def test_threefry_and_dropout_hashes_are_the_programs():
    """The frozen draws equal the program's, bit for bit (noise, uniforms, the
    dropout seeds and both hashes)."""
    from mpgan_tpu_torch.ops import knn_kernels, linear, mp_kernels, prng
    seed, path = 2**31 + 77, (3, 1, 0)
    key = rng.at(rng.root_key(seed), path)
    kt = prng.PRNGKey(seed)
    assert torch.equal(prng.draw(kt, [prng.Row("normal", (4, 30, 32), path, 0.2)])[0],
                       rng.normal(key, (4, 30, 32), 0.2))
    assert torch.equal(prng.draw(kt, [prng.Row("uniform", (999,), path, -1.0, 2.0)])[0],
                       rng.uniform(key, (999,), -1.0, 2.0))
    words = prng.draw(kt, [prng.Row("words", (1,), path)])[0]
    edge = int(prng.draw(kt, [prng.Row("edge_seed", (1,), path)])[0])
    assert int(words) & rng.M32 == rng.hash_seed(key) and edge == rng.edge_seed(key)
    x = torch.randn(3, 7, 40)
    assert torch.equal(linear.hash_dropout(x, 0.5, words), rng.node_dropout(x, 0.5, key))
    assert torch.equal(mp_kernels._dropmul(mp_kernels.pair_ids(2, 30, "cpu"), 96, 0.5, edge, 1),
                       rng.edge_dropout_multiplier(rng.dense_edge_ids(2, 30, "cpu"), 96, 0.5,
                                                   edge, 1))
    assert torch.equal(
        mp_kernels._dropmul(knn_kernels.knn_pair_ids(2, 150, 20, "cpu"), 160, 0.5, edge, 2),
        rng.edge_dropout_multiplier(rng.knn_edge_ids(2, 150, 20, "cpu"), 160, 0.5, edge, 2))


@pytest.mark.parametrize("knn", [False, True], ids=["dense", "knn"])
def test_reference_agrees_with_the_programs_plain_path(tmp_path, knn):
    """G, D, the losses and the RMSprop steps of the reference, from the same
    weights and draws, against the program's step (its kernels' plain versions
    on the CPU): the first step's numbers at rounding level, the later ones
    (which carry RMSprop's first update of rounding-sized gradients) within
    the tiny cell's limits."""
    from benchmark import harness
    root = tiny_root(tmp_path, knn=knn)
    out = harness.run(root, "tiny-train", 9, 0.1, False, torch.device("cpu"), 0.0)
    assert out["correct"] is True, out["checks"]
    assert out["checks"]["loss1_gap"]["value"] < 1e-6, out["checks"]
    assert out["checks"]["dgrad_gap"]["value"] < 1e-5, out["checks"]
    out = harness.run(root, "tiny-gen", 9, 0.1, False, torch.device("cpu"), 0.0)
    assert out["correct"] is True and out["checks"]["max_err"]["value"] < 1e-6


def test_knn_selection_is_the_programs():
    """The reference's k nearest senders equal the program's search on the same inputs."""
    from mpgan_tpu_torch.ops import knn_kernels

    from benchmark.reference import model
    g = torch.Generator().manual_seed(0)
    xs = torch.randn(3, 150, 32, generator=g)
    xf = xs * torch.where(torch.rand(3, 150, 1, generator=g) < 0.2, 1e4, 1.0)
    assert torch.equal(model.knn_select(xs, xf, 20),
                       knn_kernels.knn_select_reference(xs, xf, 20, True).long())


def test_run_without_a_card_or_the_program_prints_no_result(tmp_path):
    """In a directory with only the manifest and the benchmark's files (no
    program), and without a CUDA device, a run exits non-zero and prints no result."""
    import shutil
    shutil.copytree(REPO / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "mpgan30-train",
                           "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                          capture_output=True, text=True, env={"PATH": "/usr/bin:/bin"})
    assert proc.returncode != 0
    assert not any(line.startswith("{") for line in proc.stdout.splitlines())
