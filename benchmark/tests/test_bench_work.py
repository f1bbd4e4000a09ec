"""The work counts against hand counts: what an operation needs, never a recompute."""

from __future__ import annotations

import json

import pytest

from benchmark import work
from benchmark.tests.tiny import REPO

FLAGSHIP = json.loads((REPO / "benchmark/configs/mpgan-30p-flagship.json").read_text())["args"]
KNN = json.loads((REPO / "benchmark/configs/mpgan-150p-knn20.json").read_text())["args"]


def _layer(b=256, n=30, senders=30, knn=False):
    return work.Layer(b, n, senders, 32, (96, 160, 192), (224, 256, 256, 32), knn)


def test_one_flagship_fe_chain_is_21_2_gflop():
    # 2 B N N (96*160 + 160*192) at B=256, N=30
    assert work.chain_fwd(_layer()).flops == 2 * 256 * 30 * 30 * 46080
    assert round(work.chain_fwd(_layer()).flops / 1e9, 1) == 21.2


def test_flagship_step_fe_chains_without_recompute():
    """Ten chain forwards, six backwards with weight gradients (da and dW: two
    chains) and two without (da: one chain): 24 chains, 509.6 GFLOP. The
    recompute-counting tally of PERF.md before this benchmark (three and two
    chains a backward) gave 32 chains, 679 GFLOP."""
    chain = work.chain_fwd(_layer()).flops
    step = work.train_step(FLAGSHIP)
    fn_part = sum(2 * 256 * 30 * work.macs(lyr.fn) for lyr in work.models(FLAGSHIP, 256)[0].layers)
    chains = (step["edge_fwd"].flops + step["edge_bwd"].flops + step["edge_fn"].flops
              - fn_part) / chain
    assert chains == pytest.approx(24)
    assert round(24 * chain / 1e9, 1) == 509.6
    assert round(32 * chain / 1e9) == 679


@pytest.mark.parametrize("knn", [False, True])
def test_a_backward_at_peak_reads_one(knn):
    """A backward counts da and dW once each: a recompute-free backward that
    ran at the peak would read 100% of its roofline, not 150%."""
    lyr = _layer(160, 150, 20, True) if knn else _layer()
    fwd = 2 * lyr.edges * work.macs(lyr.fe)
    assert work.chain_bwd(lyr, True).flops == 2 * fwd
    assert work.chain_bwd(lyr, False).flops == fwd


def test_bytes_are_each_input_once():
    lyr = _layer()
    nodes, h1, hl = 256 * 30, 96, 192
    weights = 96 * 160 + 160 * 192 + 160 + 192
    assert work.chain_fwd(lyr).bytes == 4 * (2 * nodes * h1 + nodes + weights + nodes * hl)


def test_knn_step_has_no_dense_kernel_work():
    step = work.train_step(KNN)
    assert set(step) == {"model", "knn_fwd", "knn_bwd"}
    assert set(work.gen_batch(KNN)) == {"model", "knn_fwd"}
    assert set(work.gen_batch(FLAGSHIP)) == {"model", "edge_fn"}


def test_model_flops_cover_every_kernel_family():
    """The whole step's products hold every kernel family's: ``train_mfu``
    bounds the rooflines."""
    for args in (FLAGSHIP, KNN):
        for counts in (work.train_step(args), work.gen_batch(args)):
            kernels = sum(w.flops for k, w in counts.items() if k != "model")
            assert kernels <= counts["model"].flops
