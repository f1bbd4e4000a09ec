"""The PyTorch port's evaluation stack against the JAX package, on the CPU.

The same numpy inputs, made from a seed, go through ``mpgan_tpu.evaluation``
and ``mpgan_tpu_torch.evaluation``:

- the EFP basis (primes, composites, the ``n4d4`` set) equals JAX's exactly;
- ``efps`` on the float64 path equals JAX's numpy path at rtol 1e-10, and on
  the FP32 path JAX's jitted path at rtol 2e-3, atol 1e-9 (the JAX package's
  own bar, ``tests/test_data_eval.py``);
- each graph's contraction plan keeps every intermediate at two particle
  indices and calls ``torch.einsum`` with two operands, so ``efps`` does not
  depend on ``opt_einsum``;
- ``w1efp``, ``frechet_distance``, ``fgd_inf``, ``fpd`` and the Sinkhorn EMD
  equal JAX's at rtol 1e-9, coverage exactly.
"""

import importlib
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one thread a test worker: the suite runs in parallel workers

from mpgan_tpu.evaluation import efp as jefp
from mpgan_tpu.evaluation import w1 as jw1
from mpgan_tpu_torch.evaluation import efp as tefp
from mpgan_tpu_torch.evaluation import w1 as tw1

# the packages export functions named like their modules
jcov = importlib.import_module("mpgan_tpu.evaluation.cov_mmd")
tcov = importlib.import_module("mpgan_tpu_torch.evaluation.cov_mmd")
jfpd = importlib.import_module("mpgan_tpu.evaluation.fpd")
tfpd = importlib.import_module("mpgan_tpu_torch.evaluation.fpd")

SELECTS = ["d<=4", "d<=4-all", "n4d4"]


def _jets(b, n, seed=0, pad=True, dtype=np.float32):
    """Jet-like clouds [eta, phi, pt], zero-padded past a random multiplicity."""
    rng = np.random.default_rng(seed)
    jets = np.zeros((b, n, 3))
    jets[..., :2] = rng.normal(0, 0.15, (b, n, 2))
    jets[..., 2] = rng.exponential(1.0, (b, n))
    jets[..., 2] /= jets[..., 2].sum(axis=1, keepdims=True)
    if pad:
        counts = rng.integers(max(n // 3, 1), n + 1, size=b)
        jets[np.arange(n)[None, :] >= counts[:, None]] = 0
    return jets.astype(dtype)


def test_efp_basis_equals_jax():
    assert tefp.efp_multigraphs(4) == jefp.efp_multigraphs(4)
    assert len(tefp.efp_multigraphs(4)) == 20
    assert tefp.efp_composites(4) == jefp.efp_composites(4)
    assert len(tefp.efp_composites(4)) == 15
    for select in SELECTS:
        assert tefp._select_graphs(select) == jefp._select_graphs(select)
    assert len(tefp._select_graphs("n4d4")) == 5
    for g in tefp.efp_multigraphs(4):
        assert tefp._einsum_spec(g) == jefp._einsum_spec(g)


@pytest.mark.parametrize("select", SELECTS)
@pytest.mark.parametrize("b,n", [(32, 30), (4, 150)])
def test_efps_float64_path_equals_jax_numpy(select, b, n):
    jets = _jets(b, n, seed=n)
    want = jefp.efps(jets, select=select, use_jax=False)
    got = tefp.efps(jets, select=select, use_device=False)
    assert got.dtype == np.float64 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-10)


@pytest.mark.parametrize("select", SELECTS)
def test_efps_fp32_path_equals_jax_jit(select):
    jets = _jets(64, 30, seed=1)
    want = jefp.efps(jets, select=select, use_jax=True)
    got = tefp.efps(jets, select=select, device="cpu", use_device=True, batch_size=48)
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=1e-9)


def test_efps_size_rule_picks_the_path(monkeypatch):
    """Below the device type's B * N^2 threshold the float64 CPU path runs;
    above it the FP32 path on the given device (here the CPU)."""
    jets = _jets(16, 30, seed=2)
    f64 = tefp.efps(jets, device="cpu", use_device=False)
    f32 = tefp.efps(jets, device="cpu", use_device=True)
    assert not np.array_equal(f64, f32)
    np.testing.assert_array_equal(tefp.efps(jets, device="cpu"), f64)
    monkeypatch.setitem(tefp.DEVICE_THRESHOLD, "cpu", 16 * 30**2 - 1)
    np.testing.assert_array_equal(tefp.efps(jets, device="cpu"), f32)


def test_contraction_plans_keep_intermediates_at_two_particle_indices():
    """Each prime's plan: pairwise steps of at most two particle indices, equal
    to the graph's one many-operand einsum (``_einsum_spec``)."""
    gen = torch.Generator().manual_seed(0)
    theta = torch.rand(3, 5, 5, generator=gen, dtype=torch.float64)
    z = torch.rand(3, 5, generator=gen, dtype=torch.float64)
    for graph in tefp.efp_multigraphs(4):
        plan = tefp.contraction_plan(graph)
        n_verts = len({v for e in graph for v in e})
        assert len(plan) == len(graph) + n_verts - 1
        for _, _, spec in plan:
            ins, out = spec.split("->")
            assert len(ins.split(",")) == 2
            assert all(len(t) - 1 <= 2 for t in ins.split(",") + [out]), (graph, spec)
        assert plan[-1][2].endswith("->z")
        want = torch.einsum(tefp._einsum_spec(graph), *([theta] * len(graph) + [z] * n_verts))
        got = tefp._run_plan(plan, theta, z, len(graph), n_verts)
        torch.testing.assert_close(got, want, rtol=1e-12, atol=0)


def test_efps_without_opt_einsum_is_fast_and_equal(monkeypatch):
    """With ``opt_einsum`` off, torch contracts a many-operand einsum left to
    right; the plans never give it more than two, and no result exceeds
    ``[chunk, N, N]``."""
    jets = _jets(256, 30, seed=3)
    enabled = tefp.efps(jets, select="d<=4-all", use_device=False)
    calls = []
    einsum = torch.einsum

    def checked(spec, *ops):
        out = einsum(spec, *ops)
        calls.append((len(ops), out.dim()))
        return out

    monkeypatch.setattr(torch.backends.opt_einsum, "enabled", False)
    monkeypatch.setattr(torch, "einsum", checked)
    t0 = time.perf_counter()
    disabled = tefp.efps(jets, select="d<=4-all", use_device=False)
    seconds = time.perf_counter() - t0
    np.testing.assert_array_equal(disabled, enabled)
    assert calls and max(ops for ops, _ in calls) == 2
    assert max(dim for _, dim in calls) <= 3
    assert seconds < 20, seconds


def test_w1efp_equals_jax():
    real, gen = _jets(300, 30, seed=4), _jets(300, 30, seed=5)
    gen[..., 2] *= 1.05
    for kw in ({}, {"average_over_efps": True}, {"efp_select": "d<=4"}):
        want = jw1.w1efp(real, gen, num_eval_samples=100, num_batches=3, **kw)
        got = tw1.w1efp(real, gen, num_eval_samples=100, num_batches=3, device="cpu", **kw)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, b, rtol=1e-9)


def _features(n, dim, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, dim)) @ (np.eye(dim) + 0.3 * rng.normal(size=(dim, dim))) * scale


def test_frechet_distance_equals_jax():
    a, b = _features(500, 35, 6), _features(500, 35, 7, scale=1.2)
    for x, y in ((a, b), (a, a), (b, a)):
        moments = (x.mean(0), np.cov(x, rowvar=False), y.mean(0), np.cov(y, rowvar=False))
        want = jfpd.frechet_distance(*moments)
        np.testing.assert_allclose(tfpd.frechet_distance(*moments), want, rtol=1e-9, atol=1e-12)
    assert tfpd.frechet_distance(0.0, 1.0, 1.0, 1.0) == jfpd.frechet_distance(0.0, 1.0, 1.0, 1.0)


def test_fgd_inf_and_fpd_equal_jax():
    real, gen = _features(2000, 35, 8), _features(2000, 35, 9, scale=1.1)
    kw = dict(min_samples=500, max_samples=2000, num_batches=4)
    np.testing.assert_allclose(tfpd.fgd_inf(real, gen, **kw), jfpd.fgd_inf(real, gen, **kw),
                               rtol=1e-9)
    real_jets, gen_jets = _jets(400, 30, seed=10), _jets(400, 30, seed=11)
    kw = dict(min_samples=100, max_samples=400)
    # precomputed EFPs are used as given
    re, ge = jefp.efps(real_jets, "d<=4-all"), jefp.efps(gen_jets, "d<=4-all")
    np.testing.assert_allclose(tfpd.fpd(None, None, real_efps=re, gen_efps=ge, **kw),
                               jfpd.fpd(None, None, real_efps=re, gen_efps=ge, **kw), rtol=1e-9)
    # from jets: the port's EFPs (held to JAX's at 1e-10 above) through JAX's
    # protocol. Against JAX's own EFPs the two differ by more than 1e-9: this
    # FPD amplifies ulp-level differences of its EFPs (the standardized
    # composites are nearly collinear, and the fit extrapolates to 1/N = 0)
    tre = tefp.efps(real_jets, "d<=4-all", use_device=False)
    tge = tefp.efps(gen_jets, "d<=4-all", use_device=False)
    np.testing.assert_allclose(tfpd.fpd(real_jets, gen_jets, device="cpu", **kw),
                               jfpd.fpd(None, None, real_efps=tre, gen_efps=tge, **kw),
                               rtol=1e-9)


def test_fpd_scores_nonfinite_features_as_inf():
    """The cases of ``tests/test_data_eval.py``: contaminated features score
    inf in both packages, never a silently finite fit."""
    rng = np.random.default_rng(0)
    real = np.abs(rng.normal(size=(2000, 20)))
    gen = np.abs(rng.normal(size=(2000, 20)))
    gen[5, 3] = np.inf
    gen[17, 0] = np.nan
    kw = dict(min_samples=500, max_samples=2000, num_batches=5)
    val, std = tfpd.fgd_inf(real, gen, **kw)
    assert np.isinf(val) and np.isinf(std)
    assert (val, std) == jfpd.fgd_inf(real, gen, **kw)
    moments = (real.mean(0), np.cov(real, rowvar=False), gen.mean(0), np.cov(gen, rowvar=False))
    assert tfpd.frechet_distance(*moments) == float("inf") == jfpd.frechet_distance(*moments)
    re = np.abs(rng.normal(size=(400, 35)))
    ge = re.copy()
    ge[3, 0] = np.inf
    assert np.isinf(tfpd.fpd(None, None, min_samples=100, max_samples=400,
                             real_efps=re, gen_efps=ge)[0])


@pytest.mark.parametrize("n", [10, 30])
def test_pairwise_emd_equals_jax(n):
    gen, real = _jets(12, n, seed=12 + n), _jets(12, n, seed=13 + n)
    gen[0] = 0  # an empty jet: all of the other side's pT goes to the ghost
    want = jcov._pairwise_emd(gen, real)
    got = tcov._pairwise_emd(gen, real, device="cpu")
    assert got.dtype == np.float64 and got.shape == (12, 12)
    np.testing.assert_allclose(got, want, rtol=1e-9)


def test_cov_mmd_equals_jax():
    real, gen = _jets(80, 30, seed=14), _jets(80, 30, seed=15)
    gen[..., :2] *= 1.3
    want = jcov.cov_mmd(real, gen, num_eval_samples=16, num_batches=3, seed=5)
    got = tcov.cov_mmd(real, gen, num_eval_samples=16, num_batches=3, seed=5, device="cpu")
    assert got[0] == want[0]
    np.testing.assert_allclose(got[1], want[1], rtol=1e-9)
