"""The numerics of the bf16 modes' backward products on the card, on the CPU.

The bf16 modes of K3 and K6 (``csrc/edge_bwd_tf32x3.cuh``) take the backward's
float32 products ``da = dz W^T`` and ``dW = a^T dz`` on the tensor cores as
split-TF32: an operand ``x`` is split into ``hi = tf32(x)`` and ``lo = tf32(x -
hi)`` (round to nearest, ties away: ``cvt.rna``), and ``x y`` is taken as
``lo_x hi_y + hi_x lo_y + hi_x hi_y`` with float32 sums. Here:

- an emulation of that product (TF32 rounding on float32 bits) against float64
  within 2^-20 of ``|A| |B|`` at the contraction lengths of K3 and K6 (pass rows
  32-128, widths 96-256), where one TF32 product is 100-300 times further off;
- the weights of the bf16 mode split with a zero ``lo`` (bf16 values are TF32
  values), so ``da`` needs two products, as the kernel takes it;
- the bf16 backward of K3 and of K6 with both products through the emulation
  (B = 2, N = 8, k = 4, widths up to 16): against the JAX package's Pallas
  backward on bf16 refs (``jax.grad`` of the custom VJPs, interpret mode) within
  the bf16 tolerances of ``tests/test_torch_bf16.py`` and
  ``tests/test_torch_bf16_knn.py``, and against the port's plain bf16 backward
  (float32 products) within a relative L2 error of 1e-5 per output;
- the bf16 packed weights' size (the recompute's bf16 copy, W^T once).

The kernels themselves against their plain versions: ``tests/test_torch_cuda_kernels.py``
(card only).
"""

from __future__ import annotations

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one thread a test worker: the suite runs in parallel workers

import jax
import jax.numpy as jnp

import mpgan_tpu.ops.knn_pallas as jknn
import mpgan_tpu.ops.mp_pallas as jmpp
from mpgan_tpu_torch.ops import knn_kernels as tkk
from mpgan_tpu_torch.ops import mp_kernels as tmk

BF16_TOL = dict(rtol=1e-2, atol=1e-2)
SEED = int(np.float32(123456789))
SPLIT_REL = 2.0 ** -20
PLAIN_REL_L2 = 1e-5
WIDTHS = (16, 12, 10)
B, N, K = 2, 8, 4


def tf32(x: np.ndarray) -> np.ndarray:
    """``x`` (float32) rounded to TF32, to nearest with ties away from zero
    (``cvt.rna.tf32.f32``): the low 13 bits of the fraction dropped."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    hi = tf32(x)
    return hi, tf32((x - hi).astype(np.float32))


def split_tf32_matmul(a: torch.Tensor, b: torch.Tensor, matmul=torch.matmul) -> torch.Tensor:
    """float32 ``a @ b`` as the card's split-TF32 stage takes it: lo_a hi_b +
    hi_a lo_b + hi_a hi_b, each product exact in float32, the sums in float32."""
    (ah, al), (bh, bl) = (tuple(torch.from_numpy(t) for t in split(x.detach().numpy()))
                          for x in (a, b))
    return matmul(al, bh) + matmul(ah, bl) + matmul(ah, bh)


def with_split_products(module, monkeypatch):
    """Routes ``module``'s ``torch.matmul`` through the emulation. The recompute's
    products take bf16 operands, whose lo is zero: they come out bit for bit."""
    real = torch

    class Proxy(types.ModuleType):
        def __getattr__(self, name):
            return getattr(real, name)

    calls = []

    def matmul(a, b):
        calls.append(a.shape)
        return split_tf32_matmul(a, b, real.matmul)

    proxy = Proxy("torch")
    proxy.matmul = matmul
    monkeypatch.setattr(module, "torch", proxy)
    return calls


@pytest.mark.parametrize("length", [32, 64, 128, 96, 160, 192, 256])
def test_split_tf32_product_within_2_to_the_minus_20_of_float64(length):
    rng = np.random.RandomState(length)
    a = rng.randn(64, length).astype(np.float32)
    b = (rng.randn(length, 48) * 3).astype(np.float32)
    exact = a.astype(np.float64) @ b.astype(np.float64)
    scale = np.abs(a).astype(np.float64) @ np.abs(b).astype(np.float64)
    got = split_tf32_matmul(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert np.max(np.abs(got - exact) / scale) <= SPLIT_REL
    one = (torch.from_numpy(tf32(a)) @ torch.from_numpy(tf32(b))).numpy()
    assert np.max(np.abs(one - exact) / scale) > 50 * SPLIT_REL  # one TF32 product is not enough


def test_tf32_rounds_to_nearest_with_ties_away_and_splits_exactly():
    x = np.array([1 + 2.0 ** -11, 1 + 2.0 ** -11 + 2.0 ** -20, -(1 + 2.0 ** -11), 1 + 2.0 ** -12,
                  3.0, 0.0], np.float32)
    np.testing.assert_array_equal(tf32(x), np.array([1 + 2.0 ** -10, 1 + 2.0 ** -10,
                                                     -(1 + 2.0 ** -10), 1.0, 3.0, 0.0],
                                                    np.float32))
    v = np.random.RandomState(0).randn(4096).astype(np.float32)
    hi, lo = split(v)
    assert np.all((hi.view(np.uint32) & 0x1FFF) == 0) and np.all((lo.view(np.uint32) & 0x1FFF) == 0)
    err = np.abs(hi.astype(np.float64) + lo - v) / np.abs(v)
    assert err.max() <= 2.0 ** -21


def test_bf16_weights_split_with_a_zero_lo():
    """W^T of the da products holds the float32 values of bf16 weights: TF32
    holds them exactly, so hi_dz lo_W is zero and da takes two products."""
    w = torch.randn(256, 256).to(torch.bfloat16).float().numpy()
    hi, lo = split(w)
    np.testing.assert_array_equal(hi, w)
    assert not lo.any()


def _tb(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a)).to(torch.bfloat16)


def _jb(a):
    return None if a is None else jnp.asarray(a).astype(jnp.bfloat16)


def _close(t, j, scaled=True):
    """A port gradient against a JAX one in the same dtype at BF16_TOL, on the
    scale of the largest of ``j`` (a pre-activation within rounding of zero may
    take the other LeakyReLU slope)."""
    assert str(t.dtype).split(".")[-1] == str(j.dtype)
    t, j = t.float().numpy(), np.asarray(j.astype(jnp.float32))
    bound = max(1.0, np.abs(j).max()) if scaled else 1.0
    np.testing.assert_allclose(t / bound, j / bound, **BF16_TOL)


def _rel_l2(t, r):
    t, r = t.float(), r.float()
    return ((t - r).norm() / r.norm().clamp_min(1e-30)).item()


def _chain(rng, widths=WIDTHS):
    f = lambda *s, scale=1.0: (rng.randn(*s) * scale).astype(np.float32)  # noqa: E731
    hidden = []
    for a, c in zip(widths[:-1], widths[1:]):
        hidden += [f(a, c, scale=a ** -0.5), f(c, scale=0.1)]
    return f, tuple(hidden)


@pytest.mark.parametrize("need_wgrads", [True, False])
@pytest.mark.parametrize("sum_agg,dropout_p", [(True, 0.0), (False, 0.5)])
def test_k3_bf16_backward_with_split_products(monkeypatch, need_wgrads, sum_agg, dropout_p):
    rng = np.random.RandomState(3)
    f, hidden = _chain(rng)
    u1, u2 = f(B, N, WIDTHS[0], scale=0.5), f(B, N, WIDTHS[0], scale=0.5)
    mask = (rng.rand(B, N, 1) > 0.3).astype(np.float32)
    g = f(B, N, WIDTHS[-1])
    args = (_tb(u1), _tb(u2), _tb(mask), tuple(map(_tb, hidden)), _tb(g), 0.2, sum_agg,
            dropout_p, SEED, need_wgrads)
    plain = tmk.edge_aggregate_bwd_reference(*args)
    calls = with_split_products(tmk, monkeypatch)
    split_out = tmk.edge_aggregate_bwd_reference(*args)
    monkeypatch.undo()
    assert len(calls) == 2 + (4 if need_wgrads else 2)  # the recompute's, then dW and da

    def loss(u1, u2, mask, hidden):
        out = jmpp.edge_aggregate(u1, u2, mask, hidden, jnp.float32(SEED), 0.2, sum_agg, 32,
                                  dropout_p, need_wgrads)
        return jnp.sum(out.astype(jnp.float32) * _jb(g).astype(jnp.float32))

    ju1, ju2, jmask, jhidden = jax.grad(loss, argnums=(0, 1, 2, 3))(
        _jb(u1), _jb(u2), _jb(mask), tuple(map(_jb, hidden)))
    outs = (*split_out[:3], *split_out[3])
    for t, j in zip(outs, (ju1, ju2, jmask, *jhidden)):
        _close(t, j)
    for t, r in zip(outs, (*plain[:3], *plain[3])):
        assert t.dtype == r.dtype == torch.bfloat16
        if r.any():
            assert _rel_l2(t, r) <= PLAIN_REL_L2
        else:
            assert not t.any()


@pytest.mark.parametrize("want_dists,dropout_p,need_wgrads", [
    (True, 0.5, True), (False, 0.0, True), (True, 0.0, False)])
def test_k6_bf16_backward_with_split_products(monkeypatch, want_dists, dropout_p, need_wgrads):
    rng = np.random.RandomState(6)
    f, hidden = _chain(rng)
    x = f(B, N, 3, scale=0.3)
    mask = (np.arange(N)[None, :] < np.array([N, 6])[:, None]).astype(np.float32)[..., None]
    xf = (((1 - 1e4) * mask + 1e4) * x).astype(np.float32)
    u1, u2 = f(B, N, WIDTHS[0], scale=0.5), f(B, N, WIDTHS[0], scale=0.5)
    u2m = np.concatenate([u2, mask], axis=-1)
    w_d, g = f(WIDTHS[0], scale=0.3), f(B, N, WIDTHS[-1])
    _, idx, dists = tkk.knn_fused_layer(_tb(x), _tb(xf), _tb(u1), _tb(u2m), _tb(w_d),
                                        tuple(map(_tb, hidden)), K, False, True, 0.2, True,
                                        dropout_p, SEED, True)
    args = (_tb(u1), _tb(u2m), idx, dists if want_dists else None,
            _tb(w_d) if want_dists else None, tuple(map(_tb, hidden)), _tb(g), 0.2, True,
            dropout_p, SEED, need_wgrads)
    plain = tkk.knn_edge_aggregate_bwd_reference(*args)
    calls = with_split_products(tkk, monkeypatch)
    split_out = tkk.knn_edge_aggregate_bwd_reference(*args)
    monkeypatch.undo()
    assert len(calls) == 2 + (4 if need_wgrads else 2)  # the recompute's, then dW and da

    def loss(xs, xf, u1, u2m, w_d, hidden):
        out = jknn.knn_fused_layer(xs, xf, u1, u2m, w_d, hidden,
                                   jnp.float32(SEED) if dropout_p > 0 else None, K, False,
                                   want_dists, 0.2, True, dropout_p, need_wgrads)
        return jnp.sum(out.astype(jnp.float32) * _jb(g).astype(jnp.float32))

    jg = jax.grad(loss, argnums=(0, 1, 2, 3, 4, 5))(
        _jb(x), _jb(xf), _jb(u1), _jb(u2m), _jb(w_d) if want_dists else None,
        tuple(map(_jb, hidden)))
    du1, du2, dmask, ddists, dw_d, dhidden = split_out
    pairs = [(du1, jg[2]), (torch.cat([du2, dmask], dim=-1), jg[3])]
    if need_wgrads:
        pairs += list(zip(dhidden, jg[5])) + ([(dw_d, jg[4])] if want_dists else [])
    for t, j in pairs:
        _close(t, j)
    for t, r in zip((du1, du2, dmask, ddists, dw_d, *dhidden),
                    (*plain[:5], *plain[5])):
        if r is None:
            assert t is None
        elif r.any():
            assert t.dtype == r.dtype and _rel_l2(t, r) <= PLAIN_REL_L2
        else:
            assert not t.any()


@pytest.mark.parametrize("dims", [[96, 160, 192], [20, 13, 12], [250, 255, 256, 249, 200],
                                  [13, 9, 11, 5], [96]])
def test_bf16_backward_packs_w_transpose_once(dims):
    """Per hidden layer ``[k x m]``: the recompute's bf16 copy (k to 16, m to 8,
    two values a float), W^T for da once (its lo slab would be zeros: m and k to
    8) and the float32 bias (to 4); the same at every pass size, so the bf16
    mode's launches take the FP32 mode's plan (``bwd_plan``) as they are."""
    ceil = lambda v, q: -(-v // q) * q  # noqa: E731
    want = sum(ceil(k, 16) * ceil(m, 8) // 2 + ceil(m, 8) * ceil(k, 8) + ceil(m, 4)
               for k, m in zip(dims[:-1], dims[1:]))
    for rows in (32, 64, 128):
        assert tmk.bwd_packed_floats_bf16(dims, rows) == want
