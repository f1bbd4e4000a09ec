"""The CUDA kernels against their plain PyTorch versions, on an NVIDIA GPU.

Marked ``cuda``: they skip where ``torch.cuda.is_available()`` is false (no
CUDA kernel runs on the CPU). Run them on a GPU machine with
``python -m pytest tests/test_torch_cuda_kernels.py -q --noconftest`` (the
suite's conftest imports jax, which the port does not need). Flagship widths;
tolerance rtol = atol = 1e-4 (FP32 FMA chains against cuBLAS FP32, TF32 off);
weight gradients, which sum every pair row, within 1e-4 of max(1, max|ref|).
"""

import ctypes
import dataclasses
import types

import pytest

torch = pytest.importorskip("torch")

from mpgan_tpu_torch.models.mpgan import MPDiscriminator, MPGenerator
from mpgan_tpu_torch.ops import _build
from mpgan_tpu_torch.ops import knn_kernels as kk
from mpgan_tpu_torch.ops import mp_kernels as mk
from mpgan_tpu_torch.ops import prng
from mpgan_tpu_torch.ops.keys import Keys
from mpgan_tpu_torch.training.config import (
    build_mpgan_discriminator,
    build_mpgan_generator,
    from_args_dict,
)

pytestmark = pytest.mark.cuda
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(dev, b, n, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *s, scale=1.0: torch.randn(*s, generator=g, device=dev) * scale
    widths = [96, 160, 192]
    hidden = []
    for a, c in zip(widths[:-1], widths[1:]):
        hidden += [r(a, c, scale=a ** -0.5), r(c, scale=0.1)]
    mask = (torch.rand(b, n, 1, generator=g, device=dev) > 0.3).float()
    fn = (r(192, 256, scale=224 ** -0.5), r(32, 256, scale=224 ** -0.5), r(256, scale=0.1),
          r(256, 256, scale=1 / 16), r(256, scale=0.1), r(256, 3, scale=1 / 16), r(3, scale=0.1))
    return r(b, n, 96, scale=0.5), r(b, n, 96, scale=0.5), mask, tuple(hidden), r(b, n, 32), fn


@pytest.mark.parametrize("sum_agg", [True, False])
@pytest.mark.parametrize("b,n", [(64, 30), (4, 150), (3, 13)])
def test_edge_aggregate_kernel_matches_plain(dev, sum_agg, b, n):
    u1, u2, mask, hidden, _, _ = _inputs(dev, b, n)
    before = mk.launch_counts["edge_aggregate"]
    out = mk.edge_aggregate(u1, u2, mask, hidden, 0.2, sum_agg)
    torch.cuda.synchronize()
    assert mk.launch_counts["edge_aggregate"] == before + 1
    ref = mk.edge_aggregate_reference(u1, u2, mask, hidden, 0.2, sum_agg)
    torch.testing.assert_close(out, ref, **TOL)


@pytest.mark.parametrize("final_linear", [True, False])
@pytest.mark.parametrize("sum_agg", [True, False])
@pytest.mark.parametrize("b,n", [(64, 30), (4, 150)])
def test_edge_aggregate_fn_kernel_matches_plain(dev, final_linear, sum_agg, b, n):
    u1, u2, mask, hidden, x, fn = _inputs(dev, b, n)
    out = mk.edge_aggregate_fn(u1, u2, mask, hidden, x, fn, 0.2, sum_agg, 0.2, final_linear)
    torch.cuda.synchronize()
    ref = mk.edge_aggregate_fn_reference(u1, u2, mask, hidden, x, fn, 0.2, sum_agg, 0.2,
                                         final_linear)
    torch.testing.assert_close(out, ref, **TOL)


@pytest.mark.parametrize("b,n,fe,feat,fn", [
    (3, 70, [96, 160, 192], 32, [64, 5]),    # several receiver groups per jet
    (2, 45, [64, 256, 224], 32, [256, 8]),   # wide layers: the pass shrinks to fit
    (2, 5, [96], 16, [20]),                   # fe without hidden layers
    (2, 33, [30, 50, 7], 6, [13, 3]),         # widths off the 4-column vector path
])
def test_kernels_match_plain_at_odd_shapes(dev, b, n, fe, feat, fn):
    g = torch.Generator(device=dev).manual_seed(n)
    r = lambda *s, scale=0.3: torch.randn(*s, generator=g, device=dev) * scale
    hidden = tuple(t for a, c in zip(fe[:-1], fe[1:]) for t in (r(a, c, scale=a ** -0.5), r(c)))
    fn_flat = [r(fe[-1], fn[0]), r(feat, fn[0]), r(fn[0])]
    for a, c in zip(fn[:-1], fn[1:]):
        fn_flat += [r(a, c, scale=a ** -0.5), r(c)]
    u1, u2, x = r(b, n, fe[0], scale=0.5), r(b, n, fe[0], scale=0.5), r(b, n, feat)
    mask = (torch.rand(b, n, 1, generator=g, device=dev) > 0.3).float()
    for sum_agg in (True, False):
        out = mk.edge_aggregate(u1, u2, mask, hidden, 0.2, sum_agg)
        ref = mk.edge_aggregate_reference(u1, u2, mask, hidden, 0.2, sum_agg)
        torch.testing.assert_close(out, ref, **TOL)
        out = mk.edge_aggregate_fn(u1, u2, mask, hidden, x, fn_flat, 0.2, sum_agg, 0.1, True)
        ref = mk.edge_aggregate_fn_reference(u1, u2, mask, hidden, x, fn_flat, 0.2, sum_agg,
                                             0.1, True)
        torch.testing.assert_close(out, ref, **TOL)


def test_wrappers_refuse_what_the_kernel_does_not_take(dev):
    u1, u2, mask, hidden, _, _ = _inputs(dev, 2, 30)
    with pytest.raises(TypeError, match="float32"):
        mk.edge_aggregate(u1.double(), u2.double(), mask.double(),
                          tuple(t.double() for t in hidden), 0.2, True)
    with pytest.raises(ValueError, match="contiguous"):
        mk.edge_aggregate(u1.transpose(0, 1).contiguous().transpose(0, 1), u2, mask, hidden,
                          0.2, True)
    wide = (torch.zeros(96, 300, device=dev), torch.zeros(300, device=dev))
    with pytest.raises(ValueError, match="cap"):
        mk.edge_aggregate(u1, u2, mask, wide, 0.2, True)
    w = hidden[0]
    misaligned = torch.empty(w.numel() + 1, device=dev)[1:].view(w.shape).copy_(w)
    with pytest.raises(ValueError, match="16-byte"):
        mk.edge_aggregate(u1, u2, mask, (misaligned,) + hidden[1:], 0.2, True)


def test_refused_launch_raises(dev):
    """A launch the launcher refuses returns a CUDA error code, and the wrapper's check raises."""
    u1, u2, mask, hidden, _, _ = _inputs(dev, 2, 30)
    out = torch.empty(2, 30, 192, device=dev)
    w, b = mk._chain_args(mk._pairs(hidden))
    dims = (ctypes.c_int * 3)(95, 160, 192)  # first width disagrees with u1's 96
    plan = mk.fwd_plan(2, 30, [96, 160, 192], mk._sm_count(dev))
    packed = torch.empty(mk.fwd_packed_floats([96, 160, 192], plan.rows), device=dev)
    code = _build.library().mpgan_edge_aggregate(
        u1.data_ptr(), u2.data_ptr(), mask.data_ptr(), out.data_ptr(), packed.data_ptr(), 2, 30,
        96, 2, w, b, dims, 0.2, 1, plan.ti, plan.jc, plan.rows, plan.grid, plan.slab_floats,
        torch.cuda.current_stream().cuda_stream,
    )
    assert code != 0
    with pytest.raises(RuntimeError, match="CUDA error"):
        _build.check(code, "edge_aggregate")


@pytest.mark.parametrize("num_hits", [30, 150])
def test_generator_kernel_path_matches_plain_path(dev, num_hits):
    cfg = build_mpgan_generator(from_args_dict({"model": "mpgan", "num_hits": num_hits}))
    g = MPGenerator(cfg, prng.PRNGKey(0), device=dev)
    noise = torch.randn(8, num_hits, 32, generator=torch.Generator(device=dev).manual_seed(1),
                        device=dev) * 0.2
    labels = torch.full((8, 1), 0.7, device=dev)
    with torch.inference_mode():
        y_kernel = g(noise, labels)
        g.cfg = dataclasses.replace(cfg, use_kernels=False)
        y_plain = g(noise, labels)
    torch.testing.assert_close(y_kernel, y_plain, **TOL)
    assert torch.equal(y_kernel[..., -1], y_plain[..., -1])


def test_150p_fe128_256_generator_kernel_path_matches_plain_path(dev):
    """The 150-particle dense ``--fe 128 256`` config: K2 on a one-hidden-layer
    chain, 128 -> 256."""
    cfg = build_mpgan_generator(from_args_dict({"model": "mpgan", "num_hits": 150,
                                                "fe": [128, 256]}))
    g = MPGenerator(cfg, prng.PRNGKey(0), device=dev)
    noise = torch.randn(4, 150, 32, generator=torch.Generator(device=dev).manual_seed(1),
                        device=dev) * 0.2
    labels = torch.full((4, 1), 0.7, device=dev)
    mk.reset_launch_counts()
    with torch.inference_mode():
        y_kernel = g(noise, labels)
        assert mk.launch_counts["edge_aggregate"] == 2
        g.cfg = dataclasses.replace(cfg, use_kernels=False)
        y_plain = g(noise, labels)
    torch.testing.assert_close(y_kernel, y_plain, **TOL)


# pass shapes of the persistent forward kernels: single jets and batches that
# leave fewer items than SMs or a ragged last round, the --fe 128 256 chain, a
# chain wide enough for a shorter pass, odd widths, one and no hidden layer
FWD_PASS_SHAPES = [
    (1, 30, [96, 160, 192]), (33, 30, [96, 160, 192]), (1, 150, [96, 160, 192]),
    (33, 150, [96, 160, 192]), (1, 150, [128, 256]), (4, 150, [128, 256]),
    (33, 150, [128, 256]), (3, 30, [250, 255, 256, 249, 200]), (2, 21, [30, 50, 7]),
    (2, 40, [13, 9, 11, 5]), (2, 33, [24, 16]), (2, 5, [96]),
]


@pytest.mark.parametrize("dropout_p,sum_agg", [(0.0, True), (0.5, False), (0.5, True)])
@pytest.mark.parametrize("b,n,widths", FWD_PASS_SHAPES)
def test_edge_aggregate_pass_shapes_match_plain_twice(dev, dropout_p, sum_agg, b, n, widths):
    """K2 (eval and with dropout) against its plain version at every pass shape,
    and two launches bit for bit (every sum has a fixed order)."""
    u1, u2, mask, hidden, _ = _chain(dev, b, n, widths, seed=n + b)
    args = (u1, u2, mask, hidden, 0.2, sum_agg, dropout_p, 8080)
    name = "edge_aggregate_train" if dropout_p > 0 else "edge_aggregate"
    before = mk.launch_counts[name]
    out = mk.edge_aggregate(*args)
    again = mk.edge_aggregate(*args)
    torch.cuda.synchronize()
    assert mk.launch_counts[name] == before + 2
    torch.testing.assert_close(out, mk.edge_aggregate_reference(*args), **TOL)
    assert torch.equal(out, again)


@pytest.mark.parametrize("sum_agg,final_linear", [(True, True), (False, False)])
@pytest.mark.parametrize("b,n,fe,feat,fn", [
    (1, 30, [96, 160, 192], 32, [256, 256, 3]),    # one jet: one item on one SM
    (33, 30, [96, 160, 192], 32, [256, 256, 32]),  # fewer items than SMs
    (601, 30, [96, 160, 192], 32, [256, 256, 3]),  # 4-jet items, a ragged last item and round
    (5, 64, [96, 160, 192], 32, [64, 5]),          # the gate's largest N: one jet an item
    (33, 13, [30, 50, 7], 6, [13, 3]),             # odd widths
    (2, 45, [64, 256, 224], 32, [256, 8]),         # wide: a 64-row pass
    (3, 5, [96], 16, [20]),                         # no hidden layer
])
def test_edge_aggregate_fn_pass_shapes_match_plain_twice(dev, sum_agg, final_linear, b, n, fe,
                                                         feat, fn):
    """K4 against its plain version at every pass shape, and two launches bit for bit."""
    g = torch.Generator(device=dev).manual_seed(n + b)
    r = lambda *s, scale=0.3: torch.randn(*s, generator=g, device=dev) * scale  # noqa: E731
    hidden = tuple(t for a, c in zip(fe[:-1], fe[1:]) for t in (r(a, c, scale=a ** -0.5), r(c)))
    full = [fe[-1] + feat] + fn
    fn_flat = [r(fe[-1], fn[0], scale=full[0] ** -0.5), r(feat, fn[0], scale=full[0] ** -0.5),
               r(fn[0])]
    for a, c in zip(fn[:-1], fn[1:]):
        fn_flat += [r(a, c, scale=a ** -0.5), r(c)]
    u1, u2, x = r(b, n, fe[0], scale=0.5), r(b, n, fe[0], scale=0.5), r(b, n, feat)
    mask = (torch.rand(b, n, 1, generator=g, device=dev) > 0.3).float()
    args = (u1, u2, mask, hidden, x, tuple(fn_flat), 0.2, sum_agg, 0.1, final_linear)
    before = mk.launch_counts["edge_aggregate_fn"]
    out = mk.edge_aggregate_fn(*args)
    again = mk.edge_aggregate_fn(*args)
    torch.cuda.synchronize()
    assert mk.launch_counts["edge_aggregate_fn"] == before + 2
    torch.testing.assert_close(out, mk.edge_aggregate_fn_reference(*args), **TOL)
    assert torch.equal(out, again)


def test_forward_plans_on_the_card_equal_the_launchers(dev):
    """The wrappers' shared-memory and packed-weight sizes of the forward launches,
    at the slab size the plan passes, are the launcher's own."""
    lib = _build.library()
    arr = lambda d: (ctypes.c_int * len(d))(*d)  # noqa: E731
    for dims, fn_dims in (([96, 160, 192], None), ([96, 160, 192], [224, 256, 256, 3]),
                          ([128, 256], None), ([30, 50, 7], [13, 13, 3]), ([96], [112, 20]),
                          ([64, 256, 224], [256, 256, 8]), ([8, 256], None)):
        for rows in (32, 64, 128):
            ti = rows // 8
            sizes = (ctypes.c_longlong * 2)()
            code = lib.mpgan_edge_fwd_sizes(len(dims) - 1, arr(dims),
                                            len(fn_dims) - 1 if fn_dims else 0,
                                            arr(fn_dims or [0]), rows, ti,
                                            mk.fwd_slab_floats(dims, rows, ti, fn_dims), sizes)
            smem = mk.fwd_smem_bytes(dims, rows, ti, fn_dims)
            if smem > mk.MAX_SMEM_BYTES:
                assert code == -1
                continue
            assert code == 0 and sizes[0] == smem
            assert sizes[1] == mk.fwd_packed_floats(dims, rows, fn_dims)


# ---------------------------------------------------------------------------
# train mode: K2 with dropout (K1) and K3
# ---------------------------------------------------------------------------


def _assert_wgrad_close(out, ref):
    bound = 1e-4 * max(1.0, ref.abs().max().item())
    assert (out - ref).abs().max().item() <= bound


def _chain(dev, b, n, widths, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *s, scale=0.5: torch.randn(*s, generator=g, device=dev) * scale  # noqa: E731
    hidden = tuple(t for a, c in zip(widths[:-1], widths[1:])
                   for t in (r(a, c, scale=a ** -0.5), r(c, scale=0.1)))
    mask = (torch.rand(b, n, 1, generator=g, device=dev) > 0.3).float()
    return r(b, n, widths[0]), r(b, n, widths[0]), mask, hidden, r(b, n, widths[-1])


@pytest.mark.parametrize("sum_agg", [True, False])
@pytest.mark.parametrize("b,n,widths", [
    (64, 30, [96, 160, 192]), (4, 150, [96, 160, 192]), (3, 13, [96, 160, 192]),
    (2, 13, [30, 50, 7]), (2, 33, [24, 16]), (2, 5, [96]),
])
def test_edge_aggregate_train_kernel_matches_plain(dev, sum_agg, b, n, widths):
    u1, u2, mask, hidden, _ = _chain(dev, b, n, widths, seed=n)
    before = mk.launch_counts["edge_aggregate_train"]
    out = mk.edge_aggregate(u1, u2, mask, hidden, 0.2, sum_agg, 0.5, 987654)
    torch.cuda.synchronize()
    assert mk.launch_counts["edge_aggregate_train"] == before + 1
    ref = mk.edge_aggregate_reference(u1, u2, mask, hidden, 0.2, sum_agg, 0.5, 987654)
    torch.testing.assert_close(out, ref, **TOL)


@pytest.mark.parametrize("need_wgrads", [True, False])
@pytest.mark.parametrize("dropout_p", [0.0, 0.5])
@pytest.mark.parametrize("sum_agg", [True, False])
@pytest.mark.parametrize("b,n,widths", [
    (64, 30, [96, 160, 192]), (4, 150, [96, 160, 192]), (3, 13, [96, 160, 192]),
    (2, 13, [30, 50, 7]), (2, 70, [24, 16]), (2, 5, [96]),
])
def test_edge_aggregate_bwd_kernel_matches_plain(dev, need_wgrads, dropout_p, sum_agg, b, n,
                                                 widths):
    u1, u2, mask, hidden, g = _chain(dev, b, n, widths, seed=n + 1)
    name = "edge_aggregate_bwd" if need_wgrads else "edge_aggregate_bwd_no_wgrads"
    before = mk.launch_counts[name]
    out = mk.edge_aggregate_bwd(u1, u2, mask, hidden, g, 0.2, sum_agg, dropout_p, 4242,
                                need_wgrads)
    torch.cuda.synchronize()
    assert mk.launch_counts[name] == before + 1
    ref = mk.edge_aggregate_bwd_reference(u1, u2, mask, hidden, g, 0.2, sum_agg, dropout_p, 4242,
                                          need_wgrads)
    for o, r in zip(out[:3], ref[:3]):
        torch.testing.assert_close(o, r, **TOL)
    for o, r in zip(out[3], ref[3]):
        _assert_wgrad_close(o, r)
        if not need_wgrads:
            assert not o.any()


def test_edge_aggregate_bwd_kernel_is_deterministic(dev):
    u1, u2, mask, hidden, g = _chain(dev, 64, 30, [96, 160, 192], seed=3)
    a = mk.edge_aggregate_bwd(u1, u2, mask, hidden, g, 0.2, True, 0.5, 7)
    b = mk.edge_aggregate_bwd(u1, u2, mask, hidden, g, 0.2, True, 0.5, 7)
    for x, y in zip(a[:3] + a[3], b[:3] + b[3]):
        assert torch.equal(x, y)


# pass shapes of the persistent backward kernels: batches that leave the last
# round of the grid ragged, a chain wide enough to force a shorter pass, widths
# that are no multiple of 4
BWD_PASS_SHAPES = [
    (1, 30, [96, 160, 192]), (33, 30, [96, 160, 192]), (160, 30, [96, 160, 192]),
    (1, 150, [96, 160, 192]), (5, 150, [96, 160, 192]),
    (3, 30, [250, 255, 256, 249, 200]),  # four wide layers: a 32-row pass
    (2, 21, [30, 50, 7]), (2, 40, [13, 9, 11, 5]),
]


@pytest.mark.parametrize("need_wgrads", [True, False])
@pytest.mark.parametrize("dropout_p,sum_agg", [(0.0, True), (0.5, False), (0.5, True)])
@pytest.mark.parametrize("b,n,widths", BWD_PASS_SHAPES)
def test_edge_aggregate_bwd_pass_shapes_match_plain_twice(dev, need_wgrads, dropout_p, sum_agg, b,
                                                          n, widths):
    """K3 against its plain version at every pass shape, and two launches bit for bit."""
    u1, u2, mask, hidden, g = _chain(dev, b, n, widths, seed=n + b)
    args = (u1, u2, mask, hidden, g, 0.2, sum_agg, dropout_p, 515, need_wgrads)
    out = mk.edge_aggregate_bwd(*args)
    again = mk.edge_aggregate_bwd(*args)
    torch.cuda.synchronize()
    ref = mk.edge_aggregate_bwd_reference(*args)
    for o, r in zip(out[:3], ref[:3]):
        torch.testing.assert_close(o, r, **TOL)
    for o, r in zip(out[3], ref[3]):
        _assert_wgrad_close(o, r)
        if not need_wgrads:
            assert not o.any()
    for x, y in zip(out[:3] + out[3], again[:3] + again[3]):
        assert torch.equal(x, y)


def test_backward_plans_on_the_card_equal_the_launchers(dev):
    """The wrappers' sizes of the packed weights and of the weight partials are the
    launchers' own."""
    lib = _build.library()
    for dims in ([96, 160, 192], [30, 50, 7], [250, 255, 256, 249, 200], [96]):
        arr = (ctypes.c_int * len(dims))(*dims)
        for rows in (32, 64, 128):
            assert lib.mpgan_edge_bwd_packed_floats(len(dims) - 1, arr, rows) == \
                mk.bwd_packed_floats(dims, rows)
        for extra in (0, dims[0]):
            assert lib.mpgan_edge_bwd_wslab_floats(len(dims) - 1, arr, extra) == \
                mk.bwd_wslab_floats(dims, extra)


def test_edge_aggregate_function_grads_match_plain_on_the_card(dev):
    u1, u2, mask, hidden, g = _chain(dev, 8, 30, [96, 160, 192], seed=5)

    def grads(fn):
        ins = [t.clone().requires_grad_() for t in (u1, u2, mask, *hidden)]
        out = fn(*ins)
        (out * g).sum().backward()
        return [t.grad for t in ins]

    k = grads(lambda a, b, m, *h: mk.EdgeAggregate.apply(a, b, m, 0.2, True, 0.5, 99, *h))
    p = grads(lambda a, b, m, *h: mk.edge_aggregate_reference(a, b, m, h, 0.2, True, 0.5, 99))
    for x, y in zip(k[:3], p[:3]):
        torch.testing.assert_close(x, y, **TOL)
    for x, y in zip(k[3:], p[3:]):
        _assert_wgrad_close(x, y)


def test_discriminator_without_weight_grads_launches_k3_without_them(dev):
    """The G step's D pass: parameters with requires_grad off, so the backward
    takes K3 without the weight contractions, and only the input has a gradient."""
    args = from_args_dict({"model": "mpgan"})
    d = MPDiscriminator(build_mpgan_discriminator(args), prng.PRNGKey(0),
                        device=dev)
    x = torch.randn(16, 30, 4, device=dev) * 0.3
    x[..., -1] = (torch.rand(16, 30, device=dev) > 0.3).float() - 0.5
    x.requires_grad_()
    d.requires_grad_(False)
    mk.reset_launch_counts()
    out = d(x, None, train=True, rng=Keys(prng.PRNGKey(1, dev)))
    out.sum().backward()
    torch.cuda.synchronize()
    assert mk.launch_counts["edge_aggregate_train"] == 2
    assert mk.launch_counts["edge_aggregate_bwd_no_wgrads"] == 2
    assert mk.launch_counts["edge_aggregate_bwd"] == 0
    assert x.grad is not None and torch.isfinite(x.grad).all()
    assert all(p.grad is None for p in d.parameters())


# ---------------------------------------------------------------------------
# the bf16 mode (StepConfig.bf16): K2, K3 and K4 on bf16 inputs and weights
# ---------------------------------------------------------------------------

# One bf16 rounding is 2^-8 of a value. The kernels and their plain versions
# sum each hidden product in another order before an activation is rounded to
# bf16 for the next product, and round the outputs once: rtol = atol = 1e-2.
# Gradients (and K4's outputs, sums of 256 rounded inputs) as a whole: a
# relative L2 error within BF16_REL_L2 and no element beyond BF16_MAX_SHARE of
# the largest. An activation that the two accumulate a hair apart rounds to
# neighbouring bf16 values, and a pre-activation within rounding of zero takes
# the other LeakyReLU slope; the backward carries both through every layer. The
# plain version itself, with its hidden pre-activations perturbed by 1e-6 to
# 1e-5 relative (the size of an accumulation-order difference), moves by up to
# 1.8% in L2 and 3.1% of the largest element at these shapes; a wrong slope,
# column or row moves the whole tensor.
BF16_TOL = dict(rtol=1e-2, atol=1e-2)
BF16_REL_L2 = 3e-2
BF16_MAX_SHARE = 0.1
BF16_SHAPES = [
    (256, 30, [96, 160, 192]), (32, 150, [96, 160, 192]), (33, 13, [20, 13, 12]),
    (3, 30, [250, 255, 256, 249, 200]), (2, 40, [13, 9, 11, 5]), (2, 5, [96]),
]


def _bf16(*ts):
    return tuple(t.to(torch.bfloat16) for t in ts)


def _assert_bf16_close(out, ref, scaled=False):
    assert out.dtype == ref.dtype == torch.bfloat16
    if not scaled:
        torch.testing.assert_close(out.float(), ref.float(), **BF16_TOL)
        return
    o, r = out.float(), ref.float()
    rel_l2 = ((o - r).norm() / r.norm().clamp_min(1e-30)).item()
    share = ((o - r).abs().max() / max(1.0, r.abs().max().item())).item()
    assert rel_l2 <= BF16_REL_L2 and share <= BF16_MAX_SHARE, (rel_l2, share)


def _fp32_counts():
    return {k: v for k, v in mk.launch_counts.items() if not k.endswith("_bf16")}


@pytest.mark.parametrize("dropout_p,sum_agg", [(0.0, True), (0.5, False)])
@pytest.mark.parametrize("b,n,widths", BF16_SHAPES)
def test_edge_aggregate_bf16_matches_plain_twice(dev, dropout_p, sum_agg, b, n, widths):
    """K2's bf16 mode against its plain version, counted apart from the FP32
    mode, and two launches bit for bit."""
    u1, u2, mask, hidden, _ = _chain(dev, b, n, widths, seed=n + b)
    args = (*_bf16(u1, u2, mask), _bf16(*hidden), 0.2, sum_agg, dropout_p, 8080)
    name = ("edge_aggregate_train" if dropout_p > 0 else "edge_aggregate") + "_bf16"
    before, fp32 = mk.launch_counts[name], _fp32_counts()
    out = mk.edge_aggregate(*args)
    again = mk.edge_aggregate(*args)
    torch.cuda.synchronize()
    assert mk.launch_counts[name] == before + 2 and _fp32_counts() == fp32
    _assert_bf16_close(out, mk.edge_aggregate_reference(*args))
    assert torch.equal(out, again)


@pytest.mark.parametrize("need_wgrads", [True, False])
@pytest.mark.parametrize("dropout_p,sum_agg", [(0.0, True), (0.5, False)])
@pytest.mark.parametrize("b,n,widths", BF16_SHAPES)
def test_edge_aggregate_bwd_bf16_matches_plain_twice(dev, need_wgrads, dropout_p, sum_agg, b, n,
                                                     widths):
    """K3's bf16 mode against its plain version (bf16 gradients, weight
    gradients rounded to bf16 from float32 sums), and two launches bit for bit."""
    u1, u2, mask, hidden, g = _chain(dev, b, n, widths, seed=n + b)
    args = (*_bf16(u1, u2, mask), _bf16(*hidden), *_bf16(g), 0.2, sum_agg, dropout_p, 515,
            need_wgrads)
    name = ("edge_aggregate_bwd" if need_wgrads else "edge_aggregate_bwd_no_wgrads") + "_bf16"
    before = mk.launch_counts[name]
    out = mk.edge_aggregate_bwd(*args)
    again = mk.edge_aggregate_bwd(*args)
    torch.cuda.synchronize()
    assert mk.launch_counts[name] == before + 2
    ref = mk.edge_aggregate_bwd_reference(*args)
    for o, r in zip(out[:3] + out[3], ref[:3] + ref[3]):
        _assert_bf16_close(o, r, scaled=True)
    if not need_wgrads:
        assert not any(o.any() for o in out[3])
    for x, y in zip(out[:3] + out[3], again[:3] + again[3]):
        assert torch.equal(x, y)


@pytest.mark.parametrize("need_wgrads", [True, False])
@pytest.mark.parametrize("b,n,widths", BWD_PASS_SHAPES)
def test_edge_aggregate_bwd_bf16_pass_shapes_match_plain_twice(dev, need_wgrads, b, n, widths):
    """K3's bf16 mode, its backward products as split-TF32 on the tensor cores,
    at every pass shape (32-, 64- and 128-row passes, ragged grids, widths that
    are no multiple of 8, so every tile count of the da product and clamped dW
    tiles): within the bf16 rules of its plain version, two launches bit for
    bit; the FP32 mode on the same values still within 1e-4 and bit for bit."""
    u1, u2, mask, hidden, g = _chain(dev, b, n, widths, seed=n + b + 15)
    a16 = (*_bf16(u1, u2, mask), _bf16(*hidden), *_bf16(g), 0.2, False, 0.5, 1515, need_wgrads)
    out, again = mk.edge_aggregate_bwd(*a16), mk.edge_aggregate_bwd(*a16)
    torch.cuda.synchronize()
    ref = mk.edge_aggregate_bwd_reference(*a16)
    for o, r in zip(out[:3] + out[3], ref[:3] + ref[3]):
        _assert_bf16_close(o, r, scaled=True)
    assert all(torch.equal(x, y) for x, y in zip(out[:3] + out[3], again[:3] + again[3]))
    a32 = (*(t.float() for t in a16[:3]), tuple(t.float() for t in a16[3]), a16[4].float(),
           *a16[5:])
    out32, again32 = mk.edge_aggregate_bwd(*a32), mk.edge_aggregate_bwd(*a32)
    torch.cuda.synchronize()
    ref32 = mk.edge_aggregate_bwd_reference(*a32)
    for o, r in zip(out32[:3], ref32[:3]):
        torch.testing.assert_close(o, r, **TOL)
    for o, r in zip(out32[3], ref32[3]):
        _assert_wgrad_close(o, r)
    assert all(torch.equal(x, y) for x, y in zip(out32[:3] + out32[3], again32[:3] + again32[3]))


@pytest.mark.parametrize("sum_agg,final_linear", [(True, True), (False, False)])
@pytest.mark.parametrize("b,n,fe,feat,fn", [
    (256, 30, [96, 160, 192], 32, [256, 256, 3]),  # the flagship G's last layer
    (601, 30, [96, 160, 192], 32, [256, 256, 32]),
    (33, 13, [30, 50, 7], 6, [13, 3]),             # odd widths
    (2, 45, [64, 256, 224], 32, [256, 8]),         # wide: a 64-row pass
    (3, 5, [96], 16, [20]),                         # no hidden layer
])
def test_edge_aggregate_fn_bf16_matches_plain_twice(dev, sum_agg, final_linear, b, n, fe, feat,
                                                    fn):
    """K4's bf16 mode against its plain version (fn's first layer on float32
    operands), and two launches bit for bit."""
    g = torch.Generator(device=dev).manual_seed(n + b)
    r = lambda *s, scale=0.3: torch.randn(*s, generator=g, device=dev) * scale  # noqa: E731
    hidden = tuple(t for a, c in zip(fe[:-1], fe[1:]) for t in (r(a, c, scale=a ** -0.5), r(c)))
    full = [fe[-1] + feat] + fn
    fn_flat = [r(fe[-1], fn[0], scale=full[0] ** -0.5), r(feat, fn[0], scale=full[0] ** -0.5),
               r(fn[0])]
    for a, c in zip(fn[:-1], fn[1:]):
        fn_flat += [r(a, c, scale=a ** -0.5), r(c)]
    mask = (torch.rand(b, n, 1, generator=g, device=dev) > 0.3).float()
    u1, u2, x = _bf16(r(b, n, fe[0], scale=0.5), r(b, n, fe[0], scale=0.5), r(b, n, feat))
    args = (u1, u2, *_bf16(mask), _bf16(*hidden), x, _bf16(*fn_flat), 0.2, sum_agg, 0.1,
            final_linear)
    before = mk.launch_counts["edge_aggregate_fn_bf16"]
    out = mk.edge_aggregate_fn(*args)
    again = mk.edge_aggregate_fn(*args)
    torch.cuda.synchronize()
    assert mk.launch_counts["edge_aggregate_fn_bf16"] == before + 2
    # fn's outputs sum 256 bf16-rounded inputs: an input one rounding apart moves
    # an output by 2^-8 of the terms, not of the output (which may cancel)
    _assert_bf16_close(out, mk.edge_aggregate_fn_reference(*args), scaled=True)
    assert torch.equal(out, again)


def _k4_bits():
    import importlib.util
    import pathlib

    root = pathlib.Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location("torch_k4_bf16_bits",
                                                  root / "scripts" / "torch_k4_bf16_bits.py")
    kb = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(kb)
    return kb, root / "tests" / "data" / "k4_bf16_fp32_pass.npz"


def test_edge_aggregate_fn_bf16_equals_the_fp32_pass_bit_for_bit(dev):
    """K4's bf16 mode on the tile pass (its aggregate as K2's, fn's first layer as
    FMA chains in the FP32 pass's k order, the later layers on the same mma.sync
    operands in the same order) equals what the FP32 pass's bf16 mode gave on the
    same seeded inputs (``scripts/torch_k4_bf16_bits.py``'s cases: the flagship G's
    two MP layers at the bf16 step's batch, odd widths, a wide chain, no hidden
    layer), one launch a call, within the bf16 rules of the plain version and bit for
    bit on a rerun."""
    import numpy as np

    kb, saved = _k4_bits()
    want = np.load(saved)
    assert sorted(want.files) == sorted(kb.CASES)
    for name in kb.CASES:
        args = kb.case_args(name, dev)
        before = mk.launch_counts["edge_aggregate_fn_bf16"]
        out = mk.edge_aggregate_fn(*args)
        torch.cuda.synchronize()
        assert mk.launch_counts["edge_aggregate_fn_bf16"] == before + 1
        bits = out.view(torch.int16).cpu().numpy().view(np.uint16)
        assert np.array_equal(bits, want[name]), (name, int((bits != want[name]).sum()))
        assert torch.equal(out, mk.edge_aggregate_fn(*args))
        _assert_bf16_close(out, mk.edge_aggregate_fn_reference(*args), scaled=True)


def test_bf16_packed_sizes_on_the_card_equal_the_launchers(dev):
    """The wrappers' sizes of the bf16 mode's packed weights are the launchers' own."""
    lib = _build.library()
    arr = lambda d: (ctypes.c_int * len(d))(*d)  # noqa: E731
    for dims, fn_dims in (([96, 160, 192], None), ([96, 160, 192], [224, 256, 256, 3]),
                          ([30, 50, 7], [13, 13, 3]), ([96], [112, 20]),
                          ([250, 255, 256, 249, 200], None)):
        assert lib.mpgan_edge_fwd_packed_floats_bf16(
            len(dims) - 1, arr(dims), len(fn_dims) - 1 if fn_dims else 0,
            arr(fn_dims or [0])) == mk.fwd_packed_floats_bf16(dims, fn_dims)
        for rows in (32, 64, 128):
            assert lib.mpgan_edge_bwd_packed_floats_bf16(len(dims) - 1, arr(dims), rows) == \
                mk.bwd_packed_floats_bf16(dims, rows)


def test_bf16_tile_plans_shared_memory_equal_the_launchers(dev):
    """The bf16 forward pass's plans (K2's, K4's, K5's, K8's) lay out the shared
    memory as the launcher does (mpgan_bf16_tile_smem), resident or not."""
    lib = _build.library()
    sms = mk._sm_count(dev)
    arr = lambda d: (ctypes.c_int * len(d))(*d)  # noqa: E731
    plans = [(dims, n, 0, 0, None, mk.bf16_tile_plan(b, n, dims, sms))
             for b, n, dims in BF16_SHAPES]
    for b, n, dims, fn in ((256, 30, [96, 160, 192], [224, 256, 256, 3]),
                           (33, 13, [30, 50, 7], [13, 13, 3]), (2, 45, [64, 256, 224], [256, 8]),
                           (3, 5, [96], [112, 20])):
        plans.append((dims, n, 0, 0, fn, mk.bf16_tile_plan(b, n, dims, sms, fn)))
    for b, n, c, widths, k in KNN_SHAPES:
        for search in (True, False):
            plans.append((widths, n, c, k, None,
                          kk.bf16_tile_plan(b, n, c, k, widths, sms, search)))
    for dims, n, c, k, fn, plan in plans:
        search = plan.sspan_items > 0
        assert lib.mpgan_bf16_tile_smem(
            len(dims) - 1, arr(dims), k or n, n, c, k, int(search), plan.width, plan.warps,
            int(plan.resident), plan.ti, plan.jc, plan.sspan_items, len(fn) - 1 if fn else 0,
            arr(fn or [0]), plan.fn_slots) == plan.smem_bytes


def test_bf16_function_grads_match_plain_and_take_the_weights_dtype(dev):
    """EdgeAggregate in the bf16 mode: K2 forward, K3 backward, gradients bf16
    (the weights' dtype, as the JAX package's VJP returns them)."""
    u1, u2, mask, hidden, g = _chain(dev, 8, 30, [96, 160, 192], seed=5)
    g = g.to(torch.bfloat16)

    def grads(fn):
        ins = [t.to(torch.bfloat16).requires_grad_() for t in (u1, u2, mask, *hidden)]
        (fn(*ins).float() * g.float()).sum().backward()
        return [t.grad for t in ins]

    mk.reset_launch_counts()
    k = grads(lambda a, b, m, *h: mk.EdgeAggregate.apply(a, b, m, 0.2, True, 0.5, 99, *h))
    assert mk.launch_counts["edge_aggregate_train_bf16"] == 1
    assert mk.launch_counts["edge_aggregate_bwd_bf16"] == 1
    p = grads(lambda a, b, m, *h: mk.edge_aggregate_reference(a, b, m, h, 0.2, True, 0.5, 99))
    for x, y in zip(k, p):
        _assert_bf16_close(x, y, scaled=True)


def test_wrappers_refuse_mixed_dtypes(dev):
    u1, u2, mask, hidden, g = _chain(dev, 2, 13, [20, 13, 12], seed=1)
    with pytest.raises(TypeError, match="float32 or all-bfloat16"):
        mk.edge_aggregate(u1.to(torch.bfloat16), u2, mask, hidden, 0.2, True)
    with pytest.raises(TypeError, match="float32 or all-bfloat16"):
        mk.edge_aggregate_bwd(*_bf16(u1, u2, mask), hidden, g, 0.2, True)


# ---------------------------------------------------------------------------
# the knn layer: K5 (search + gather + chain + aggregate) and K6 (its backward)
# ---------------------------------------------------------------------------


def _knn_inputs(dev, b, n, c, widths, k, seed):
    """Operands of the fused knn layer; jets hold between 1 and n real
    particles (some fewer than k), the first one all n."""
    g = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *s, scale=0.5: torch.randn(*s, generator=g, device=dev) * scale  # noqa: E731
    xs = r(b, n, c, scale=0.3)
    counts = torch.randint(1, n + 1, (b,), generator=g, device=dev)
    counts[0] = n
    mask = (torch.arange(n, device=dev)[None, :] < counts[:, None]).float()[..., None]
    xf = ((1 - 1e4) * mask + 1e4) * xs
    h1 = widths[0]
    hidden = tuple(t for a, w in zip(widths[:-1], widths[1:])
                   for t in (r(a, w, scale=a ** -0.5), r(w, scale=0.1)))
    u2m = torch.cat([r(b, n, h1), mask], dim=-1)
    return dict(xs=xs, xf=xf, u1=r(b, n, h1), u2m=u2m, w_d=r(h1, scale=0.3), hidden=hidden,
                g=r(b, n, widths[-1]), mask=mask, k=k)


KNN_SHAPES = [
    (8, 150, 32, [96, 160, 192], 20),   # the published widths
    (3, 13, 8, [24, 16, 12], 5),        # small and ragged
    (2, 70, 3, [30, 50, 7], 33),        # several groups, ranks split over passes, odd widths
    (2, 9, 4, [96], 3),                 # fe without hidden layers
]


@pytest.mark.parametrize("dropout_p", [0.0, 0.5])
@pytest.mark.parametrize("sum_agg,self_loops,want_dists", [
    (True, True, False), (False, False, True), (True, False, False), (False, True, True),
])
@pytest.mark.parametrize("b,n,c,widths,k", KNN_SHAPES)
def test_knn_fused_layer_kernel_matches_plain(dev, b, n, c, widths, k, sum_agg, self_loops,
                                              want_dists, dropout_p):
    d = _knn_inputs(dev, b, n, c, widths, k, seed=n)
    args = (d["xs"], d["xf"], d["u1"], d["u2m"], d["w_d"] if want_dists else None, d["hidden"],
            k, self_loops, want_dists, 0.2, sum_agg, dropout_p, 31337)
    before = dict(mk.launch_counts)
    out, idx, dists = kk.knn_fused_layer(*args, True)
    out_eval, no_idx, no_dists = kk.knn_fused_layer(*args)
    torch.cuda.synchronize()
    assert mk.launch_counts["knn_fused_layer_train"] == before["knn_fused_layer_train"] + 1
    assert mk.launch_counts["knn_fused_layer"] == before["knn_fused_layer"] + 1
    assert no_idx is None and no_dists is None and torch.equal(out, out_eval)
    ref, idx_ref, dists_ref = kk.knn_fused_layer_reference(*args, True)
    # the kernel builds the plain version's keys bit for bit: no row may differ
    agree, differing, bad = kk.compare_neighbours(idx, idx_ref, kk.knn_keys(d["xs"], d["xf"]),
                                                  d["mask"])
    assert differing == 0 and bad == 0 and torch.equal(idx, idx_ref)
    torch.testing.assert_close(out, ref, **TOL)
    if want_dists:
        live = torch.gather(d["mask"][:, None, :, 0].expand(-1, n, -1), 2, idx.long()) > 0
        torch.testing.assert_close(dists[live], dists_ref[live], **TOL)
    else:
        assert dists is None


@pytest.mark.parametrize("need_wgrads", [True, False])
@pytest.mark.parametrize("dropout_p", [0.0, 0.5])
@pytest.mark.parametrize("sum_agg,want_dists", [(True, False), (False, True)])
@pytest.mark.parametrize("b,n,c,widths,k", KNN_SHAPES)
def test_knn_edge_aggregate_bwd_kernel_matches_plain(dev, b, n, c, widths, k, sum_agg,
                                                     want_dists, dropout_p, need_wgrads):
    d = _knn_inputs(dev, b, n, c, widths, k, seed=n + 1)
    idx = kk.knn_select_reference(d["xs"], d["xf"], k, True)
    dists = kk._edge_dists(d["xs"], d["xf"], idx)[0] if want_dists else None
    args = (d["u1"], d["u2m"], idx, dists, d["w_d"] if want_dists else None, d["hidden"], d["g"],
            0.2, sum_agg, dropout_p, 4242, need_wgrads)
    name = "knn_edge_aggregate_bwd" if need_wgrads else "knn_edge_aggregate_bwd_no_wgrads"
    before = mk.launch_counts[name]
    out = kk.knn_edge_aggregate_bwd(*args)
    again = kk.knn_edge_aggregate_bwd(*args)
    torch.cuda.synchronize()
    assert mk.launch_counts[name] == before + 2
    ref = kk.knn_edge_aggregate_bwd_reference(*args)
    for o, r in zip(out[:2], ref[:2]):
        torch.testing.assert_close(o, r, **TOL)
    # dmask of a masked sender sums activations at the scale of its pushed-away
    # distance (1e4 with dists), with cancellation: the weight gradients' bound
    real = d["mask"] > 0
    torch.testing.assert_close(out[2][real], ref[2][real], **TOL)
    if (~real).any():
        _assert_wgrad_close(out[2][~real], ref[2][~real])
    if want_dists:
        torch.testing.assert_close(out[3], ref[3], **TOL)
        _assert_wgrad_close(out[4], ref[4])
    else:
        assert out[3] is None and out[4] is None
    for o, r in zip(out[5], ref[5]):
        _assert_wgrad_close(o, r)
        if not need_wgrads:
            assert not o.any()
    # the sender scatter and the sums across CTAs are in a fixed order
    flat = lambda res: [t for t in (*res[:5], *res[5]) if t is not None]  # noqa: E731
    for x, y in zip(flat(out), flat(again)):
        assert torch.equal(x, y)


KNN_BWD_PASS_SHAPES = [
    (1, 150, [96, 160, 192], 20), (33, 150, [96, 160, 192], 20), (160, 150, [96, 160, 192], 20),
    (7, 30, [96, 160, 192], 20),
    (3, 30, [250, 255, 256, 249, 200], 20),  # four wide layers: a 32-row pass, no staging
    (2, 21, [30, 50, 7], 13), (2, 40, [13, 9, 11, 5], 40),
]


@pytest.mark.parametrize("need_wgrads", [True, False])
@pytest.mark.parametrize("dropout_p,sum_agg,want_dists", [
    (0.0, True, False), (0.5, False, True), (0.5, True, False)])
@pytest.mark.parametrize("b,n,widths,k", KNN_BWD_PASS_SHAPES)
def test_knn_edge_aggregate_bwd_pass_shapes_match_plain_twice(dev, b, n, widths, k, need_wgrads,
                                                              dropout_p, sum_agg, want_dists):
    """K6 against its plain version at every pass shape, from neighbour lists that
    repeat senders within a receiver's row (the split route takes any idx), and
    two launches bit for bit."""
    d = _knn_inputs(dev, b, n, 4, widths, k, seed=n + b)
    gen = torch.Generator(device=dev).manual_seed(b)
    idx = torch.randint(0, n, (b, n, k), generator=gen, device=dev, dtype=torch.int32)
    dists = torch.rand(b, n, k, generator=gen, device=dev) if want_dists else None
    args = (d["u1"], d["u2m"], idx, dists, d["w_d"] if want_dists else None, d["hidden"], d["g"],
            0.2, sum_agg, dropout_p, 616, need_wgrads)
    out = kk.knn_edge_aggregate_bwd(*args)
    again = kk.knn_edge_aggregate_bwd(*args)
    torch.cuda.synchronize()
    ref = kk.knn_edge_aggregate_bwd_reference(*args)
    for o, r in zip(out[:3], ref[:3]):
        torch.testing.assert_close(o, r, **TOL)
    if want_dists:
        torch.testing.assert_close(out[3], ref[3], **TOL)
        _assert_wgrad_close(out[4], ref[4])
    for o, r in zip(out[5], ref[5]):
        _assert_wgrad_close(o, r)
        if not need_wgrads:
            assert not o.any()
    flat = lambda res: [t for t in (*res[:5], *res[5]) if t is not None]  # noqa: E731
    for x, y in zip(flat(out), flat(again)):
        assert torch.equal(x, y)


def test_knn_fused_layer_function_grads_match_plain_on_the_card(dev):
    d = _knn_inputs(dev, 4, 150, 32, [96, 160, 192], 20, seed=9)

    def grads(kernel):
        ins = [d[key].clone().requires_grad_() for key in ("xs", "xf", "u1", "u2m", "w_d")]
        hidden = [t.clone().requires_grad_() for t in d["hidden"]]
        if kernel:
            out = kk.KnnFusedLayer.apply(*ins, 20, True, True, 0.2, True, 0.5, 99, *hidden)
        else:
            idx = kk.knn_select_reference(ins[0], ins[1], 20, True)
            dists = kk._edge_dists(ins[0], ins[1], idx)[0]
            acts, smask = kk._knn_chain(ins[2], ins[3], idx, dists, ins[4], hidden, 0.2, 0.5,
                                        99)[1::2]
            out = (acts[-1] * smask).sum(dim=2)
        (out * d["g"]).sum().backward()
        return [t.grad for t in ins], [t.grad for t in hidden]

    (kin, kw), (pin, pw) = grads(True), grads(False)
    for x, y in zip(kin[2:4], pin[2:4]):
        torch.testing.assert_close(x, y, **TOL)
    # masked senders sit 1e4 out: their distance gradient is that much larger
    for x, y in zip(kin[:2], pin[:2]):
        scale = y.abs().clamp_min(1.0)
        torch.testing.assert_close(x / scale, y / scale, **TOL)
    for x, y in zip([kin[4]] + kw, [pin[4]] + pw):
        _assert_wgrad_close(x, y)


def test_knn_wrappers_refuse_what_the_kernels_do_not_take(dev):
    d = _knn_inputs(dev, 2, 13, 8, [24, 16, 12], 5, seed=1)
    fwd = lambda **kw: kk.knn_fused_layer(**{**dict(  # noqa: E731
        xs=d["xs"], xf=d["xf"], u1=d["u1"], u2m=d["u2m"], w_d=None, hidden_flat=d["hidden"], k=5,
        self_loops=True, want_dists=False, alpha=0.2, sum_agg=True), **kw})
    with pytest.raises(TypeError, match="float32"):
        fwd(xs=d["xs"].double(), xf=d["xf"].double())
    with pytest.raises(ValueError, match="contiguous"):
        fwd(u2m=torch.cat([d["u2m"], d["u2m"]], dim=-1)[..., :25])
    with pytest.raises(ValueError, match="exceeds the 13 available senders"):
        fwd(k=13, self_loops=False)
    idx = kk.knn_select_reference(d["xs"], d["xf"], 5, True)
    with pytest.raises(ValueError, match="alpha"):
        kk.knn_edge_aggregate_bwd(d["u1"], d["u2m"], idx, None, None, d["hidden"], d["g"], 0.0,
                                  True)
    with pytest.raises(ValueError, match="contiguous"):
        kk.knn_edge_aggregate_bwd(d["u1"], d["u2m"], idx.transpose(1, 2).contiguous()
                                  .transpose(1, 2), None, None, d["hidden"], d["g"], 0.2, True)


KNN150 = {"model": "mpgan", "num_hits": 150, "fully_connected": False, "num_knn": 20}


def test_knn_generator_kernel_path_matches_its_plain_versions(dev):
    """The 150-particle knn-20 generator on the card against the same path
    through the kernels' plain versions on the CPU: same keys, same neighbours."""
    cfg = build_mpgan_generator(from_args_dict(KNN150))
    g = MPGenerator(cfg, prng.PRNGKey(0))
    noise = torch.randn(4, 150, 32, generator=torch.Generator().manual_seed(1)) * 0.2
    labels = torch.tensor([[1.0], [0.4], [0.1], [0.02]])
    with torch.inference_mode():
        g.cfg = dataclasses.replace(cfg, use_kernels=True)
        y_cpu = g(noise, labels)
        g.cfg = cfg
        mk.reset_launch_counts()
        y_card = g.to(dev)(noise.to(dev), labels.to(dev))
    assert mk.launch_counts["knn_fused_layer"] == 2
    torch.testing.assert_close(y_card.cpu(), y_cpu, **TOL)
    assert torch.equal(y_card.cpu()[..., -1], y_cpu[..., -1])


def test_knn_discriminator_backward_launches_k6(dev):
    """D in train mode: K5 emitting idx, then K6 with the weight contractions;
    with D's parameters frozen (the G step), K6 without them."""
    d = MPDiscriminator(build_mpgan_discriminator(from_args_dict(KNN150)),
                        prng.PRNGKey(0), device=dev)
    x = torch.randn(4, 150, 4, device=dev) * 0.3
    x[..., -1] = (torch.rand(4, 150, device=dev) > 0.3).float() - 0.5
    x.requires_grad_()
    for frozen, name in ((False, "knn_edge_aggregate_bwd"),
                         (True, "knn_edge_aggregate_bwd_no_wgrads")):
        d.requires_grad_(not frozen)
        mk.reset_launch_counts()
        out = d(x, None, train=True, rng=Keys(prng.PRNGKey(1, dev)))
        out.sum().backward()
        torch.cuda.synchronize()
        assert mk.launch_counts["knn_fused_layer_train"] == 2
        assert mk.launch_counts[name] == 2
        assert sum(mk.launch_counts.values()) == 4
        assert torch.isfinite(x.grad).all()


# ---------------------------------------------------------------------------
# the split knn route: K7 (search) and K8 (aggregate from idx)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("self_loops,want_dists", [(True, False), (False, True), (True, True)])
@pytest.mark.parametrize("b,n,c,widths,k", KNN_SHAPES)
def test_knn_search_kernel_matches_plain_and_k5(dev, b, n, c, widths, k, self_loops, want_dists):
    d = _knn_inputs(dev, b, n, c, widths, k, seed=n + 2)
    before = mk.launch_counts["knn_search"]
    idx, dists = kk.knn_search(d["xs"], d["xf"], k, self_loops, want_dists)
    torch.cuda.synchronize()
    assert mk.launch_counts["knn_search"] == before + 1
    idx_ref, dists_ref = kk.knn_search_reference(d["xs"], d["xf"], k, self_loops, want_dists)
    assert torch.equal(idx, idx_ref)
    _, idx5, dists5 = kk.knn_fused_layer(d["xs"], d["xf"], d["u1"], d["u2m"],
                                         d["w_d"] if want_dists else None, d["hidden"], k,
                                         self_loops, want_dists, 0.2, True, 0.0, 0, True)
    assert torch.equal(idx, idx5)
    if want_dists:
        assert torch.equal(dists, dists5)
        live = torch.gather(d["mask"][:, None, :, 0].expand(-1, n, -1), 2, idx.long()) > 0
        torch.testing.assert_close(dists[live], dists_ref[live], **TOL)
    else:
        assert dists is None


TIE_SHAPES = [
    (3, 45, 32, [24, 16, 12], 20),  # k + 1 = 21 keys: the register list's cap; n % 32 != 0
    (2, 45, 8, [24, 16, 12], 21),   # above the cap: a second round of the search
    (2, 70, 3, [30, 50, 7], 33),
    (2, 37, 40, [24, 16, 12], 24),  # rows wider than the registers hold, two rounds
    (4, 150, 32, [96, 160, 192], 20),
]


@pytest.mark.parametrize("self_loops", [True, False])
@pytest.mark.parametrize("b,n,c,widths,k", TIE_SHAPES)
def test_knn_searches_break_exact_ties_alike(dev, b, n, c, widths, k, self_loops):
    """Duplicated particles give keys equal up to the index bits: K7's idx, K5's
    and the plain search's are equal bit for bit, and K8 on K5's idx equals K5."""
    d = _knn_inputs(dev, b, n, c, widths, k, seed=n + c)
    xs = d["xs"].clone()
    xs[:, 1::2] = xs[:, 0:2 * (n // 2):2]  # particle 2m + 1 repeats particle 2m
    xf = ((1 - 1e4) * d["mask"] + 1e4) * xs
    idx7, _ = kk.knn_search(xs, xf, k, self_loops, False)
    out5, idx5, _ = kk.knn_fused_layer(xs, xf, d["u1"], d["u2m"], None, d["hidden"], k,
                                       self_loops, False, 0.2, True, 0.0, 0, True)
    out8 = kk.knn_edge_aggregate(d["u1"], d["u2m"], idx5, None, None, d["hidden"], 0.2, True,
                                 0.0, 0)
    torch.cuda.synchronize()
    idx_ref, _ = kk.knn_search_reference(xs, xf, k, self_loops)
    keys = kk.knn_keys(xs, xf)
    assert int(((keys >> kk.key_bits(n))[:, :, 0::2][:, :, :n // 2]
                == (keys >> kk.key_bits(n))[:, :, 1::2]).sum()) > 0  # the ties are there
    assert torch.equal(idx7, idx_ref) and torch.equal(idx5, idx_ref)
    assert torch.equal(out8, out5)


@pytest.mark.parametrize("dropout_p", [0.0, 0.5])
@pytest.mark.parametrize("sum_agg,want_dists", [(True, False), (False, True)])
@pytest.mark.parametrize("b,n,c,widths,k", KNN_SHAPES)
def test_knn_edge_aggregate_kernel_matches_plain_and_k5(dev, b, n, c, widths, k, sum_agg,
                                                        want_dists, dropout_p):
    d = _knn_inputs(dev, b, n, c, widths, k, seed=n + 3)
    w_d = d["w_d"] if want_dists else None
    out5, idx, dists = kk.knn_fused_layer(d["xs"], d["xf"], d["u1"], d["u2m"], w_d, d["hidden"],
                                          k, True, want_dists, 0.2, sum_agg, dropout_p, 777, True)
    before = mk.launch_counts["knn_edge_aggregate"]
    out = kk.knn_edge_aggregate(d["u1"], d["u2m"], idx, dists, w_d, d["hidden"], 0.2, sum_agg,
                                dropout_p, 777)
    torch.cuda.synchronize()
    assert mk.launch_counts["knn_edge_aggregate"] == before + 1
    ref = kk.knn_edge_aggregate_reference(d["u1"], d["u2m"], idx, dists, w_d, d["hidden"], 0.2,
                                          sum_agg, dropout_p, 777)
    torch.testing.assert_close(out, ref, **TOL)
    assert torch.equal(out, out5)  # the fused layer without its search, on its own idx


# pass shapes of the persistent knn forward kernels: item ranges that cross jets so a
# CTA searches several (B=601), rs = 8 (k = 5), odd widths with the ranks over several
# passes, and searches shorter than a jet (k = 149: the neighbours of 150 do not fit)
KNN_FWD_PASS_SHAPES = [
    (601, 150, 32, [96, 160, 192], 20), (37, 13, 8, [24, 16, 12], 5),
    (3, 160, 5, [30, 50, 7], 140), (4, 150, 32, [96, 160, 192], 149),
]


@pytest.mark.parametrize("dropout_p,sum_agg,self_loops,want_dists", [
    (0.0, True, True, False), (0.5, False, False, True), (0.5, True, True, True),
    (0.0, False, False, False)])
@pytest.mark.parametrize("b,n,c,widths,k", KNN_FWD_PASS_SHAPES)
def test_knn_forward_pass_shapes_match_plain_twice(dev, b, n, c, widths, k, dropout_p, sum_agg,
                                                   self_loops, want_dists):
    """K5 against its plain version at every pass shape, two launches bit for bit,
    K7's idx equal to K5's, and K8 on K5's idx equal to K5 bit for bit (one
    forward pass, two row sources)."""
    d = _knn_inputs(dev, b, n, c, widths, k, seed=b + n)
    w_d = d["w_d"] if want_dists else None
    args = (d["xs"], d["xf"], d["u1"], d["u2m"], w_d, d["hidden"], k, self_loops, want_dists, 0.2,
            sum_agg, dropout_p, 2024)
    before = dict(mk.launch_counts)
    out, idx, dists = kk.knn_fused_layer(*args, True)
    again, idx_again, dists_again = kk.knn_fused_layer(*args, True)
    out_eval = kk.knn_fused_layer(*args)[0]
    idx7, dists7 = kk.knn_search(d["xs"], d["xf"], k, self_loops, want_dists)
    agg = (d["u1"], d["u2m"], idx, dists, w_d, d["hidden"], 0.2, sum_agg, dropout_p, 2024)
    out8, out8_again = kk.knn_edge_aggregate(*agg), kk.knn_edge_aggregate(*agg)
    torch.cuda.synchronize()
    assert mk.launch_counts["knn_fused_layer_train"] == before["knn_fused_layer_train"] + 2
    assert mk.launch_counts["knn_edge_aggregate"] == before["knn_edge_aggregate"] + 2
    ref, idx_ref, dists_ref = kk.knn_fused_layer_reference(*args, True)
    assert torch.equal(idx, idx_ref) and torch.equal(idx7, idx)
    torch.testing.assert_close(out, ref, **TOL)
    for x in (again, out_eval, out8, out8_again):
        assert torch.equal(x, out)
    assert torch.equal(idx_again, idx)
    if want_dists:
        assert torch.equal(dists_again, dists) and torch.equal(dists7, dists)
        live = torch.gather(d["mask"][:, None, :, 0].expand(-1, n, -1), 2, idx.long()) > 0
        torch.testing.assert_close(dists[live], dists_ref[live], **TOL)
    torch.testing.assert_close(out8, kk.knn_edge_aggregate_reference(*agg), **TOL)


def test_knn_forward_plans_on_the_card_equal_the_launchers(dev):
    """knn_fwd_plan's shared memory is the launcher's own layout, K5 and K8."""
    lib = _build.library()
    for b, n, c, widths, k in KNN_SHAPES + KNN_FWD_PASS_SHAPES + [
            (160, 150, 32, [128, 256], 20), (2, 30, 4, [250, 255, 256, 249, 200], 20)]:
        for search in (True, False):
            plan = kk.knn_fwd_plan(b, n, c, k, widths, torch.cuda.get_device_properties(
                dev).multi_processor_count, search)
            smem = ctypes.c_longlong()
            code = lib.mpgan_knn_fwd_sizes(len(widths) - 1, (ctypes.c_int * len(widths))(*widths),
                                           b, n, c, k, int(search), plan.rows, plan.ti, plan.kc,
                                           plan.sspan, plan.slab_floats, ctypes.byref(smem))
            assert code == 0 and smem.value == plan.smem_bytes


def test_knn_split_function_grads_match_the_fused_functions(dev):
    """K7 -> K8 -> K6 through their Functions against K5 -> K6: the same
    kernels' stages, so the same gradients (those of xs and xf, which reach
    them through the distances, held at a tolerance)."""
    d = _knn_inputs(dev, 4, 150, 32, [96, 160, 192], 20, seed=9)

    def grads(fn):
        ins = [d[key].clone().requires_grad_() for key in ("xs", "xf", "u1", "u2m", "w_d")]
        hidden = [t.clone().requires_grad_() for t in d["hidden"]]
        out = fn(*ins, hidden, 20, True, True, 0.2, True, 0.5, 99)
        (out * d["g"]).sum().backward()
        return out.detach(), [t.grad for t in ins], [t.grad for t in hidden]

    mk.reset_launch_counts()
    (of, fin, fw), (os_, sin, sw) = grads(kk.knn_aggregate), grads(kk.knn_aggregate_split)
    torch.cuda.synchronize()
    assert mk.launch_counts["knn_search"] == 1 and mk.launch_counts["knn_edge_aggregate"] == 1
    assert mk.launch_counts["knn_edge_aggregate_bwd"] == 2
    assert torch.equal(of, os_)
    for x, y in zip(fin[2:] + fw, sin[2:] + sw):
        assert torch.equal(x, y)
    for x, y in zip(fin[:2], sin[:2]):
        scale = y.abs().clamp_min(1.0)
        torch.testing.assert_close(x / scale, y / scale, **TOL)


def test_knn_layer_routes_on_the_card(dev, monkeypatch):
    """The knn layer on routes 3 and select-0 against route 4 on the card."""
    from mpgan_tpu_torch.ops import mp

    cfg = build_mpgan_generator(from_args_dict(KNN150))
    g = MPGenerator(cfg, prng.PRNGKey(0), device=dev)
    noise = torch.randn(4, 150, 32, generator=torch.Generator().manual_seed(1)).to(dev) * 0.2
    labels = torch.tensor([[1.0], [0.4], [0.1], [0.02]], device=dev)
    outs = {}
    for name, env in (("4", {}), ("3", {"MPGAN_TPU_KNN_KERNEL": "3"}),
                      ("select0", {"MPGAN_TPU_KNN_SELECT": "0"})):
        for key in ("MPGAN_TPU_KNN_KERNEL", "MPGAN_TPU_KNN_SELECT"):
            monkeypatch.delenv(key, raising=False)
        for key, value in env.items():
            monkeypatch.setenv(key, value)
        mk.reset_launch_counts()
        with torch.inference_mode():
            outs[name] = g(noise, labels)
        torch.cuda.synchronize()
        want = {"4": {"knn_fused_layer": 2}, "3": {"knn_search": 2, "knn_edge_aggregate": 2},
                "select0": {"knn_edge_aggregate": 2}}[name]
        assert {k: v for k, v in mk.launch_counts.items() if v} == want
    assert mp.knn_route() == ("3", False)
    assert torch.equal(outs["3"], outs["4"])
    assert torch.equal(outs["select0"][..., -1], outs["4"][..., -1])
    # the plain search ranks exact distances: a near-tie may swap a neighbour
    close = torch.isclose(outs["select0"], outs["4"], **TOL).float().mean().item()
    assert close > 0.8


# ---------------------------------------------------------------------------
# the bf16 modes of K5-K8 (bf16 inputs and weights; idx int32, dists float32)
# ---------------------------------------------------------------------------


def _knn_bf16(d, keys=("xs", "xf", "u1", "u2m", "w_d", "g")):
    """The operands rounded to bf16 (``hidden`` too); the mask as the bf16 u2m
    holds it."""
    out = dict(d, **{k: d[k].to(torch.bfloat16) for k in keys})
    out["hidden"] = _bf16(*d["hidden"])
    return out


@pytest.mark.parametrize("dropout_p", [0.0, 0.5])
@pytest.mark.parametrize("sum_agg,self_loops,want_dists", [(True, True, False),
                                                           (False, False, True)])
@pytest.mark.parametrize("b,n,c,widths,k", KNN_SHAPES)
def test_knn_fused_layer_bf16_matches_plain_twice(dev, b, n, c, widths, k, sum_agg, self_loops,
                                                  want_dists, dropout_p):
    """K5's bf16 mode: the plain version's neighbours (the search widens the
    bf16 inputs, so the keys are built bit for bit), its output within the bf16
    tolerance, float32 distances, its own counts, two launches bit for bit."""
    d = _knn_bf16(_knn_inputs(dev, b, n, c, widths, k, seed=n + 40))
    args = (d["xs"], d["xf"], d["u1"], d["u2m"], d["w_d"] if want_dists else None, d["hidden"],
            k, self_loops, want_dists, 0.2, sum_agg, dropout_p, 4242)
    before, fp32 = dict(mk.launch_counts), _fp32_counts()
    out, idx, dists = kk.knn_fused_layer(*args, True)
    again = kk.knn_fused_layer(*args, True)
    out_eval = kk.knn_fused_layer(*args)[0]
    torch.cuda.synchronize()
    assert mk.launch_counts["knn_fused_layer_train_bf16"] == before["knn_fused_layer_train_bf16"] + 2
    assert mk.launch_counts["knn_fused_layer_bf16"] == before["knn_fused_layer_bf16"] + 1
    assert _fp32_counts() == fp32
    ref, idx_ref, dists_ref = kk.knn_fused_layer_reference(*args, True)
    assert out.dtype == torch.bfloat16 and idx.dtype == torch.int32
    assert torch.equal(idx, idx_ref) and torch.equal(out, out_eval)
    assert torch.equal(out, again[0]) and torch.equal(idx, again[1])
    _assert_bf16_close(out, ref)
    if want_dists:
        assert dists.dtype == torch.float32 and torch.equal(dists, again[2])
        live = torch.gather(d["mask"][:, None, :, 0].expand(-1, n, -1), 2, idx.long()) > 0
        torch.testing.assert_close(dists[live], dists_ref[live], **TOL)


@pytest.mark.parametrize("self_loops,want_dists", [(True, False), (False, True)])
@pytest.mark.parametrize("b,n,c,widths,k", KNN_SHAPES)
def test_knn_search_and_aggregate_bf16_match_plain_and_k5(dev, b, n, c, widths, k, self_loops,
                                                          want_dists):
    """K7's bf16 mode gives the plain search's and K5's neighbours and float32
    distances; K8's bf16 mode on them gives K5's output bit for bit and its
    plain version's within the bf16 tolerance."""
    d = _knn_bf16(_knn_inputs(dev, b, n, c, widths, k, seed=n + 41))
    w_d = d["w_d"] if want_dists else None
    fwd = (d["xs"], d["xf"], d["u1"], d["u2m"], w_d, d["hidden"], k, self_loops, want_dists, 0.2,
           True, 0.5, 77)
    before = dict(mk.launch_counts)
    idx, dists = kk.knn_search(d["xs"], d["xf"], k, self_loops, want_dists)
    out5, idx5, dists5 = kk.knn_fused_layer(*fwd, True)
    out8 = kk.knn_edge_aggregate(d["u1"], d["u2m"], idx, dists, w_d, d["hidden"], 0.2, True, 0.5,
                                 77)
    torch.cuda.synchronize()
    assert mk.launch_counts["knn_search_bf16"] == before["knn_search_bf16"] + 1
    assert mk.launch_counts["knn_edge_aggregate_bf16"] == before["knn_edge_aggregate_bf16"] + 1
    idx_ref, dists_ref = kk.knn_search_reference(d["xs"], d["xf"], k, self_loops, want_dists)
    assert torch.equal(idx, idx_ref) and torch.equal(idx, idx5)
    assert out8.dtype == torch.bfloat16 and torch.equal(out8, out5)
    _assert_bf16_close(out8, kk.knn_edge_aggregate_reference(
        d["u1"], d["u2m"], idx, dists, w_d, d["hidden"], 0.2, True, 0.5, 77))
    if want_dists:
        assert dists.dtype == torch.float32 and torch.equal(dists, dists5)
        torch.testing.assert_close(dists, dists_ref, **TOL)


@pytest.mark.parametrize("need_wgrads", [True, False])
@pytest.mark.parametrize("dropout_p,sum_agg,want_dists", [(0.0, True, False), (0.5, False, True)])
@pytest.mark.parametrize("b,n,c,widths,k", KNN_SHAPES)
def test_knn_edge_aggregate_bwd_bf16_matches_plain_twice(dev, b, n, c, widths, k, dropout_p,
                                                         sum_agg, want_dists, need_wgrads):
    """K6's bf16 mode against its plain version, gradients as a whole, in the
    primals' dtypes (ddists float32), zeros without weight gradients, two
    launches bit for bit."""
    d = _knn_bf16(_knn_inputs(dev, b, n, c, widths, k, seed=n + 42))
    idx, dists = kk.knn_search(d["xs"], d["xf"], k, True, want_dists)
    args = (d["u1"], d["u2m"], idx, dists, d["w_d"] if want_dists else None, d["hidden"], d["g"],
            0.2, sum_agg, dropout_p, 99, need_wgrads)
    name = "knn_edge_aggregate_bwd" + ("" if need_wgrads else "_no_wgrads") + "_bf16"
    before, fp32 = mk.launch_counts[name], _fp32_counts()
    res, again = kk.knn_edge_aggregate_bwd(*args), kk.knn_edge_aggregate_bwd(*args)
    torch.cuda.synchronize()
    assert mk.launch_counts[name] == before + 2 and _fp32_counts() == fp32
    ref = kk.knn_edge_aggregate_bwd_reference(*args)
    flat = lambda t: [x for x in (*t[:5], *t[5]) if x is not None]  # noqa: E731
    assert all(torch.equal(x, y) for x, y in zip(flat(res), flat(again)))
    real = d["mask"] > 0
    _assert_bf16_close(res[0], ref[0], scaled=True)
    _assert_bf16_close(res[1], ref[1], scaled=True)
    _assert_bf16_close(res[2][real], ref[2][real], scaled=True)
    if want_dists:
        assert res[3].dtype == torch.float32
        scale = max(1.0, ref[3].abs().max().item())
        torch.testing.assert_close(res[3] / scale, ref[3] / scale, **BF16_TOL)
    wpairs = list(zip(res[5], ref[5])) + ([(res[4], ref[4])] if want_dists else [])
    for o, r in wpairs:
        if need_wgrads:
            _assert_bf16_close(o, r, scaled=True)
        else:
            assert o.dtype == torch.bfloat16 and not o.any()


@pytest.mark.parametrize("need_wgrads", [True, False])
def test_knn_edge_aggregate_bwd_bf16_main_shape_matches_plain_twice(dev, need_wgrads):
    """K6's bf16 mode at the knn-20 step's shape (B=160 N=150 k=20, dropout
    0.5), its backward products as split-TF32: gradients as a whole within the
    bf16 rules, two launches bit for bit; the FP32 mode on the same values
    within 1e-4 and bit for bit."""
    d32 = _knn_inputs(dev, 160, 150, 32, [96, 160, 192], 20, seed=1515)
    d = _knn_bf16(d32)
    idx = kk.knn_search(d["xs"], d["xf"], 20, True)[0]
    real = d["mask"] > 0
    flat = lambda t: [y for y in (*t[:5], *t[5]) if y is not None]  # noqa: E731
    for x, bf16 in ((d, True), (d32, False)):
        args = (x["u1"], x["u2m"], idx, None, None, x["hidden"], x["g"], 0.2, True, 0.5, 15,
                need_wgrads)
        res, again = kk.knn_edge_aggregate_bwd(*args), kk.knn_edge_aggregate_bwd(*args)
        torch.cuda.synchronize()
        ref = kk.knn_edge_aggregate_bwd_reference(*args)
        assert all(torch.equal(y, z) for y, z in zip(flat(res), flat(again)))
        pairs = [(res[0], ref[0]), (res[1], ref[1]), (res[2][real], ref[2][real])]
        if bf16:
            for o, r in pairs + (list(zip(res[5], ref[5])) if need_wgrads else []):
                _assert_bf16_close(o, r, scaled=True)
        else:
            for o, r in pairs:
                torch.testing.assert_close(o, r, **TOL)
            for o, r in zip(res[5], ref[5]):
                _assert_wgrad_close(o, r)


# The bf16 backward's products as split-TF32, told apart from one TF32 product: the
# share of the bf16 gradients that differ from the plain version's, at LeakyReLU's slope
# 1 (no kink: the gradients meet the recompute only in the products' operands). The
# limit is chip_smoke.py's SPLIT_MAX_DIFFERING, set between its readings: the kernel at
# most 0.16%, the plain version with one TF32 product or a lo term left out at least 1.5%.
SPLIT_MAX_DIFFERING = 0.005


def _tf32_hi(x):
    """float32 ``x`` rounded to TF32, to nearest with ties away."""
    return ((x.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


class _OneTf32Product(types.ModuleType):
    """``torch`` as a plain version's module sees it, its float32 products taken
    as one TF32 product (hi hi, exact in float32, float32 sums)."""

    def __init__(self):
        super().__init__("torch")

    def __getattr__(self, name):
        return getattr(torch, name)

    def matmul(self, a, b):
        if a.dtype != torch.float32 or b.dtype != torch.float32:
            return torch.matmul(a, b)
        return torch.matmul(_tf32_hi(a), _tf32_hi(b))


def _differing_share(outs, refs):
    return sum(int((o != r).sum()) for o, r in zip(outs, refs)) / sum(o.numel() for o in outs)


@pytest.mark.parametrize("need_wgrads", [True, False])
@pytest.mark.parametrize("which", ["k3_n30", "k3_n150", "k6"])
def test_bwd_bf16_split_tf32_differs_from_plain_where_one_tf32_product_would(
        dev, monkeypatch, which, need_wgrads):
    """K3's and K6's bf16 modes at the main paths' shapes, slope 1: at most
    SPLIT_MAX_DIFFERING of du1 and du2, and of the weight gradients, differ from
    the plain version's, where the plain version with one TF32 product differs
    in more."""
    if which == "k6":
        d = _knn_bf16(_knn_inputs(dev, 160, 150, 32, [96, 160, 192], 20, seed=1516))
        idx = kk.knn_search(d["xs"], d["xf"], 20, True)[0]
        args = (d["u1"], d["u2m"], idx, None, None, d["hidden"], d["g"], 1.0, True, 0.5, 16,
                need_wgrads)
        kernel, plain, module, wgrads_at = (kk.knn_edge_aggregate_bwd,
                                            kk.knn_edge_aggregate_bwd_reference, kk, 5)
    else:
        b, n = (256, 30) if which == "k3_n30" else (32, 150)
        u1, u2, mask, hidden, g = _chain(dev, b, n, [96, 160, 192], seed=n + 16)
        args = (*_bf16(u1, u2, mask), _bf16(*hidden), *_bf16(g), 1.0, True, 0.5, 1616,
                need_wgrads)
        kernel, plain, module, wgrads_at = (mk.edge_aggregate_bwd,
                                            mk.edge_aggregate_bwd_reference, mk, 3)

    def groups(t):
        return [t[:2]] + ([t[wgrads_at]] if need_wgrads else [])

    out = groups(kernel(*args))
    torch.cuda.synchronize()
    ref = groups(plain(*args))
    with monkeypatch.context() as m:
        m.setattr(module, "torch", _OneTf32Product())
        one = groups(plain(*args))
    for o, r, c in zip(out, ref, one):
        assert _differing_share(o, r) <= SPLIT_MAX_DIFFERING < _differing_share(c, r)


def test_knn_function_bf16_grads_match_the_cpu_and_take_the_primals_dtypes(dev):
    """``KnnFusedLayer`` (K5 -> K6, the distance glue in bf16) on the card
    against the same Function on the CPU (the plain versions): every gradient
    bf16, held as a whole."""
    d = _knn_bf16(_knn_inputs(dev, 4, 150, 3, [96, 160, 192], 20, seed=43))

    def grads(device):
        ins = [d[key].to(device).clone().requires_grad_() for key in ("xs", "xf", "u1", "u2m",
                                                                      "w_d")]
        hidden = [t.to(device).clone().requires_grad_() for t in d["hidden"]]
        out = kk.knn_aggregate(*ins, hidden, 20, False, True, 0.2, True, 0.5, 5)
        (out.float() * d["g"].to(device).float()).sum().backward()
        return [t.grad for t in ins + hidden]

    card, cpu = grads(dev), grads(torch.device("cpu"))
    for x, y in zip(card, cpu):
        assert x.dtype == torch.bfloat16
        _assert_bf16_close(x.cpu(), y, scaled=True)


def test_knn_wrappers_refuse_mixed_dtypes_on_the_card(dev):
    d = _knn_inputs(dev, 2, 13, 8, [24, 16, 12], 5, seed=44)
    b = _knn_bf16(d)
    with pytest.raises(TypeError, match="all-float32 or all-bfloat16"):
        kk.knn_fused_layer(b["xs"], b["xf"], d["u1"], b["u2m"], None, b["hidden"], 5, True,
                           False, 0.2, True)
    with pytest.raises(TypeError, match="all-float32 or all-bfloat16"):
        kk.knn_search(b["xs"], d["xf"], 5, True)
    idx, dists = kk.knn_search(b["xs"], b["xf"], 5, True, True)
    with pytest.raises(TypeError, match="dists must be float32"):
        kk.knn_edge_aggregate(b["u1"], b["u2m"], idx, dists.bfloat16(), b["w_d"], b["hidden"],
                              0.2, True)


# ---------------------------------------------------------------------------
# K9: the fused GAPT generator
# ---------------------------------------------------------------------------


def _gapt(dev, n, e, heads, layers, masked, seed=0):
    from mpgan_tpu_torch.models.gapt import GAPTConfig, GAPTGenerator

    cfg = GAPTConfig(num_particles=n, feat_size=3, is_generator=True, sab_layers=layers,
                     num_heads=heads, embed_dim=e, use_mask=masked)
    return GAPTGenerator(cfg, prng.PRNGKey(seed), device=dev)


@pytest.mark.parametrize("n,e,heads,layers,masked,b", [
    (30, 64, 4, 4, True, 256),    # the default generator
    (30, 64, 4, 4, False, 64),
    (30, 64, 4, 4, True, 37),     # an odd batch
    (150, 64, 4, 4, True, 16),    # the 150-particle size
    (25, 32, 2, 2, True, 10),
    (100, 32, 4, 1, True, 3),
    (9, 10, 5, 2, True, 5),       # widths that are no multiple of 4: the scalar path
    (300, 64, 4, 2, True, 3),     # qkv in device scratch
    (512, 64, 4, 1, True, 2),     # the gate's cap
    (40, 48, 2, 2, True, 4),      # head width 24 does not divide a warp
])
def test_gapt_fused_kernel_matches_plain(dev, n, e, heads, layers, masked, b):
    from mpgan_tpu_torch.ops import gapt_kernels as gk

    g = _gapt(dev, n, e, heads, layers, masked)
    gen = torch.Generator(device=dev).manual_seed(n)
    x = torch.randn(b, n, e, generator=gen, device=dev)
    mask = None
    if masked:
        counts = torch.randint(1, n + 1, (b,), generator=gen, device=dev)
        counts[0] = n
        mask = (torch.arange(n, device=dev)[None, :] < counts[:, None]).float()[..., None]
    w = g.fused_weights()
    before = mk.launch_counts["gapt_g_fused"]
    with torch.no_grad():
        out = gk.gapt_g_fused(x, mask, w, heads, 0.2)
        torch.cuda.synchronize()
        ref = gk.gapt_g_fused_reference(x, mask, w, heads, 0.2)
    assert mk.launch_counts["gapt_g_fused"] == before + 1
    torch.testing.assert_close(out, ref, **TOL)
    if masked:
        assert torch.equal(out[..., -1], ref[..., -1])


def _gapt_inputs(dev, b, n, e, masked, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(b, n, e, generator=gen, device=dev)
    mask = None
    if masked:
        counts = torch.randint(1, n + 1, (b,), generator=gen, device=dev)
        counts[0] = n
        mask = (torch.arange(n, device=dev)[None, :] < counts[:, None]).float()[..., None]
    return x, mask


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("b", [1, 3, 37, 1023, 4097])
def test_gapt_fused_kernel_short_items_match_plain_and_rerun(dev, b, masked):
    """Batches that are no multiple of the 4 jets an item holds at N = 30: the last
    item is short, its missing jets are computed as zeros and never stored; a
    rerun gives the same bits, and a jet's bits do not depend on its item."""
    from mpgan_tpu_torch.ops import gapt_kernels as gk

    g = _gapt(dev, 30, 64, 4, 4, masked)
    x, mask = _gapt_inputs(dev, b, 30, 64, masked, seed=b)
    w = g.fused_weights()
    assert gk.gapt_plan(b, 30, 64, 4, mk._sm_count(x.device)).jets == 4
    with torch.no_grad():
        out = gk.gapt_g_fused(x, mask, w, 4, 0.2)
        again = gk.gapt_g_fused(x, mask, w, 4, 0.2)
        m = min(b, 5)
        first = gk.gapt_g_fused(x[:m], None if mask is None else mask[:m], w, 4, 0.2)
        torch.cuda.synchronize()
        ref = gk.gapt_g_fused_reference(x, mask, w, 4, 0.2)
    torch.testing.assert_close(out, ref, **TOL)
    assert torch.equal(out, again) and torch.equal(first, out[:m])
    if masked:
        assert torch.equal(out[..., -1], ref[..., -1])


def test_gapt_plans_on_the_card_equal_the_launcher(dev):
    """gapt_kernels.gapt_plan against the kernel's own layout check: the item
    path's shared memory where the plan takes it, a refusal where it leaves the
    size to the per-jet path."""
    from mpgan_tpu_torch.ops import gapt_kernels as gk

    lib = _build.library()
    for n, e, heads in ((30, 64, 4), (150, 64, 4), (25, 32, 2), (100, 32, 4), (40, 48, 2),
                        (1, 64, 4), (9, 10, 5), (64, 64, 1), (161, 64, 4), (300, 64, 4)):
        plan = gk.gapt_plan(64, n, e, heads, 132)
        smem = ctypes.c_longlong(-1)
        if plan.jets:
            assert lib.mpgan_gapt_item_smem(n, e, heads, plan.jets, plan.rows,
                                            plan.slab_floats, ctypes.byref(smem)) == 0
            assert smem.value == plan.smem_bytes, (n, e, heads)
        else:
            jets = max(1, 128 // plan.ns)
            rows = -(-(jets * plan.ns) // 32) * 32
            assert lib.mpgan_gapt_item_smem(n, e, heads, jets, rows, 12 * e,
                                            ctypes.byref(smem)) == -1, (n, e, heads)


def test_gapt_generator_kernel_route_matches_plain_route(dev):
    g = _gapt(dev, 30, 64, 4, 4, True)
    noise = torch.randn(33, 30, 64, device=dev) * 0.2
    labels = torch.rand(33, 1, device=dev) * 0.9 + 0.1
    mk.reset_launch_counts()
    with torch.inference_mode():
        y_k = g(noise, labels)
        g.cfg = dataclasses.replace(g.cfg, use_kernels=False)
        y_p = g(noise, labels)
    assert mk.launch_counts["gapt_g_fused"] == 1
    torch.testing.assert_close(y_k, y_p, **TOL)
    assert torch.equal(y_k[..., -1], y_p[..., -1])
    # with gradients enabled the default route is the plain path; the wrapper itself raises
    g.cfg = dataclasses.replace(g.cfg, use_kernels=None)
    y = g(noise, labels)
    assert y.requires_grad and mk.launch_counts["gapt_g_fused"] == 1
    from mpgan_tpu_torch.ops import gapt_kernels as gk
    with pytest.raises(RuntimeError, match="eval only"):
        gk.gapt_g_fused(noise.requires_grad_(), None, g.fused_weights(), 4, 0.2)


@pytest.mark.parametrize("b,masked", [(256, True), (37, False)])
def test_gapt_fused_bf16_widens_runs_k9_and_rounds(dev, b, masked):
    """K9 on bf16 inputs: the float32 kernel on their float32 values, counted
    as ``gapt_g_fused_bf16``, the output rounded to bf16: equal to the FP32
    launch on the widened inputs, rounded, and within the bf16 tolerance of
    the plain version."""
    from mpgan_tpu_torch.ops import gapt_kernels as gk

    g = _gapt(dev, 30, 64, 4, 4, masked)
    x, mask = _gapt_inputs(dev, b, 30, 64, masked, seed=b + 7)
    w = gk.GaptWeights(*_bf16(*g.fused_weights()))
    x16, m16 = x.bfloat16(), None if mask is None else mask.bfloat16()
    before = dict(mk.launch_counts)
    with torch.no_grad():
        out = gk.gapt_g_fused(x16, m16, w, 4, 0.2)
        wide = gk.gapt_g_fused(x16.float(), None if m16 is None else m16.float(),
                               gk.GaptWeights(*(t.float() for t in w)), 4, 0.2)
        torch.cuda.synchronize()
        ref = gk.gapt_g_fused_reference(x16, m16, w, 4, 0.2)
    assert mk.launch_counts["gapt_g_fused_bf16"] == before["gapt_g_fused_bf16"] + 1
    assert mk.launch_counts["gapt_g_fused"] == before["gapt_g_fused"] + 1
    assert out.dtype == torch.bfloat16 and torch.equal(out, wide.bfloat16())
    _assert_bf16_close(out, ref)
    with pytest.raises(TypeError, match="all-float32 or all-bfloat16"):
        gk.gapt_g_fused(x, m16, w, 4, 0.2)


@pytest.mark.parametrize("b,n,e,heads,masked", [
    (256, 30, 64, 4, True),   # the item path (the bf16 GAPT step's fake batch is 512)
    (37, 30, 64, 4, False),   # items ending short
    (3, 300, 64, 4, True),    # the per-jet path, qkv in device scratch
    (5, 9, 10, 5, True),      # the per-jet path's scalar loads (E not a multiple of 4)
])
def test_gapt_fused_bf16_entry_is_one_kernel_on_both_paths(dev, b, n, e, heads, masked):
    """K9's bf16 entry reads the bf16 tensors itself: a call launches K9 once (its
    count) and runs no torch operator but allocations (a ``TorchDispatchMode``
    records them; a cast is ``aten._to_copy``), on the item path and the per-jet
    path; its output is the FP32 launch's on the widened inputs, rounded, twice
    bit for bit."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from mpgan_tpu_torch.ops import gapt_kernels as gk

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops.append(str(func))
            return func(*args, **(kwargs or {}))

    g = _gapt(dev, n, e, heads, 2, masked)
    x, mask = _gapt_inputs(dev, b, n, e, masked, seed=b + n)
    w = gk.GaptWeights(*_bf16(*g.fused_weights()))
    x16, m16 = x.bfloat16(), None if mask is None else mask.bfloat16()
    path = gk.gapt_plan(b, n, e, heads, mk._sm_count(dev)).jets > 0
    assert path == (n == 30)
    with torch.no_grad():
        before = mk.launch_counts["gapt_g_fused_bf16"]
        with Ops() as mode:
            out = gk.gapt_g_fused(x16, m16, w, heads, 0.2)
        assert mk.launch_counts["gapt_g_fused_bf16"] == before + 1
        assert mode.ops and all(o in ("aten.empty.memory_format", "aten.empty_strided.default")
                                for o in mode.ops), mode.ops
        again = gk.gapt_g_fused(x16, m16, w, heads, 0.2)
        wide = gk.gapt_g_fused(x16.float(), None if m16 is None else m16.float(),
                               gk.GaptWeights(*(t.float() for t in w)), heads, 0.2)
        torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16 and torch.equal(out, again)
    assert torch.equal(out, wide.bfloat16())


def test_backward_kernels_build_and_run_with_phase_clocks(dev):
    """The ``-DMPGAN_PHASE_CLOCKS`` build of K3 and K6 (a process holds one build,
    so a process of its own): it compiles, agrees with the plain versions, and
    every timed shape reports clocks in the phases of a pass."""
    import json
    import pathlib
    import subprocess
    import sys

    script = pathlib.Path(__file__).resolve().parents[1] / "scripts" / "torch_bwd_bench.py"
    run = subprocess.run([sys.executable, str(script), "--phases", "--reps", "1"],
                         capture_output=True, text=True, timeout=900)
    assert run.returncode == 0, run.stdout[-2000:] + run.stderr[-4000:]
    rows = [json.loads(line) for line in run.stdout.splitlines() if line.startswith("{")]
    timed = [r for r in rows if "kernel" in r]
    assert len(timed) == 6 and rows[0]["phases"] is True
    for r in timed:
        shares = r["phase_shares"]
        assert r["within_tol"] and r["two_runs_bit_identical"], r
        assert shares["in_products_loop"] > 0 and shares["tail"] > 0, r
        assert (shares["wgrad"] > 0) == r["wgrads"], r
        assert abs(sum(list(shares.values())[:7]) - 1.0) < 1e-2, r


def test_knn_forward_kernels_build_and_run_with_phase_clocks(dev):
    """The ``-DMPGAN_PHASE_CLOCKS`` build of K5, K8 and K7 (a process of its own):
    the knn bench compiles, its kernels agree with their plain versions, K5's
    and K8's clocks fall into the phases of a pass, K5's search among them, and
    K5's and K7's searches split into staging, keys, selection and outputs."""
    import json
    import pathlib
    import subprocess
    import sys

    script = pathlib.Path(__file__).resolve().parents[1] / "scripts" / "torch_knn_bench.py"
    run = subprocess.run([sys.executable, str(script), "--phases", "--reps", "1"],
                         capture_output=True, text=True, timeout=900)
    assert run.returncode == 0, run.stdout[-2000:] + run.stderr[-4000:]
    rows = [json.loads(line) for line in run.stdout.splitlines() if line.startswith("{")]
    timed = [r for r in rows if "kernel" in r]
    assert len(timed) == 8 and rows[0]["phases"] is True
    for r in timed:
        assert r["agrees"] and r["two_runs_bit_identical"], r
        if r["kernel"] != "knn_edge_aggregate":
            split = r["phase_shares"]["search_split"]
            assert split["stage"] > 0 and split["keys"] > 0, r
            assert abs(sum(split.values()) - 1.0) < 1e-2, r
        if r["kernel"] == "knn_search":
            continue
        shares = r["phase_shares"]
        assert shares["in_products_loop"] > 0 and shares["tail"] > 0, r
        assert (shares["search"] > 0) == (r["kernel"] == "knn_fused_layer"), r
        assert abs(sum(list(shares.values())[:4]) + shares["search"] - 1.0) < 1e-2, r


# ---------------------------------------------------------------------------
# threefry_draws: the steps' random stream (ops/prng.py, csrc/threefry.cu)
# ---------------------------------------------------------------------------

PRNG_ROWS = [prng.Row("order", (6,)), prng.Row("key", (2,), (3, prng.COUNTER, 1)),
             prng.Row("key", (2,), (2,)), prng.Row("words", (1,), (1, 0, 4)),
             prng.Row("edge_seed", (1,), (5, 2)), prng.Row("uniform", (3000,), (7,), -3.0, 2.0),
             prng.Row("uniform", (5000, 3), (1,), 0.7, 1.2), prng.Row("uniform", (70,), (2,)),
             prng.Row("normal", (2**17 + 5,), (1, 0), 0.2), prng.Row("normal", (33,), (4,), 1.0),
             prng.Row("words", (1,), (3,)), prng.Row("edge_seed", (1,), (3, prng.COUNTER))]


@pytest.mark.parametrize("advance,bump", [(0, False), (1, True), (2, True)])
def test_threefry_draws_matches_its_plain_version(dev, advance, bump):
    """Every distribution against the plain version on the CPU, bit for bit (the
    normals' log1p is written out in both, every rounding the same); the next
    key and the counter too."""
    order = torch.arange(30, dtype=torch.int32).reshape(5, 6)
    outs = {}
    for side, device in (("card", dev), ("cpu", "cpu")):
        plan = prng.Plan(PRNG_ROWS, device)
        key = prng.PRNGKey(11, device)
        counter = torch.tensor([2], dtype=torch.int32, device=device)
        out = plan.run(key, None, counter, order.to(device), advance=advance, bump=bump)
        outs[side] = ([v.cpu() for v in plan.views(out)], key.cpu(), counter.cpu())
    before = prng.launch_counts["threefry_draws"]
    torch.cuda.synchronize()
    (vc, kc, cc), (vp, kp, cp) = outs["card"], outs["cpu"]
    for r, a, b in zip(PRNG_ROWS, vc, vp):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32)), r
    assert torch.equal(kc, kp) and torch.equal(cc, cp)
    assert prng.launch_counts["threefry_draws"] == before


def test_threefry_draws_advances_in_place_over_many_launches(dev):
    """The last block writes the next key after every block has read it; the
    ticket resets, so a hundred launches give the plain version's key."""
    plan = prng.Plan([prng.Row("normal", (300_000,), (1,), 1.0)], dev)
    key, ref = prng.PRNGKey(3, dev), prng.PRNGKey(3)
    out = torch.empty(plan.words, dtype=torch.int32, device=dev)
    before = prng.launch_counts["threefry_draws"]
    for _ in range(100):
        plan.run(key, out, advance=1)
    for _ in range(100):
        ref = prng.fold_in(ref, 0)
    torch.cuda.synchronize()
    assert torch.equal(key.cpu(), ref)
    assert prng.launch_counts["threefry_draws"] == before + 100


def test_threefry_draws_in_a_graph_draws_anew_at_every_replay(dev):
    """A captured launch reads the key and the counter at each replay and
    advances both; CountedGraph counts its launches."""
    order = torch.arange(12, dtype=torch.int32, device=dev).reshape(3, 4)
    plan = prng.Plan([prng.Row("order", (4,)), prng.Row("normal", (64,), (prng.COUNTER, 0), 1.0)],
                     dev)
    key, counter = prng.PRNGKey(5, dev), torch.zeros(1, dtype=torch.int32, device=dev)
    out = torch.empty(plan.words, dtype=torch.int32, device=dev)
    plan.run(key.clone(), out, counter.clone(), order)  # warm-up outside the capture
    mk.reset_launch_counts()
    graph = mk.CountedGraph(lambda: plan.run(key, out, counter, order, advance=1, bump=True))
    seen = []
    for _ in range(3):
        graph.replay()
        seen.append([v.clone() for v in plan.views(out)])
    torch.cuda.synchronize()
    assert prng.launch_counts["threefry_draws"] == 3 and int(counter) == 3
    ref_key = prng.PRNGKey(5)
    for c, (rows, noise) in enumerate(seen):
        assert rows.tolist() == list(range(4 * c, 4 * c + 4))
        want = prng.normal(prng.fold_in(prng.fold_in(ref_key, c), 0), (64,))
        assert torch.equal(noise.cpu(), want)
        ref_key = prng.fold_in(ref_key, 0)
    assert torch.equal(key.cpu(), ref_key)
    mk.reset_launch_counts()


def test_threefry_draws_refuses_a_plan_without_its_counter(dev):
    with pytest.raises(ValueError, match="counter"):
        prng.Plan([prng.Row("uniform", (4,), (prng.COUNTER,))], dev).run(prng.PRNGKey(0, dev))
