"""The CUDA kernels against their plain PyTorch versions, on an NVIDIA GPU.

Marked ``cuda``: they skip where ``torch.cuda.is_available()`` is false (no
CUDA kernel runs on the CPU). Run them on a GPU machine with
``python -m pytest tests/test_torch_cuda_kernels.py -q --noconftest`` (the
suite's conftest imports jax, which the port does not need). Flagship widths;
tolerance rtol = atol = 1e-4 (FP32 FMA chains against cuBLAS FP32, TF32 off).
"""

import ctypes
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from mpgan_tpu_torch.models.mpgan import MPGenerator
from mpgan_tpu_torch.ops import _build
from mpgan_tpu_torch.ops import mp_kernels as mk
from mpgan_tpu_torch.training.config import build_mpgan_generator, from_args_dict

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
    code = _build.library().mpgan_edge_aggregate(
        u1.data_ptr(), u2.data_ptr(), mask.data_ptr(), out.data_ptr(), 2, 30, 96, 2, w, b, dims,
        0.2, 1, torch.cuda.current_stream().cuda_stream,
    )
    assert code != 0
    with pytest.raises(RuntimeError, match="CUDA error"):
        _build.check(code, "edge_aggregate")


@pytest.mark.parametrize("num_hits", [30, 150])
def test_generator_kernel_path_matches_plain_path(dev, num_hits):
    cfg = build_mpgan_generator(from_args_dict({"model": "mpgan", "num_hits": num_hits}))
    g = MPGenerator(cfg, torch.Generator().manual_seed(0), device=dev)
    noise = torch.randn(8, num_hits, 32, generator=torch.Generator(device=dev).manual_seed(1),
                        device=dev) * 0.2
    labels = torch.full((8, 1), 0.7, device=dev)
    with torch.inference_mode():
        y_kernel = g(noise, labels)
        g.cfg = dataclasses.replace(cfg, use_kernels=False)
        y_plain = g(noise, labels)
    torch.testing.assert_close(y_kernel, y_plain, **TOL)
    assert torch.equal(y_kernel[..., -1], y_plain[..., -1])
