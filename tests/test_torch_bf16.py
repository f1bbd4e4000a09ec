"""bf16 mixed-precision training (``--compute-dtype bfloat16``) in the port
against the JAX package on the CPU.

- K2 (eval and dropout 0.5), K3 (with and without weight gradients, through
  ``jax.grad`` of the custom VJP) and K4: the bf16 modes of the plain versions
  against the Pallas kernels called with bf16 refs (interpret mode), at widths
  that are no multiples of 16, sum and mean, within rtol = atol = 1e-2 (one
  bf16 rounding is 2^-8; the two sum in other orders before they round);
- bf16 with a knn layer or GAPT passes ``check_supported`` (its kernels:
  ``tests/test_torch_bf16_knn.py``, ``tests/test_torch_bf16_gapt.py``); a tiny
  bf16 run of the train CLI with a resume.

The bf16 steps and the batched D pass: ``tests/test_torch_bf16_steps.py``.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one thread a test worker: the suite runs in parallel workers

import jax
import jax.numpy as jnp

import mpgan_tpu.ops.mp_pallas as jmpp
from mpgan_tpu_torch.cli import args as targs_cli
from mpgan_tpu_torch.cli import train as ttrain_cli
from mpgan_tpu_torch.ops import mp_kernels as tmk
from mpgan_tpu_torch.training.loop import check_supported

BF16_TOL = dict(rtol=1e-2, atol=1e-2)
SEED = int(np.float32(123456789))
WIDTHS = (20, 13, 12)  # no multiple of 16 (K) or of 8 (M)


def _inputs(n, b=2, widths=WIDTHS, seed=1):
    rng = np.random.RandomState(seed)
    f = lambda *s, scale=1.0: (rng.randn(*s) * scale).astype(np.float32)  # noqa: E731
    u1, u2 = f(b, n, widths[0], scale=0.5), f(b, n, widths[0], scale=0.5)
    mask = (rng.rand(b, n, 1) > 0.3).astype(np.float32)
    hidden = []
    for a, c in zip(widths[:-1], widths[1:]):
        hidden += [f(a, c, scale=a ** -0.5), f(c, scale=0.1)]
    return u1, u2, mask, tuple(hidden), f(b, n, widths[-1])


def _tb(a):
    return torch.from_numpy(np.ascontiguousarray(a)).to(torch.bfloat16)


def _jb(a):
    return jnp.asarray(a).astype(jnp.bfloat16)


def _close(t, j, scaled=False):
    """A port tensor (bf16) against a JAX array (bf16) at BF16_TOL; ``scaled``:
    on the scale of the largest of ``j`` (gradients: a pre-activation within
    rounding of zero may take the other LeakyReLU slope)."""
    assert t.dtype == torch.bfloat16 and j.dtype == jnp.bfloat16
    j = np.asarray(j.astype(jnp.float32))
    bound = max(1.0, np.abs(j).max()) if scaled else 1.0
    np.testing.assert_allclose(t.float().numpy() / bound, j / bound, **BF16_TOL)


# ---------------------------------------------------------------------------
# K2, K3, K4: the bf16 plain versions against the Pallas kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,sum_agg,dropout_p", [(13, True, 0.0), (13, False, 0.5),
                                                 (30, True, 0.5)])
def test_edge_aggregate_bf16_reference_matches_pallas(n, sum_agg, dropout_p):
    u1, u2, mask, hidden, _ = _inputs(n)
    j = jmpp.edge_aggregate(_jb(u1), _jb(u2), _jb(mask), tuple(map(_jb, hidden)),
                            jnp.float32(SEED), 0.2, sum_agg, 32, dropout_p, True)
    t = tmk.edge_aggregate(_tb(u1), _tb(u2), _tb(mask), tuple(map(_tb, hidden)), 0.2, sum_agg,
                           dropout_p, SEED)
    _close(t, j)


def _jax_grads(u1, u2, mask, hidden, g, sum_agg, dropout_p, need_wgrads):
    def f(u1, u2, mask, hidden):
        out = jmpp.edge_aggregate(u1, u2, mask, hidden, jnp.float32(SEED), 0.2, sum_agg, 32,
                                  dropout_p, need_wgrads)
        return jnp.sum(out.astype(jnp.float32) * _jb(g).astype(jnp.float32))

    return jax.grad(f, argnums=(0, 1, 2, 3))(_jb(u1), _jb(u2), _jb(mask),
                                             tuple(map(_jb, hidden)))


@pytest.mark.parametrize("need_wgrads", [True, False])
@pytest.mark.parametrize("sum_agg,dropout_p", [(True, 0.0), (False, 0.5)])
def test_edge_aggregate_bwd_bf16_reference_matches_jax_grad(need_wgrads, sum_agg, dropout_p):
    u1, u2, mask, hidden, g = _inputs(13)
    ju1, ju2, jmask, jhidden = _jax_grads(u1, u2, mask, hidden, g, sum_agg, dropout_p,
                                          need_wgrads)
    du1, du2, dmask, dhidden = tmk.edge_aggregate_bwd(
        _tb(u1), _tb(u2), _tb(mask), tuple(map(_tb, hidden)), _tb(g), 0.2, sum_agg, dropout_p,
        SEED, need_wgrads)
    for t, j in zip((du1, du2, dmask, *dhidden), (ju1, ju2, jmask, *jhidden)):
        _close(t, j, scaled=True)
    if not need_wgrads:
        assert not any(t.any() for t in dhidden)


@pytest.mark.parametrize("dropout_p", [0.0, 0.5])
def test_edge_aggregate_function_bf16_grads_match_jax(dropout_p):
    """The autograd Function in the bf16 mode: gradients in the inputs' and
    the weights' dtype (bf16), as the JAX package's custom VJP returns them."""
    u1, u2, mask, hidden, g = _inputs(30)
    jgrads = _jax_grads(u1, u2, mask, hidden, g, True, dropout_p, True)
    ins = [_tb(a).requires_grad_() for a in (u1, u2, mask, *hidden)]
    out = tmk.EdgeAggregate.apply(*ins[:3], 0.2, True, dropout_p, SEED, *ins[3:])
    assert out.dtype == torch.bfloat16
    (out.float() * _tb(g).float()).sum().backward()
    for t, j in zip(ins, (*jgrads[:3], *jgrads[3])):
        _close(t.grad, j, scaled=True)


@pytest.mark.parametrize("fn_case", ["small", "flagship_fn_32", "flagship_fn_3"])
@pytest.mark.parametrize("sum_agg,final_linear", [(True, True), (False, False)])
def test_edge_aggregate_fn_bf16_reference_matches_pallas(sum_agg, final_linear, fn_case):
    """K4: fn's first layer takes the float32 aggregate and f32(x) with the bf16
    weights' values, later layers bf16-rounded inputs (``mp_pallas._fn_tail``); at
    widths that are no multiples of 16, and at the flagship's (fe [96, 160, 192], fn
    [224, 256, 256] to the first MP layer's 32 and the last one's 3, as the bf16 D+G
    step's G runs it), at B=2 N=8. At the flagship's widths fn sums 224 and 256
    bf16-rounded inputs, so an input one rounding apart moves an output by 2^-8 of a
    term, not of the output: held on the scale of the largest output, as the card
    tests hold K4's bf16 mode."""
    if fn_case == "small":
        n, feat, fn_widths = 13, 5, (20, 7)
        u1, u2, mask, hidden, _ = _inputs(n)
    else:
        n, feat = 8, 32
        fn_widths = (256, 256, 32 if fn_case == "flagship_fn_32" else 3)
        u1, u2, mask, hidden, _ = _inputs(n, widths=(96, 160, 192))
    rng = np.random.RandomState(5)
    f = lambda *s, scale=0.3: (rng.randn(*s) * scale).astype(np.float32)  # noqa: E731
    x = f(2, n, feat)
    k = hidden[-1].shape[0] + feat
    scale = 0.3 if fn_case == "small" else k ** -0.5
    fn = [f(hidden[-1].shape[0], fn_widths[0], scale=scale), f(feat, fn_widths[0], scale=scale),
          f(fn_widths[0])]
    for a, c in zip(fn_widths[:-1], fn_widths[1:]):
        fn += [f(a, c, scale=0.3 if fn_case == "small" else a ** -0.5), f(c)]
    j = jmpp.edge_aggregate_fn(_jb(u1), _jb(u2), _jb(mask), tuple(map(_jb, hidden)), _jb(x),
                               tuple(map(_jb, fn)), 0.2, sum_agg, 32, 0.1, final_linear)
    t = tmk.edge_aggregate_fn(_tb(u1), _tb(u2), _tb(mask), tuple(map(_tb, hidden)), _tb(x),
                              tuple(map(_tb, fn)), 0.2, sum_agg, 0.1, final_linear)
    assert t.shape == (2, n, fn_widths[-1])
    _close(t, j, scaled=fn_case != "small")


def test_wrappers_refuse_a_mix_of_dtypes():
    u1, u2, mask, hidden, g = _inputs(13)
    f32 = lambda a: torch.from_numpy(a)  # noqa: E731
    with pytest.raises(TypeError, match="all-float32 or all-bfloat16"):
        tmk.edge_aggregate(_tb(u1), f32(u2), f32(mask), tuple(map(f32, hidden)), 0.2, True)
    with pytest.raises(TypeError, match="all-float32 or all-bfloat16"):
        tmk.edge_aggregate_bwd(_tb(u1), _tb(u2), _tb(mask), tuple(map(f32, hidden)), _tb(g),
                               0.2, True)


# ---------------------------------------------------------------------------
# what bf16 refuses, and the train CLI
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("flags", [
    ["--no-fully-connected", "--num-knn", "3"],
    ["--model", "old_mpgan", "--model-D", "mpgan", "--no-fully-connected", "--num-knn", "3",
     "--lr-disc", "3e-5", "--lr-gen", "1e-5"],
    ["--model", "gapt"],
    ["--model", "rgan", "--model-D", "gapt"],
], ids=["knn", "legacy_knn", "gapt", "gapt_d"])
def test_bf16_refuses_the_knn_and_gapt_paths(tmp_path, flags):
    """The knn and GAPT paths, refused in bf16 until their kernels' bf16 modes
    were ported, now pass ``check_supported`` in bf16 as in float32, with
    ``--multi-gpu`` and a mesh too; what bf16 refuses with them is what every
    dtype refuses, a mesh that does not split the batch (the bf16 steps:
    tests/test_torch_bf16_knn.py and tests/test_torch_bf16_gapt.py)."""
    args = targs_cli.parse_cli(["--name", "r", "--dir-path", str(tmp_path), "--num-hits", "8",
                                "--compute-dtype", "bfloat16", *flags])
    check_supported(args)
    args.multi_gpu, args.mesh_shape = True, "2"
    check_supported(args)
    args.mesh_shape = str(args.batch_size + 1)
    with pytest.raises(ValueError, match="not divisible by --mesh-shape"):
        check_supported(args)
    args.multi_gpu, args.mesh_shape, args.compute_dtype = False, None, "float32"
    check_supported(args)


def test_train_cli_bf16_trains_resumes_and_keeps_float32_checkpoints(tmp_path):
    argv = ["--device", "cpu", "--name", "b", "--dir-path", str(tmp_path), "--model", "mpgan",
            "--jets", "g", "--num-hits", "8", "--hidden-node-size", "8", "--fe", "12", "16",
            "--fn", "16", "--batch-size", "16", "--num-samples", "200",
            "--eval-tot-samples", "64", "--w1-num-samples", "50", "--save-epochs", "2",
            "--save-model-epochs", "1", "--compute-dtype", "bfloat16"]
    t = ttrain_cli.main(argv + ["--num-epochs", "2"])
    assert t.step_cfg.bf16 and not t.step_cfg.batched_d
    assert np.isfinite(t.losses["G"]).all() and len(t.losses["w1m"]) == 1
    npz = np.load(tmp_path / "b" / "models" / "state_2.npz")
    assert all(npz[k].dtype != np.float16 and npz[k].dtype.kind != "V" for k in npz.files)
    assert any(npz[k].dtype == np.float32 for k in npz.files)
    t3 = ttrain_cli.main(argv + ["--num-epochs", "3"])
    assert t3.start_epoch == 2 and t3.step_cfg.bf16
    assert len(t3.losses["G"]) == 3 and t3.losses["G"][:2] == t.losses["G"]
    assert all(p.dtype == torch.float32 for p in t3.state.g.parameters())
