"""bf16 training of GAPT (``--compute-dtype bfloat16`` with ``--model gapt`` or
``--model-D gapt``) in the port against the JAX package on the CPU.

- K9 on bf16 inputs: the plain version against ``gapt_pallas.gapt_g_fused``
  (interpret mode) on bf16 noise, mask and parameters, which it widens to its
  float32 body: output bf16 within rtol = atol = 1e-2;
- the weights K9 reads follow ``bf16_apply``'s fresh bf16 copies on every call
  (a master parameter changed between two calls shows in the output), and the
  module's own float32 parameters stay cached until one changes;
- the bf16 D and G steps of the GAPT pair (with the batched real+fake D pass)
  and of rGAN G with a GAPT D against JAX's (under ``jax.jit``), at
  ``test_torch_bf16_steps``' bounds; a mix of dtypes raises; a tiny bf16 run of
  the train CLI with a resume.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one thread a test worker: the suite runs in parallel workers

import jax
import jax.numpy as jnp

from mpgan_tpu.models import gapt as jgapt
from mpgan_tpu.ops import gapt_pallas as jgp
from mpgan_tpu_torch.cli import train as ttrain_cli
from mpgan_tpu_torch.models import gapt as tgapt
from mpgan_tpu_torch.ops import gapt_kernels as gk
from mpgan_tpu_torch.training import train_step as tts
from mpgan_tpu_torch.utils.weights import gapt_generator_from_jax

from test_torch_bf16_knn import check_bf16_steps, jit_steps
from test_torch_bf16_steps import GAPT_CARD, _Pair

BF16_TOL = dict(rtol=1e-2, atol=1e-2)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _generator(n, e, h, layers, masked, seed=0):
    jcfg = jgapt.GAPTConfig(num_particles=n, feat_size=3, is_generator=True, sab_layers=layers,
                            num_heads=h, embed_dim=e, use_mask=masked)
    tcfg = tgapt.GAPTConfig(num_particles=n, feat_size=3, is_generator=True, sab_layers=layers,
                            num_heads=h, embed_dim=e, use_mask=masked, use_kernels=True)
    params, state = jgapt.gapt_g_init(jax.random.PRNGKey(seed), jcfg)
    return jcfg, params, gapt_generator_from_jax(_np(params), _np(state), tcfg)


def _noise(n, e, b, seed):
    rs = np.random.RandomState(seed)
    x = rs.randn(b, n, e).astype(np.float32)
    labels = (rs.randint(1, n + 1, size=(b, 1)) / n).astype(np.float32)
    return x, labels


@pytest.mark.parametrize("n,e,h,layers,masked,batch", [(20, 16, 2, 2, True, 6),
                                                       (13, 20, 2, 1, False, 9)])
def test_gapt_fused_bf16_reference_matches_pallas(n, e, h, layers, masked, batch):
    """K9's plain version on bf16 inputs against the Pallas kernel's wrapper on
    bf16 arrays: both widen them and run the float32 body."""
    jcfg, params, g = _generator(n, e, h, layers, masked)
    x, labels = _noise(n, e, batch, seed=n)
    jmask = None
    if masked:
        jmask = jgapt.mask_from_counts(jnp.asarray(x)[:, :, 0],
                                       jgapt.counts_from_labels(jnp.asarray(labels), n))
    bf = lambda t: t.astype(jnp.bfloat16)  # noqa: E731
    yj = jgp.gapt_g_fused(jcfg, jax.tree.map(bf, params), bf(jnp.asarray(x)),
                          None if jmask is None else bf(jmask))
    w = gk.GaptWeights(*(t.detach().bfloat16() for t in g.fused_weights()))
    tmask = None if jmask is None else torch.from_numpy(np.array(jmask)).bfloat16()
    with torch.no_grad():
        yt = gk.gapt_g_fused(torch.from_numpy(x).bfloat16(), tmask, w, h, 0.2)
    assert yt.dtype == torch.bfloat16 and yj.dtype == jnp.bfloat16
    np.testing.assert_allclose(yt.float().numpy(), np.asarray(yj.astype(jnp.float32)),
                               **BF16_TOL)
    with pytest.raises(TypeError, match="all-float32 or all-bfloat16"):
        gk.gapt_g_fused(torch.from_numpy(x), tmask, w, h, 0.2)


def test_fused_weights_follow_the_bf16_copies():
    """Under ``bf16_apply`` K9 reads the weights of the call's own bf16 copies:
    a master parameter changed between two calls changes the output as it
    changes the plain path's; the float32 parameters' packed copy is reused
    while they are unchanged."""
    _, _, g = _generator(10, 16, 2, 2, True)
    x, labels = _noise(10, 16, 3, seed=7)
    x, labels = torch.from_numpy(x), torch.from_numpy(labels)
    assert g.fused_weights() is g.fused_weights()

    def both():
        with torch.no_grad():
            fused = tts.bf16_apply(g, x, labels, train=False)
            g.cfg = tgapt.dataclasses.replace(g.cfg, use_kernels=False)
            plain = tts.bf16_apply(g, x, labels, train=False)
            g.cfg = tgapt.dataclasses.replace(g.cfg, use_kernels=True)
        np.testing.assert_allclose(fused.numpy(), plain.numpy(), rtol=3e-2, atol=3e-2)
        return fused

    y1 = both()
    with torch.no_grad():
        g.final_fc.net[0].bias.add_(0.5)
    y2 = both()
    assert (y2 - y1)[..., :-1].abs().max() > 0.05


@pytest.mark.parametrize("model_g,batched_d", [("gapt", True), ("rgan", False)],
                         ids=["gapt-gapt-batched-d", "rgan-gapt"])
def test_bf16_gapt_steps_match_jax(model_g, batched_d):
    """One bf16 D and G step of the GAPT pair (its D step one pass over [real |
    fake], ``batched_d``) and of rGAN G with a GAPT D, from the same weights
    and draws as the JAX package's."""
    card = dict(GAPT_CARD, model=model_g, model_D="gapt")
    if model_g == "rgan":
        card.update(rgang_fc=[16], latent_dim=8)
    pair = _Pair(card)
    check_bf16_steps(jit_steps(pair, bf16=True, batched_d=batched_d))
    for m in (pair.tstate.g, pair.tstate.d):
        assert all(p.dtype == torch.float32 for p in m.parameters())


def test_train_cli_bf16_gapt_trains_and_resumes(tmp_path):
    argv = ["--device", "cpu", "--name", "bg", "--dir-path", str(tmp_path), "--model", "gapt",
            "--jets", "g", "--num-hits", "8", "--gapt-embed-dim", "16", "--num-heads", "2",
            "--sab-layers-gen", "2", "--sab-layers-disc", "1", "--batch-size", "16",
            "--num-samples", "100", "--eval-tot-samples", "64", "--w1-num-samples", "50",
            "--save-epochs", "2", "--save-model-epochs", "1", "--compute-dtype", "bfloat16"]
    t = ttrain_cli.main(argv + ["--num-epochs", "2"])
    assert t.step_cfg.bf16 and np.isfinite(t.losses["G"]).all()
    t3 = ttrain_cli.main(argv + ["--num-epochs", "3"])
    assert t3.start_epoch == 2 and len(t3.losses["G"]) == 3
    assert t3.losses["G"][:2] == t.losses["G"]
    assert all(p.dtype == torch.float32 for p in t3.state.g.parameters())
