"""``--mask-manual`` in the PyTorch port against the JAX package.

- ``ops.masking.mask_manual`` (binary pT cutoff, the exponential tail of
  ``mask_exp``, all ones for ``mask_real_only``) on seeded inputs whose pT
  straddles the cutoff, within 1e-6;
- the registry builds the ``post_gen`` hook only with the flag, with the JAX
  registry's cutoff 0.0, and the two hooks agree.

One D step and one G step with the hook are in ``test_torch_train_step.py``,
a tiny training run in ``test_torch_train_loop.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one thread a test worker: the suite runs in parallel workers

import jax.numpy as jnp

from mpgan_tpu.models import registry as jregistry
from mpgan_tpu.ops import masking as jmasking
from mpgan_tpu.training import config as jconfig
from mpgan_tpu_torch.models import registry as tregistry
from mpgan_tpu_torch.ops import masking as tmasking
from mpgan_tpu_torch.training import config as tconfig

TOL = dict(rtol=1e-6, atol=1e-6)
CARD = {"model": "mpgan", "num_hits": 10, "hidden_node_size": 8, "fe": [12, 16], "fn": [16]}


def _gen_data(seed, b=6, n=10):
    """G-like output [B, N, 3]; pT (feature 2) straddles 0 and the cutoffs below."""
    rng = np.random.RandomState(seed)
    x = (rng.randn(b, n, 3) * 0.3).astype(np.float32)
    x[0, :4, 2] = [0.0, -0.0, 0.1, -0.1]  # on and around the cutoffs
    return x


# the exponential tail divides by |cutoff|: at 0.0 see the NaN case below
@pytest.mark.parametrize("mode,cutoff", [
    ("binary", 0.0), ("binary", 0.1), ("binary", -0.05), ("mask_exp", 0.1), ("mask_exp", -0.05),
    ("mask_real_only", 0.0), ("mask_real_only", 0.1),
])
def test_mask_manual_matches_jax(mode, cutoff):
    x = _gen_data(1)
    kw = {"mask_exp": mode == "mask_exp", "mask_real_only": mode == "mask_real_only"}
    j = np.asarray(jmasking.mask_manual(jnp.asarray(x), cutoff, **kw))
    t = tmasking.mask_manual(torch.from_numpy(x), cutoff, **kw).numpy()
    assert t.shape == (6, 10, 4) and t.dtype == np.float32
    np.testing.assert_array_equal(t[..., :3], x)
    np.testing.assert_allclose(t, j, **TOL)
    if mode == "binary":
        np.testing.assert_array_equal(t[..., 3], (x[..., 2] > cutoff) - 0.5)


def test_mask_exp_at_cutoff_zero_is_what_jax_gives():
    """The registry's placeholder cutoff 0.0 with ``--mask-exp``: the tail's
    ``(pT - 0) / |0|`` gives the same infinities and NaNs in both packages."""
    x = _gen_data(2)
    j = np.asarray(jmasking.mask_manual(jnp.asarray(x), 0.0, mask_exp=True))
    t = tmasking.mask_manual(torch.from_numpy(x), 0.0, mask_exp=True).numpy()
    np.testing.assert_array_equal(np.isnan(t), np.isnan(j))
    np.testing.assert_allclose(t[~np.isnan(t)], j[~np.isnan(j)], **TOL)


@pytest.mark.parametrize("flags", [{}, {"mask_exp": True}, {"mask_real_only": True}])
def test_registry_builds_post_gen_only_with_the_flag(flags):
    plain = tregistry.build_suite(tconfig.from_args_dict(dict(CARD, **flags)))
    assert plain.post_gen is None
    card = dict(CARD, mask_manual=True, mask_c=False, **flags)
    tsuite = tregistry.build_suite(tconfig.from_args_dict(card))
    jsuite = jregistry.build_suite(jconfig.from_args_dict(card))
    x = _gen_data(3)
    t = tsuite.post_gen(torch.from_numpy(x)).numpy()
    j = np.asarray(jsuite.post_gen(jnp.asarray(x)))
    assert t.shape == (6, 10, 4)
    np.testing.assert_array_equal(np.isnan(t), np.isnan(j))
    np.testing.assert_allclose(t[~np.isnan(t)], j[~np.isnan(j)], **TOL)
