"""The PyTorch port's debugging flags of the training loop, against the JAX loop's.

- ``--profile`` writes the first epoch's trace and ``key_averages()`` table
  under ``<out_dir>/profile/``, where the JAX loop writes its trace;
- ``--debug`` logs D(real), G's samples and D(fake) after every epoch; the
  logged D(real) is what D computes on the same batch;
- ``--debug-nans`` raises ``FloatingPointError`` on a generator whose weights
  hold a NaN, in both packages (JAX under ``jax_debug_nans``, reset here), and
  only under the flag; the port raises it too on a NaN that only the backward
  makes; a clean run under it finishes.
"""

import json
import logging

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one thread a test worker: the suite runs in parallel workers

import jax

from mpgan_tpu.data.jetnet import JetNetDataset as JJetNetDataset
from mpgan_tpu.training import config as jconfig
from mpgan_tpu.training.loop import Trainer as JTrainer
from mpgan_tpu_torch.data.jetnet import JetNetDataset as TJetNetDataset
from mpgan_tpu_torch.training import config as tconfig
from mpgan_tpu_torch.training import train_step as tts
from mpgan_tpu_torch.training.loop import Trainer as TTrainer

CARD = {"name": "dbg", "model": "mpgan", "jets": "g", "num_hits": 10, "hidden_node_size": 8,
        "fe": [12], "fn": [16], "batch_size": 32, "num_epochs": 1, "save_epochs": 1,
        "eval_tot_samples": 64, "w1_num_samples": [50], "spectral_norm_disc": True}
DS = dict(jet_type="g", data_dir=None, num_particles=10, synthetic_num_jets=300,
          mask_feature=True)


def _port(tmp_path, **flags):
    args = tconfig.from_args_dict(dict(CARD, dir_path=str(tmp_path), **flags))
    return TTrainer(args, TJetNetDataset(**DS, split="train"), TJetNetDataset(**DS, split="valid"),
                    device="cpu")


def test_profile_writes_the_first_epochs_trace(tmp_path):
    t = _port(tmp_path, profile=True, num_epochs=2, save_epochs=2)
    t.train()
    out = tmp_path / "dbg" / "profile"
    assert sorted(p.name for p in out.iterdir()) == ["epoch_1_key_averages.txt",
                                                     "epoch_1_trace.json"]
    events = json.loads((out / "epoch_1_trace.json").read_text())["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any(n.startswith("aten::") for n in names)
    assert "Self CPU" in (out / "epoch_1_key_averages.txt").read_text()
    assert len(t.losses["G"]) == 2


def test_debug_logs_d_outputs_on_the_last_batch(tmp_path, caplog, monkeypatch):
    t = _port(tmp_path, debug=True, num_epochs=2, save_epochs=2)
    seen = []
    log_d = t._log_d_outputs

    def recording(data, labels):
        out = log_d(data, labels)
        seen.append((data, labels, out))
        return out

    monkeypatch.setattr(t, "_log_d_outputs", recording)
    with caplog.at_level(logging.INFO, logger="mpgan_tpu_torch.training.loop"):
        t.train()
    text = caplog.text
    for block in ("D real output", "G output", "D fake output"):
        assert text.count(block) == 2
    data, labels, (real_out, fake, fake_out) = seen[-1]
    assert data.shape == (32, 10, 4) and fake.shape == (32, 10, 4)
    with torch.no_grad():
        np.testing.assert_array_equal(real_out.numpy(),
                                      t.state.d(data, labels, update_sn=False).numpy())
    assert str(real_out[:10].numpy()) in text


def test_debug_nans_raises_on_a_nan_weight_in_both_packages(tmp_path):
    jargs = jconfig.from_args_dict(dict(CARD, dir_path=str(tmp_path / "j"), debug_nans=True,
                                        break_zero=True))
    jt = JTrainer(jargs, train_dataset=JJetNetDataset(**DS, split="train"),
                  valid_dataset=JJetNetDataset(**DS, split="valid"))
    try:
        leaves, tree = jax.tree.flatten(jt.state.g_params)
        leaves[0] = np.full(leaves[0].shape, np.nan, np.float32)  # no JAX op: none may make a NaN
        jt.state = jt.state._replace(g_params=jax.tree.unflatten(tree, leaves))
        with pytest.raises(FloatingPointError):
            jt.train()
    finally:
        jax.config.update("jax_debug_nans", False)

    t = _port(tmp_path / "t", debug_nans=True)
    with torch.no_grad():
        next(t.state.g.parameters()).fill_(float("nan"))
    with pytest.raises(FloatingPointError, match="NaN in the output of G"):
        t.train()


def test_debug_nans_raises_on_a_nan_made_in_the_backward(tmp_path, monkeypatch):
    """sqrt(0) is finite, its derivative is not: the G loss gains a term that is
    0 forward and whose backward makes 0 * inf, a NaN no forward hook sees.
    Anomaly mode's error comes out as ``FloatingPointError``."""
    g_loss = tts.g_loss
    monkeypatch.setattr(tts, "g_loss", lambda loss, out: g_loss(loss, out)
                        + torch.sqrt(out.mean() * 0) * 0)
    t = _port(tmp_path, debug_nans=True)
    with pytest.raises(FloatingPointError, match="'SqrtBackward0' returned nan values"):
        t.train()


def test_nan_weight_without_the_flag_trains_on(tmp_path, caplog):
    t = _port(tmp_path)
    with torch.no_grad():
        next(t.state.g.parameters()).fill_(float("nan"))
    with caplog.at_level(logging.WARNING, logger="mpgan_tpu_torch.training.loop"):
        t.train()
    assert "non-finite epoch losses" in caplog.text


def test_clean_run_under_debug_nans_finishes(tmp_path):
    t = _port(tmp_path, debug_nans=True, num_epochs=2, save_epochs=2, gp=10.0, loss="w")
    t.train()
    assert np.isfinite(t.losses["G"]).all() and np.isfinite(t.losses["gp"]).all()
    assert (tmp_path / "dbg" / "models" / "state_2.npz").exists()
