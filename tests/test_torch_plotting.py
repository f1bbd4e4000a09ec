"""The PyTorch port's figures (``utils/plotting.py``) against the JAX package.

- the binning tables (``_pbins``, ``_mbins``, ``_efp_binrange``) equal JAX's
  for every jet type at 30, 100 and 150 particles;
- ``Trainer.eval_save_plot`` on the CPU writes the JAX loop's file names
  under ``figs/`` and ``losses/`` (with ``--efp --fpd``: the particle, EFP,
  loss and evaluation figures);
- without matplotlib (``sys.modules`` patched) the port imports, the loop logs
  one line, writes no figure and trains on.
"""

import logging
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one thread a test worker: the suite runs in parallel workers

from mpgan_tpu.data.jetnet import JetNetDataset as JJetNetDataset
from mpgan_tpu.training import config as jconfig
from mpgan_tpu.training.loop import Trainer as JTrainer
from mpgan_tpu.utils import plotting as jplot
from mpgan_tpu_torch.data.jetnet import JetNetDataset as TJetNetDataset
from mpgan_tpu_torch.training import config as tconfig
from mpgan_tpu_torch.training.loop import Trainer as TTrainer
from mpgan_tpu_torch.utils import plotting as tplot

JETS = ("g", "q", "t", "w", "z")


@pytest.mark.parametrize("num_particles", [30, 100, 150])
@pytest.mark.parametrize("jet_type", JETS)
def test_binning_tables_equal_jax(jet_type, num_particles):
    for ours, theirs in zip(tplot._pbins(jet_type, num_particles),
                            jplot._pbins(jet_type, num_particles)):
        np.testing.assert_array_equal(ours, theirs)
    np.testing.assert_array_equal(tplot._mbins(jet_type), jplot._mbins(jet_type))


@pytest.mark.parametrize("col", [np.array([np.nan, np.inf]), np.zeros(5),
                                 np.random.default_rng(0).lognormal(size=500)],
                         ids=["non_finite", "zeros", "lognormal"])
def test_efp_binrange_equals_jax(col):
    assert tplot._efp_binrange(col, 0.2) == jplot._efp_binrange(col, 0.2)
    assert tplot._EFP_INDICES == jplot._EFP_INDICES
    assert tplot._EFP_BINRANGES == jplot._EFP_BINRANGES


CARD = {"name": "p", "model": "mpgan", "jets": "g", "num_hits": 10, "hidden_node_size": 8,
        "fe": [12], "fn": [16], "batch_size": 32, "num_epochs": 1, "save_epochs": 1,
        "eval_tot_samples": 64, "w1_num_samples": [50], "efp": True, "fpd": True,
        "disc_dropout": 0.0}
DS = dict(jet_type="g", data_dir=None, num_particles=10, synthetic_num_jets=300,
          mask_feature=True)


def _files(root):
    return {d: sorted(p.name for p in (root / d).iterdir() if p.suffix == ".pdf")
            for d in ("figs", "losses")}


def _with_history(trainer):
    """Two epochs' train losses, so that the loss and evaluation figures are drawn."""
    for k in ("Dr", "Df", "D", "G"):
        trainer.losses[k] = [0.5, 0.4]
    return trainer


def test_eval_save_plot_writes_the_jax_loops_file_names(tmp_path):
    jt = _with_history(JTrainer(jconfig.from_args_dict(dict(CARD, dir_path=str(tmp_path / "j"))),
                                train_dataset=JJetNetDataset(**DS, split="train"),
                                valid_dataset=JJetNetDataset(**DS, split="valid")))
    tt = _with_history(TTrainer(tconfig.from_args_dict(dict(CARD, dir_path=str(tmp_path / "t"))),
                                TJetNetDataset(**DS, split="train"),
                                TJetNetDataset(**DS, split="valid"), device="cpu"))
    for epoch in (1, 2):
        jt.eval_save_plot(epoch)
        tt.eval_save_plot(epoch)
    theirs, ours = _files(tmp_path / "j" / "p"), _files(tmp_path / "t" / "p")
    assert ours == theirs
    assert ours["figs"] == ["1efp.pdf", "1pm.pdf", "2efp.pdf", "2pm.pdf"]
    assert {"2.pdf", "2_eval.pdf"} <= set(ours["losses"])
    assert len(jt.losses["w1m"]) == len(tt.losses["w1m"]) == 2


def test_without_matplotlib_the_loop_logs_once_and_trains_on(tmp_path, monkeypatch, caplog):
    for name in [m for m in sys.modules if m == "matplotlib" or m.startswith("matplotlib.")]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError):
        tplot.plot_losses({"G": [1.0, 0.5]}, "ls", "x", str(tmp_path))
    args = tconfig.from_args_dict(dict(CARD, dir_path=str(tmp_path), num_epochs=2,
                                       efp=False, fpd=False))
    t = TTrainer(args, TJetNetDataset(**DS, split="train"), TJetNetDataset(**DS, split="valid"),
                 device="cpu")
    with caplog.at_level(logging.INFO, logger="mpgan_tpu_torch.training.loop"):
        t.train()
    lines = [r for r in caplog.records if "no figures are written" in r.getMessage()]
    assert len(lines) == 1 and len(t.losses["w1m"]) == 2 and len(t.losses["G"]) == 2
    assert not list((tmp_path / "p").rglob("*.pdf"))
    assert (tmp_path / "p" / "models" / "state_2.npz").exists()
