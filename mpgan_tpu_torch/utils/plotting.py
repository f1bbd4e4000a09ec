"""Training figures (``mpgan_tpu/utils/plotting.py``, the native version of the
reference's plotting.py): particle-feature and jet-mass histograms, EFP
histograms, loss curves, the evaluation metrics against the epoch, FID curves
and MNIST cloud rasters, under the JAX package's file names.

Every function writes a PDF with matplotlib's Agg backend and returns its
path. matplotlib is imported inside the functions, not with this module, so
the port imports and trains where it is not installed; a plotting function
then raises ``ImportError``, which the training loops log once. Binning follows
the reference's per-jet-type tables (plotting.py:16-190): particle-feature
bins switch on jet type *and* ``num_particles`` (the 100p runs use the wider
eta/phi and tighter pT bins), and the jet-mass bins are ``(0, 0.225)`` for
g/q/t against ``(0, 0.12)`` for w/z.
"""

from __future__ import annotations

import pathlib

import numpy as np

from ..evaluation.jet_features import jet_features


def _pyplot():
    """matplotlib's pyplot on the Agg backend; ``ImportError`` without matplotlib."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


_FEATURE_LABELS = [
    r"particle $\eta^{rel}$",
    r"particle $\phi^{rel}$",
    r"particle $p_T^{rel}$",
]


def _pbins(jet_type: str, num_particles: int) -> list[np.ndarray]:
    """Particle-feature bins (plotting.py:34-58 / 115-137)."""
    if jet_type in ("g", "q", "w", "z") and num_particles == 100:
        return [
            np.arange(-0.5, 0.5, 0.005),
            np.arange(-0.5, 0.5, 0.005),
            np.arange(0, 0.1, 0.001),
        ]
    if jet_type == "t":
        return [
            np.linspace(-0.5, 0.5, 100),
            np.linspace(-0.5, 0.5, 100),
            np.linspace(0, 0.2, 100),
        ]
    return [
        np.linspace(-0.3, 0.3, 100),
        np.linspace(-0.3, 0.3, 100),
        np.linspace(0, 0.2, 100),
    ]


def _mbins(jet_type: str) -> np.ndarray:
    """Jet relative-mass bins (plotting.py:143-146)."""
    if jet_type in ("g", "q", "t"):
        return np.linspace(0, 0.225, 51)
    return np.linspace(0, 0.12, 51)


def _flat(jets: np.ndarray, mask: np.ndarray | None, f: int) -> np.ndarray:
    vals = jets[..., f].reshape(-1)
    if mask is not None:
        vals = vals[mask.reshape(-1) > 0.5]
    return vals


def _w1_title(ax, losses: dict | None, key: str, index: int) -> None:
    """Annotate a panel with the latest W1 score +- std (plotting.py:83-88)."""
    if not losses or not losses.get(key):
        return
    last = np.asarray(losses[key][-1], dtype=float).reshape(-1)
    half = len(last) // 2
    if index < half:
        ax.set_title(rf"$W_1$ = {last[index]:.2e} $\pm$ {last[index + half]:.2e}", fontsize=12)


def plot_part_feats(
    jet_type: str,
    real_jets: np.ndarray,
    gen_jets: np.ndarray,
    real_mask: np.ndarray | None,
    gen_mask: np.ndarray | None,
    name: str,
    figs_path: str,
    num_particles: int = 30,
    losses: dict | None = None,
) -> str:
    """Three particle-feature histograms, real vs generated, W1 scores in the
    panel titles (plotting.py:16-94)."""
    plt = _pyplot()
    pbins = _pbins(jet_type, num_particles)
    fig, axes = plt.subplots(1, 3, figsize=(22, 8))
    for f in range(3):
        ax = axes[f]
        ax.hist(_flat(real_jets, real_mask, f), pbins[f], histtype="step", label="Real", color="red")
        ax.hist(
            _flat(gen_jets, gen_mask, f), pbins[f], histtype="step", label="Generated", color="blue"
        )
        ax.set_xlabel(_FEATURE_LABELS[f])
        ax.set_ylabel("Number of Particles")
        ax.ticklabel_format(axis="y", scilimits=(0, 0), useMathText=True)
        _w1_title(ax, losses, "w1p", f)
        ax.legend(loc=1)
    out = str(pathlib.Path(figs_path) / f"{name}.pdf")
    fig.tight_layout(pad=2.0)
    fig.savefig(out, bbox_inches="tight")
    plt.close(fig)
    return out


def plot_part_feats_jet_mass(
    jet_type: str,
    real_jets: np.ndarray,
    gen_jets: np.ndarray,
    real_mask: np.ndarray | None,
    gen_mask: np.ndarray | None,
    name: str,
    figs_path: str,
    num_particles: int = 30,
    losses: dict | None = None,
) -> str:
    """Histograms of the three particle features + jet mass, real vs generated
    (plotting.py:97-190); W1 scores annotate each panel when available."""
    plt = _pyplot()
    pbins = _pbins(jet_type, num_particles)
    mbins = _mbins(jet_type)
    real_masses = jet_features(real_jets)["mass"]
    gen_masses = jet_features(gen_jets)["mass"]

    fig, axes = plt.subplots(1, 4, figsize=(30, 8))
    for f in range(3):
        ax = axes[f]
        ax.hist(_flat(real_jets, real_mask, f), pbins[f], histtype="step", label="Real", color="red")
        ax.hist(
            _flat(gen_jets, gen_mask, f), pbins[f], histtype="step", label="Generated", color="blue"
        )
        ax.set_xlabel(_FEATURE_LABELS[f])
        ax.set_ylabel("Number of Particles")
        ax.ticklabel_format(axis="y", scilimits=(0, 0), useMathText=True)
        _w1_title(ax, losses, "w1p", f)
        ax.legend(loc=1)
    ax = axes[3]
    ax.hist(real_masses, mbins, histtype="step", label="Real", color="red")
    ax.hist(gen_masses, mbins, histtype="step", label="Generated", color="blue")
    ax.set_xlabel(r"Jet $m/p_T$")
    ax.set_ylabel("Jets")
    ax.ticklabel_format(axis="y", scilimits=(0, 0), useMathText=True)
    _w1_title(ax, losses, "w1m", 0)
    ax.legend(loc=1)
    out = str(pathlib.Path(figs_path) / f"{name}.pdf")
    fig.tight_layout(pad=2.0)
    fig.savefig(out, bbox_inches="tight")
    plt.close(fig)
    return out


# Which EFP columns get plotted (plotting.py:200-212), clamped to however
# many columns the caller computed (20 primes, or 35 with composites). The
# reference's fixed bin-range tables were tuned for energyflow's column
# ordering; this repo's efps() orders columns by (degree, canonical edge
# list) — different physical EFPs land at these indices — so bin ranges are
# derived from the real-side quantiles instead (ADVICE r2), with the
# reference tables kept only as a fallback for degenerate real data.
_EFP_BINRANGES = {
    "g": [0.2, 0.06, 0.04, 0.003, 0.003, 0.0015],
    "q": [0.2, 0.06, 0.04, 0.003, 0.003, 0.0015],
    "default": [0.22, 0.075, 0.05, 0.008, 0.01, 0.004],
}
_EFP_INDICES = [1, 2, 5, 8, 13, 18]


def _efp_binrange(real_col: np.ndarray, fallback: float) -> float:
    """Upper histogram edge for one EFP column: the real distribution's
    99.5th percentile (with 10% headroom), so bins track whatever physical
    EFP lives in this column."""
    vals = real_col[np.isfinite(real_col)]
    if len(vals) == 0:
        return fallback
    hi = float(np.quantile(vals, 0.995)) * 1.1
    return hi if hi > 0 else fallback


def plot_efps(jet_type, real_efps, gen_efps, name, figs_path) -> str:
    """2x3 grid of EFP histograms with per-jet-type fixed ranges
    (plotting.py:192-234)."""
    plt = _pyplot()
    binranges = _EFP_BINRANGES.get(jet_type, _EFP_BINRANGES["default"])
    ncols = real_efps.shape[1]
    indices = [i if i < ncols else i % ncols for i in _EFP_INDICES]
    fig, axes = plt.subplots(2, 3, figsize=(20, 12))
    for i, ax in enumerate(np.ravel(axes)):
        bins = np.linspace(0, _efp_binrange(real_efps[:, indices[i]], binranges[i]), 101)
        ax.hist(real_efps[:, indices[i]], bins, histtype="step", label="Real", color="red")
        ax.hist(gen_efps[:, indices[i]], bins, histtype="step", label="Generated", color="blue")
        ax.ticklabel_format(axis="y", scilimits=(0, 0), useMathText=True)
        ax.ticklabel_format(axis="x", scilimits=(0, 0), useMathText=True)
        ax.set_xlabel(f"EFP {i + 1}")
        ax.set_ylabel("Jets")
        ax.legend(loc=1)
    out = str(pathlib.Path(figs_path) / f"{name}.pdf")
    fig.tight_layout(pad=0.5)
    fig.savefig(out, bbox_inches="tight")
    plt.close(fig)
    return out


_JF_BINRANGES = {
    "g": [0.0013, 0.0004, 0.0004, 0.0004, 0.0004],
    "q": [0.002, 0.001, 0.001, 0.0005, 0.0005],
    "default": [0.0045, 0.0035, 0.004, 0.002, 0.003],
}


def plot_jet_feats(
    jet_type: str,
    real_masses: np.ndarray,
    gen_masses: np.ndarray,
    real_efps: np.ndarray,
    gen_efps: np.ndarray,
    name: str,
    figs_path: str,
    losses: dict | None = None,
) -> str:
    """Five EFP histograms + jet mass in a 2x3 grid (plotting.py:237-297)."""
    plt = _pyplot()
    binranges = _JF_BINRANGES.get(jet_type, _JF_BINRANGES["default"])
    mbins = _mbins(jet_type)
    fig, axes = plt.subplots(2, 3, figsize=(20, 12))
    flat = np.ravel(axes)
    ax = flat[0]
    ax.hist(real_masses, mbins, histtype="step", label="Real", color="red")
    ax.hist(gen_masses, mbins, histtype="step", label="Generated", color="blue")
    ax.set_xlabel(r"Jet $m/p_T$")
    ax.set_ylabel("Jets")
    ax.ticklabel_format(axis="y", scilimits=(0, 0), useMathText=True)
    _w1_title(ax, losses, "w1m", 0)
    ax.legend(loc=1)
    ncols = real_efps.shape[1]
    for i in range(5):
        ax = flat[i + 1]
        idx = i % ncols
        bins = np.linspace(0, _efp_binrange(real_efps[:, idx], binranges[i]), 101)
        ax.hist(real_efps[:, idx], bins, histtype="step", label="Real", color="red")
        ax.hist(gen_efps[:, idx], bins, histtype="step", label="Generated", color="blue")
        ax.ticklabel_format(axis="y", scilimits=(0, 0), useMathText=True)
        ax.ticklabel_format(axis="x", scilimits=(0, 0), useMathText=True)
        ax.set_xlabel(f"EFP {i + 1}")
        ax.set_ylabel("Jets")
        ax.legend(loc=1)
    out = str(pathlib.Path(figs_path) / f"{name}.pdf")
    fig.tight_layout(pad=0.5)
    fig.savefig(out, bbox_inches="tight")
    plt.close(fig)
    return out


def plot_losses(losses: dict, loss: str, name: str, losses_path: str) -> str:
    """G/D loss curves per epoch; curve selection matches the reference's
    per-loss-type choices (plotting.py:340-368): WGAN plots the critic loss
    only, ls/og/hinge plot Dr/Df/G."""
    plt = _pyplot()
    fig = plt.figure()
    if loss == "w":
        keys = [("D", "Critic loss")]
    else:
        keys = [("Dr", "Discriminative real loss"), ("Df", "Discriminative fake loss"),
                ("G", "Generative loss")]
    for key, label in keys:
        if losses.get(key):
            plt.plot(losses[key], label=label)
    if losses.get("gp"):
        plt.plot(losses["gp"], label="Gradient penalty")
    plt.xlabel("Epoch")
    plt.ylabel("Loss")
    plt.legend(loc=1, prop={"size": 7})
    out = str(pathlib.Path(losses_path) / f"{name}.pdf")
    plt.savefig(out, bbox_inches="tight")
    plt.close(fig)
    return out


def plot_eval(losses: dict, epoch: int, save_epochs: int, name: str, losses_path: str) -> str:
    """Evaluation metrics vs epoch in the reference's 3x3 grid
    (plotting.py:371-457): W1-P per particle feature (3 panels), W1-M, the
    FGD-infinity mean and mean+sigma panels from the FPD history, MMD,
    coverage, and FPND. The reference's grid has no W1-EFP panel (commented
    out at plotting.py:393-400); when a w1efp history exists it is written
    as a companion ``<name>_w1efp.pdf`` so the trend is not lost."""
    plt = _pyplot()
    fig = plt.figure(figsize=(30, 24))

    def _x(vals):
        # clamp BOTH sides to the common length: a resumed run whose loaded
        # history disagrees with the derived axis (e.g. save_zero toggled
        # between runs) must plot the overlapping tail, not raise and lose
        # the figure (ADVICE r2; the pre-r2 code clamped both sides too)
        x = np.arange(0, epoch + 1, save_epochs)
        vals = np.asarray(vals)
        m = min(len(x), len(vals))
        return x[-m:], vals[-m:]

    if losses.get("w1p"):
        w1p = np.asarray(losses["w1p"], dtype=float)
        for i in range(3):
            ax = fig.add_subplot(3, 3, i + 1)
            ax.plot(*_x(w1p[:, i]))
            ax.set_xlabel("Epoch")
            ax.set_ylabel(f"Particle {_FEATURE_LABELS[i]} $W_1$")
            ax.set_yscale("log")
    if losses.get("w1m"):
        w1m = np.asarray(losses["w1m"], dtype=float)
        ax = fig.add_subplot(3, 3, 4)
        ax.plot(*_x(w1m[:, 0]))
        ax.set_xlabel("Epoch")
        ax.set_ylabel("Jet Relative Mass $W_1$")
        ax.set_yscale("log")
    if losses.get("fpd"):
        # FGD-infinity panels (plotting.py:404-422): mean, and mean + sigma
        # (the best-epoch selection score, train.py:796)
        arr = np.asarray(losses["fpd"], dtype=float)
        means, stds = arr[:, 0], arr[:, 1]
        ax = fig.add_subplot(3, 3, 5)
        ax.plot(*_x(means))
        ax.set_xlabel("Epoch")
        ax.set_ylabel(r"$\overline{\mathrm{FGD}}_{\infty}$")
        ax.set_yscale("log")
        ax.set_ylim(top=10)
        ax = fig.add_subplot(3, 3, 6)
        ax.plot(*_x(means + stds))
        ax.set_xlabel("Epoch")
        ax.set_ylabel(r"$\overline{\mathrm{FGD}}_{\infty}^{+\sigma}$")
        ax.set_yscale("log")
        ax.set_ylim(top=10)
    if losses.get("cov_mmd"):
        arr = np.asarray(losses["cov_mmd"], dtype=float)
        for i, (col, label, logscale) in enumerate(
            [(1, "MMD", True), (0, "Coverage", False)]
        ):
            ax = fig.add_subplot(3, 3, 7 + i)
            ax.plot(*_x(arr[:, col]))
            ax.set_xlabel("Epoch")
            ax.set_ylabel(label)
            if logscale:
                ax.set_yscale("log")
    if losses.get("fpnd"):
        vals = np.asarray(losses["fpnd"], dtype=float)
        ax = fig.add_subplot(3, 3, 9)
        ax.plot(*_x(vals))
        ax.set_xlabel("Epoch")
        ax.set_ylabel("FPND")
        ax.set_yscale("log")
        ax.set_ylim(top=10)
    out = str(pathlib.Path(losses_path) / f"{name}.pdf")
    fig.savefig(out, bbox_inches="tight")
    plt.close(fig)
    if losses.get("w1efp"):
        arr = np.asarray(losses["w1efp"], dtype=float)
        half = arr.shape[1] // 2
        fig2 = plt.figure(figsize=(8, 5))
        for i in range(min(half, 5)):
            plt.plot(*_x(arr[:, i]), label=f"EFP {i + 1}")
        plt.legend(loc=1, prop={"size": 8})
        plt.xlabel("Epoch")
        plt.ylabel("Jet EFPs $W_1$")
        plt.yscale("log")
        fig2.savefig(
            str(pathlib.Path(losses_path) / f"{name}_w1efp.pdf"), bbox_inches="tight"
        )
        plt.close(fig2)
    return out


def plot_fid(fid: list, name: str, losses_path: str) -> str:
    """MNIST FID curve (plotting.py:460-475)."""
    plt = _pyplot()
    fig = plt.figure()
    plt.plot(fid)
    plt.xlabel("Epoch")
    plt.ylabel("FID")
    plt.yscale("log")
    out = str(pathlib.Path(losses_path) / f"{name}_fid.pdf")
    plt.savefig(out, bbox_inches="tight")
    plt.close(fig)
    return out


def mnist_cloud_image(clouds: np.ndarray, name: str, figs_path: str, num: int = 100) -> str:
    """Rasterize generated MNIST clouds into a 10x10 image grid
    (train_mnist.py:571-609)."""
    plt = _pyplot()
    num = min(num, len(clouds))
    side = int(np.ceil(np.sqrt(num)))
    fig, axes = plt.subplots(side, side, figsize=(side, side))
    for i, ax in enumerate(np.ravel(axes)):
        ax.axis("off")
        if i >= num:
            continue
        img = np.zeros((28, 28))
        xy = np.clip(((clouds[i, :, :2] + 0.5) * 28).astype(int), 0, 27)
        np.add.at(img, (xy[:, 1], xy[:, 0]), clouds[i, :, 2] + 0.5)
        ax.imshow(img, cmap="gray")
    out = str(pathlib.Path(figs_path) / f"{name}.pdf")
    fig.savefig(out)
    plt.close(fig)
    return out
