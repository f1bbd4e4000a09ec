"""The MP layer's configuration lattice, the port against the JAX package.

The points are the JAX package's own (``tests/test_kernel_fuzz.py``: its
sampler, its seeds ``4242 + case``, its inputs from ``RandomState(case)`` and
its ``train`` rule). At each point both packages build the layer, the port's
from the JAX weights (and its own init from the same key checked against
them), and the tests in ``test_torch_mp_lattice_*.py`` hold:

- an invalid point: the same ``ValueError`` on both sides, both paths;
- a valid point with dropout off: the port's plain path and its kernel path
  (the kernels' plain versions on the CPU) each against JAX's jnp path,
  outputs at rtol = atol = 1e-5 and the gradients of every parameter (JAX
  leaf order) and of ``x`` at 1e-4, loss ``sum(sin(y))`` as JAX's test;
- a valid point with dropout on (p = 0.3): the plain path against JAX's jnp
  path, and the kernel path against JAX's Pallas path in interpret mode (the
  same hash, so the same masks) where the point takes the kernel path, else
  against the jnp path too.

Every path runs on its own copy of the layer: spectral norm advances ``u`` in
place on the port's side. No knn point's search parts from JAX's at a near-tie
(the outputs would show it), so every point runs on its own neighbours.
"""

from __future__ import annotations

import copy
import functools
import pathlib
import random
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

from mpgan_tpu.ops import mp as jmp
from mpgan_tpu_torch.ops import mp as tmp
from mpgan_tpu_torch.ops import prng
from mpgan_tpu_torch.ops.keys import Keys
from mpgan_tpu_torch.utils.weights import _mlp_leaves, mlp_sd_from_jax
from test_kernel_fuzz import N_CASES, _sample

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (the card phase's recipe: configurations and inputs)

FWD = dict(rtol=1e-5, atol=1e-5)
BWD = dict(rtol=1e-4, atol=1e-4)


def point(case: int) -> dict:
    return _sample(random.Random(4242 + case))


def set_env(monkeypatch, s: dict) -> None:
    """The point's environment, read at call time by both packages."""
    monkeypatch.setenv("MPGAN_TPU_BLOCK_RECEIVERS", str(s["block"]))
    monkeypatch.setenv("MPGAN_TPU_KNN_KERNEL", s["kernel"])
    monkeypatch.setenv("MPGAN_TPU_KNN_SELECT", s["select"])


def card_point(case: int, s: dict | None = None) -> dict:
    """The point as ``chip_smoke.py`` phase 33 runs it (B = 2, fe ``[h1, h2]``,
    fn ``[h2]``, seed ``case``): its configuration and inputs are built by the
    card's own recipe (``lattice_cfg_args``, ``lattice_inputs``)."""
    s = point(case) if s is None else s
    return {**s, "case": case, "seed": case, "b": 2, "fe": [s["h1"], s["h2"]], "fn": [s["h2"]]}


def inputs(s: dict) -> dict:
    """JAX's inputs at the card point ``s``, as numpy arrays, its train rule
    and key (``chip_smoke.lattice_inputs`` on the CPU)."""
    d = chip_smoke.lattice_inputs(s, "cpu")
    return {k: v.numpy() if isinstance(v, torch.Tensor) else v for k, v in d.items()}


class Point:
    """Both packages' layers at lattice point ``case``, dropout at ``dropout_p``."""

    def __init__(self, case: int, dropout_p: float, s: dict | None = None):
        self.case, self.s = case, card_point(case, s)
        args, kw = chip_smoke.lattice_cfg_args(self.s, dropout_p)
        self.jcfg = jmp.MPLayerConfig.build(*args, **kw)
        self.tcfg = tmp.MPLayerConfig.build(*args, **kw)
        self.params, self.state = jmp.mp_layer_init(jax.random.PRNGKey(case), self.jcfg)
        p_np = jax.tree.map(np.asarray, self.params)
        s_np = jax.tree.map(np.asarray, self.state)
        self.sd = {**mlp_sd_from_jax("fe.", self.tcfg.fe, p_np["fe"], s_np["fe"]),
                   **mlp_sd_from_jax("fn.", self.tcfg.fn, p_np["fn"], s_np["fn"])}
        self.d = inputs(self.s)

    def port_init_matches(self) -> float:
        """The port's layer drawn from ``PRNGKey(case)`` against the JAX
        weights: the largest difference (raises where the keys differ)."""
        own = tmp.MPLayer(self.tcfg, prng.PRNGKey(self.case)).state_dict()
        if set(own) != set(self.sd):
            raise AssertionError(f"state dict keys differ: {sorted(set(own) ^ set(self.sd))}")
        return max(float((own[k].double() - self.sd[k].double()).abs().max())
                   for k in own if own[k].numel() and k.split(".")[-1] != "weight_v")

    def layer(self) -> tmp.MPLayer:
        """A fresh port layer holding the JAX weights and state."""
        layer = tmp.MPLayer(self.tcfg)
        layer.load_state_dict(copy.deepcopy(self.sd), strict=True)
        return layer

    def jax_run(self, use_pallas: bool):
        """JAX's output and gradients (params in leaf order, then ``x``), loss
        ``sum(sin(y))``."""
        d = self.d
        j = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731

        def f(p, xx):
            y, _ = jmp.mp_layer_apply(
                self.jcfg, p, self.state, xx, mask=j(d["mask"]), labels=j(d["labels"]),
                num_jet_particles=j(d["njp"]), train=d["train"],
                rng=jnp.asarray(d["key"]), use_pallas=use_pallas)
            return jnp.sum(jnp.sin(y)), y

        (_, y), (gp, gx) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
            self.params, jnp.asarray(d["x"]))
        return np.asarray(y), [np.asarray(g) for g in jax.tree.leaves(gp)] + [np.asarray(gx)]

    def port_run(self, use_kernels: bool):
        """The port's output and gradients in JAX leaf order, then ``x``."""
        d = self.d
        t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
        layer = self.layer()
        x = torch.from_numpy(d["x"]).requires_grad_()
        y = tmp.mp_layer_apply(
            layer, x, mask=t(d["mask"]), labels=t(d["labels"]), num_jet_particles=t(d["njp"]),
            train=d["train"], rng=Keys(torch.from_numpy(d["key"].copy())),
            use_kernels=use_kernels)
        torch.sin(y).sum().backward()
        leaves = _mlp_leaves(layer.fe, True) + _mlp_leaves(layer.fn, True)
        grads = [p.grad for p in leaves] + [x.grad]
        return y.detach().numpy(), [g.numpy() for g in grads]

    def takes_kernels(self) -> bool:
        return tmp.fused_eligible(self.tcfg, self.d["train"])


def invalid_message(fn) -> str | None:
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


def check_invalid(p: Point) -> bool:
    """An invalid point raises the same ``ValueError`` on both sides and
    paths; False where the point is valid."""
    msgs = {invalid_message(lambda: p.jax_run(False)), invalid_message(lambda: p.jax_run(True)),
            invalid_message(lambda: p.port_run(False)), invalid_message(lambda: p.port_run(True))}
    if msgs == {None}:
        return False
    assert len(msgs) == 1, f"case {p.case}: the sides raise otherwise: {msgs}"
    return True


def assert_close(case, what, got, want):
    y_t, g_t = got
    y_j, g_j = want
    np.testing.assert_allclose(y_t, y_j, **FWD, err_msg=f"case {case} {what}: output")
    assert len(g_t) == len(g_j), f"case {case} {what}: {len(g_t)} gradients, JAX {len(g_j)}"
    for i, (a, b) in enumerate(zip(g_t, g_j)):
        assert a.shape == b.shape, f"case {case} {what}: gradient {i} {a.shape} vs {b.shape}"
        np.testing.assert_allclose(a, b, **BWD, err_msg=f"case {case} {what}: gradient {i}")


def valid(case: int) -> bool:
    """Whether the point's configuration passes the port's up-front checks
    (the tests hold the JAX side to the same answer)."""
    p = point(case)
    cfg = chip_smoke.lattice_cfg(card_point(case), 0.0)
    try:
        tmp._check_edge_features(cfg)
        if not cfg.fully_connected:
            tmp._check_knn_fits(cfg, p["n"])
    except ValueError:
        return False
    return True


def checks(cases) -> list[str]:
    """The checks of the points ``cases``, ``"<case>-<check>"``: an invalid
    point's ``invalid``; a valid point's ``init``, ``off-plain`` and
    ``off-kernel``, and with dropout ``on-plain`` and ``on-kernel``."""
    out = []
    for c in cases:
        if not valid(c):
            out.append(f"{c}-invalid")
            continue
        out += [f"{c}-init", f"{c}-off-plain", f"{c}-off-kernel"]
        if point(c)["dropout_p"] > 0:
            out += [f"{c}-on-plain", f"{c}-on-kernel"]
    return out


def check(name: str, monkeypatch) -> None:
    """One check of :func:`checks`, in the point's environment."""
    case, what = name.split("-", 1)
    case = int(case)
    set_env(monkeypatch, point(case))
    if what == "invalid":
        assert check_invalid(layer_point(case, 0.0))
    elif what == "init":
        assert layer_point(case, 0.0).port_init_matches() <= 1e-6
    elif what.startswith("off-"):
        check_dropout_off(case, what[4:])
    else:
        check_dropout_on(case, what[3:])


@functools.lru_cache(maxsize=None)
def layer_point(case: int, dropout_p: float) -> Point:
    return Point(case, dropout_p)


@functools.lru_cache(maxsize=None)
def jax_result(case: int, dropout_p: float, use_pallas: bool):
    """JAX's output and gradients at the point (set its environment first)."""
    return layer_point(case, dropout_p).jax_run(use_pallas)


def check_dropout_off(case: int, path: str) -> None:
    """The port's ``path`` with dropout off against JAX's jnp path."""
    p = layer_point(case, 0.0)
    assert_close(case, f"{path} path, dropout off", p.port_run(path == "kernel"),
                 jax_result(case, 0.0, False))


def check_dropout_on(case: int, path: str) -> None:
    """The port's plain path against JAX's jnp path, its kernel path against
    JAX's Pallas path in interpret mode (the jnp path where the point does not
    take the kernels), dropout at the point's rate."""
    rate = point(case)["dropout_p"]
    p = layer_point(case, rate)
    pallas = path == "kernel" and p.takes_kernels()
    assert_close(case, f"{path} path, dropout {rate}", p.port_run(path == "kernel"),
                 jax_result(case, rate, pallas))
