"""The card phases' own rules, held on the CPU: what ``chip_smoke.py`` phase 33
expects a lattice point to launch, where it finds LeakyReLU's kink between two
runs, and how the part-by-part steps hold an updated state.

The card counts launches; here the PRNG's draws are counted by wrapping
``prng.draw``, which every ``threefry_draws`` launch goes through."""

import pathlib
import random
import sys

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one thread a test worker: the suite runs in parallel workers

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

from mpgan_tpu_torch.ops import mp, prng  # noqa: E402

POINTS = {str(p["case"]): p for p in chip_smoke.lattice_points()}


def _valid(s) -> bool:
    cfg = chip_smoke.lattice_cfg(s, 0.0)
    try:
        mp._check_edge_features(cfg)
        if not cfg.fully_connected:
            mp._check_knn_fits(cfg, s["n"])
    except ValueError:
        return False
    return True


# the JAX-shape points that run (B = 2: fast on the CPU)
CASES = [c for c in map(str, range(chip_smoke.LATTICE_CASES)) if _valid(POINTS[c])]


@pytest.mark.parametrize("case", CASES)
def test_lattice_point_draws_what_the_card_phase_expects(case, monkeypatch):
    """A layer's init makes ``lattice_init_expected``'s draws, and a run of its
    kernel path (dropout as sampled) ``lattice_expected``'s ``threefry_draws``."""
    s = POINTS[case]
    monkeypatch.setenv("MPGAN_TPU_KNN_KERNEL", s["kernel"])
    monkeypatch.setenv("MPGAN_TPU_KNN_SELECT", s["select"])
    calls = []
    draw = prng.draw

    def counted(*args, **kwargs):
        calls.append(1)
        return draw(*args, **kwargs)

    monkeypatch.setattr(prng, "draw", counted)
    cfg = chip_smoke.lattice_cfg(s, s["dropout_p"])
    layer = mp.MPLayer(cfg, prng.PRNGKey(s["seed"]))
    assert len(calls) == chip_smoke.lattice_init_expected(cfg)["threefry_draws"]
    d = chip_smoke.lattice_inputs(s, "cpu")
    calls.clear()
    chip_smoke.lattice_run(layer, d, True)
    want = chip_smoke.lattice_expected(cfg, d, (s["kernel"], s["select"]), False)
    assert len(calls) == want.get("threefry_draws", 0)


def test_kink_rows_are_the_receivers_whose_node_mlp_flips_sign():
    """Two runs' fn pre-activations: the rows where one unit's sign differs."""
    za = torch.randn(2, 5, 4)
    zb = za.clone()
    zb[1, 3, 2] = -zb[1, 3, 2]
    rows = chip_smoke.lattice_kink_rows({"fn": [za]}, {"fn": [zb]})
    assert rows.nonzero().tolist() == [[1, 3]]
    assert chip_smoke.lattice_kink_rows({"fn": [za]}, {"fn": [za]}).sum() == 0


def test_kink_rows_of_a_dense_chain_at_zero():
    """A dense call's recomputed edge chain against the plain path's pairs: an
    edge whose first pre-activation lies at 0 flags its receiver, live senders
    only."""
    b, n, h = 1, 4, 3
    gen = torch.Generator().manual_seed(0)
    u1 = torch.rand(b, n, h, generator=gen) + 0.5
    u2 = torch.rand(b, n, h, generator=gen) + 0.5
    u2[0, 2, 1] = -u1[0, 1, 1]  # edge (receiver 1, sender 2) at the kink
    w, bias = torch.eye(h), torch.zeros(h)
    rec = {"kind": "dense", "u1": u1, "u2": u2, "m": torch.ones(b, n, 1), "hidden": [w, bias],
           "alpha": 0.2, "p": 0.0, "seed": 0}
    plain = [u1[:, :, None, :] + u2[:, None, :, :]]
    plain.append(torch.where(plain[0] >= 0, plain[0], 0.2 * plain[0]) @ w + bias)
    rows = chip_smoke.lattice_kink_rows({"dense": rec}, {"fe": plain})
    assert rows.nonzero().tolist() == [[0, 1]]
    rec["m"] = torch.tensor([[[1.0], [1.0], [0.0], [1.0]]])  # sender 2 masked
    assert chip_smoke.lattice_kink_rows({"dense": rec}, {"fe": plain}).sum() == 0


def _figures(params, opt, grads=None):
    return {"losses": {"D": 0.5}, "grads": [torch.ones(3)], "buffers": [], "params": params,
            "opt": opt, "key": torch.zeros(2, dtype=torch.int64),
            "params_grads": grads or [torch.ones(3)]}


def test_part_agree_holds_the_update_against_the_replay():
    """The card's updated state is held elementwise against the replay: within
    1e-4 of each update and an ulp it holds, 2e-4 of one update it does not;
    against the CPU's own step only within the absolute bounds (the
    elementwise figures logged)."""
    p0 = [torch.tensor([0.01, -0.02, 0.005])]
    update = torch.tensor([1e-3, -2e-3, 5e-4])
    replay = _figures([p0[0] + update], [torch.tensor([1e-4, 4e-4, 2.5e-5])])
    card = _figures([p0[0] + update], [replay["opt"][0].clone()])
    # the CPU's own step: within the absolute bounds, not elementwise
    cpu = _figures([p0[0] + 1.01 * update], [replay["opt"][0] * 1.2])
    held = chip_smoke.part_agree(card, cpu, replay, p0)
    assert held["ok"] and held["update_over_bound_vs_replay"] <= 1.0
    assert held["update_over_bound_vs_cpu_step_logged"] > 1.0
    assert held["opt_elements_over_vs_cpu_step"] == 3
    card["params"] = [p0[0] + update * torch.tensor([1.0, 1.0, 1.0 + 2e-4])]
    assert not chip_smoke.part_agree(card, cpu, replay, p0)["ok"]
    card["params"] = [p0[0] + update]
    card["opt"] = [replay["opt"][0] * (1 + 2e-4)]
    assert not chip_smoke.part_agree(card, cpu, replay, p0)["ok"]
    card["opt"] = [replay["opt"][0].clone()]
    cpu["params"] = [p0[0] + update + 2e-4]
    assert not chip_smoke.part_agree(card, cpu, replay, p0)["ok"]


def test_sampled_points_are_unchanged_by_the_added_ones():
    """The points added at the published widths keep the eight sampled ones'
    flags (``Random(7000 + i)``) as they are, only their sizes set."""
    sized = {"f", "out", "n", "num_knn"}
    for i in range(chip_smoke.LATTICE_WIDE):
        s, want = POINTS[f"wide{i}"], chip_smoke.lattice_sample(random.Random(7000 + i))
        assert {k: s[k] for k in want if k not in sized} == \
            {k: v for k, v in want.items() if k not in sized}
    assert {p["case"] for p in chip_smoke.lattice_points()[chip_smoke.LATTICE_CASES
                                                           + chip_smoke.LATTICE_WIDE:]} == \
        {"k4", "cond1", "cond2"}


def _x_envelope_runs(monkeypatch, case, fault=None):
    """Phase 33's two bf16 runs at a dense lattice point (here both through the
    plain versions), each recorded for :func:`chip_smoke.lattice_x_envelope`;
    with ``fault`` (``("k3", share)`` or ``("k2", share)``), the first run's
    K3 hands back a du1, or its K2 an aggregate, whose receiver row 1 of jet
    0 is ``1 + share`` times the right one."""
    from mpgan_tpu_torch.ops import mp_kernels as mk

    s = POINTS[case]
    d = chip_smoke.lattice_inputs(s, "cpu")
    layer, _ = chip_smoke.lattice_layer(chip_smoke.lattice_cfg(s, s["dropout_p"]), s, "cpu")
    runs = []
    for planted in (fault, None):
        if planted is not None:
            kind, share = planted
            name = "edge_aggregate_bwd_reference" if kind == "k3" else "edge_aggregate_reference"
            right = getattr(mk, name)

            def wrong(*a, **k):
                out = right(*a, **k)
                t = (out[0] if kind == "k3" else out).clone()
                t[0, 1] = t[0, 1] * (1 + share)
                return (t,) + tuple(out[1:]) if kind == "k3" else t

            monkeypatch.setattr(mk, name, wrong)
        rec = {}
        out, _ = chip_smoke.lattice_run(layer, d, True, torch.bfloat16, parts=rec)
        monkeypatch.undo()
        runs.append((out[-1], rec))
    (out, kernel), (ref, plain) = runs
    return chip_smoke.lattice_x_envelope(out, ref, kernel, plain)


@pytest.mark.parametrize("case", ["3", "k4"])
def test_lattice_x_envelope_holds_the_bf16_mode(case, monkeypatch):
    """A dense point's bf16 ``x`` gradient (K2 route at point 3, the K4 route at
    ``k4``, whose batch is cut to 2 here): two runs of the bf16 mode agree at
    1e-2, each K3 call within its envelope of the float64 model, the K2
    calls equal."""
    if case == "k4":
        monkeypatch.setitem(POINTS, "k4", {**POINTS["k4"], "b": 2})
    res = _x_envelope_runs(monkeypatch, case)
    assert res["ok"] and res["over"] == 0.0 and res["k2_over"] == 0.0
    assert res["kernel_k3_calls"] == res["kernel_k2_calls"] == 1
    assert res["kernel_k3_x_over_envelope"] <= 1.0


@pytest.mark.parametrize("fault", [("k3", 0.05), ("k3", 0.1), ("k2", 0.05)])
def test_lattice_x_envelope_finds_a_fault(fault, monkeypatch):
    """A K3 whose du1, or a K2 whose aggregate, is 5% (or 10%) off in one
    receiver row is found: that run's K3 call lies outside its envelope of
    the model (the smallest such fault it finds: between 3% and 5% of one du1
    row at point 3), or its K2 call more than 1e-2 of the aggregate's largest
    from the other run's, while the other run's K3 holds."""
    res = _x_envelope_runs(monkeypatch, "3", fault)
    assert not res["ok"]
    if fault[0] == "k3":
        assert res["kernel_k3_x_over_envelope"] > 1.0 >= res["plain_k3_x_over_envelope"]
    else:
        assert res["k2_over"] > 1.0
