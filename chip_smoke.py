"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed as it finishes:

1. card and toolchain (``nvidia-smi`` name and power limit, torch, CUDA, nvcc);
2. build the CUDA kernels from ``mpgan_tpu_torch/csrc`` (seconds taken);
3. each kernel against its plain PyTorch version at flagship widths
   (N=30 B=256 and N=150 B=16; sum and mean; random masks), TF32 off,
   failing above rtol = atol = 1e-4;
4. the main path: a flagship 30-particle gluon card and a random generator in
   the reference ``.pt`` layout, 50,000 jets through ``mpgan_tpu_torch.cli.gen``;
5. 150-particle dense generation through ``generate_multi_batch`` at B=512;
   launch counters are reset before phase 4 and read after phase 5, and every
   kernel must have launched;
6. the generator's kernel path against its plain path on a small batch, then
   jets/s of both (CUDA events, best of 3 after warm-up) and each kernel's time
   beside its plain version's;
7. the train kernels against their plain versions: K2 with dropout p = 0.5
   (K1 inside) and K3 with and without weight gradients, with and without
   dropout, at N=30 B=256 and N=150 B=16, sum and mean, random masks. du1, du2,
   dmask and the forward within rtol = atol = 1e-4; the weight gradients, which
   sum every pair row, within 1e-4 of max(1, max|ref|). One dropout element that
   differs breaks these bounds;
8. one flagship-width D+G step on the card against the same step on the CPU
   (the kernels' plain versions), B=16, from the same state, batch, noise and
   dropout keys: losses and every gradient agree. Again on the card's plain
   path with dropout 0 (the plain path draws other masks than the kernels);
9. the main train path: ``mpgan_tpu_torch.cli.train`` with the flagship card
   on synthetic jets, 2 epochs (checkpoints each epoch, evaluation at epoch 2),
   then a resume that restores the state exactly, then a 3rd epoch. Launch
   counters are reset before and read after; K2 with dropout, K3 with and
   without weight gradients and K4 must all have launched;
10. the D+G step at B=256 N=30, kernel path and plain path in turns (CUDA
    events, best of 3), with TFLOP/s against the 679 GFLOP the flagship step
    needs; K3 and K2-train against their plain versions; the host's time to
    issue a step; a ``torch.profiler`` breakdown of three kernel-path steps,
    its idle share taken against those steps' own wall time;
11. the knn kernels against their plain versions at B=160 N=150 k=20 (published
    widths) and at a small ragged shape (N=13 k=5): K5 eval and with dropout
    0.5, with and without self loops, sum and mean, with and without the
    distance feature; K6 with and without weight gradients from the plain
    forward's ``idx``/``dists``, two runs compared bit for bit. ``idx`` is
    compared exactly under the near-tie rule (a differing receiver row must
    have its swapped keys within one bucket step, and at most 1% of the rows may
    differ; the kernel builds the plain version's keys bit for bit, so 0 are
    expected) and the outputs on the agreeing rows, same tolerances as above;
12. the 150-particle knn-20 generation path: 2,048 jets through
    ``generate_multi_batch`` at B=512 and through the ``gen`` CLI (counters
    reset before, read after), shape, finiteness and mask counts; 8 jets on
    the card against the same path through the plain versions on the CPU
    (same keys, so rtol = atol = 1e-4), and against the plain path, whose
    exact-distance search may pick another k-th neighbour at a bucket tie
    (mask column equal, share of values beyond tolerance logged and at most
    20%); jets/s of both paths in turns;
13. one knn-20 D+G step at B=8 N=150 on the card against the CPU, kernel path
    with dropout 0.5 and plain path with dropout 0. The two round a layer's
    inputs otherwise, so a near-tie may pick another neighbour in a few rows:
    losses within 2e-3, gradients within 5e-2 of max(1, max|ref|);
14. the knn train path: ``mpgan_tpu_torch.cli.train`` with ``--num-hits 150
    --no-fully-connected --num-knn 20`` at its default batch (160), 2 epochs, a
    resume that restores the state exactly, and launch counts equal to the
    prediction: per D+G step 8 K5 launches that emit ``idx`` (D on real and
    fake in the D step, G and D in the G step, 2 layers each), 6 K6 with weight
    gradients (D twice in the D step, G in the G step), 2 K6 without (D in the G
    step) and 2 K5 without ``idx`` (the D step's fake batch), plus 2 per
    evaluation batch;
15. the knn D+G step at B=128 N=150, kernel and plain path in turns; K5 (eval
    B=512, train B=160) and K6 (B=160, with and without weight gradients)
    beside their plain versions.

Every kernel's entry in the JSON line carries its bound: the larger of its
FLOPs over 67 TFLOP/s (FP32 outside the tensor cores) and its bytes (inputs
read once, outputs written once) over 3.35 TB/s, at the shape its ``ms`` was
taken at. ``library_ms`` is null: no single PyTorch call computes any of these
functions.

The line before the last is a JSON object with one entry per kernel; the last
line is ``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero
before those lines, as does a machine without a CUDA device.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

TOL = 1e-4  # rtol = atol: FP32 FMA chains against cuBLAS FP32 sums in another order
FLAGSHIP = {"model": "mpgan", "jets": "g", "num_hits": 30}
REPLACES = {
    "edge_aggregate": "mpgan_tpu/ops/mp_pallas.py:319",
    "edge_aggregate_fn": "mpgan_tpu/ops/mp_pallas.py:965",
    "edge_aggregate_bwd": "mpgan_tpu/ops/mp_pallas.py:709",
    "knn_fused_layer": "mpgan_tpu/ops/knn_pallas.py:2023",
    "knn_edge_aggregate_bwd": "mpgan_tpu/ops/knn_pallas.py:1549",
}
K1 = "mpgan_tpu/ops/mp_pallas.py:80 (_dropmul, K1, a device function inside the kernel)"
STEP_GFLOP = 679.0  # one flagship D+G step at B=256, N=30 (PERF.md)
FE = [96, 160, 192]  # the published fe widths
FN = [224, 256, 256]  # fn's input [agg | x] and hidden widths; the output width varies
KNN150 = {**FLAGSHIP, "num_hits": 150, "fully_connected": False, "num_knn": 20}
MAX_DIFFERING_SHARE = 0.01  # receiver rows whose neighbours may differ at near-ties
# a knn step on the card against the CPU: the two round a layer's inputs otherwise, so a
# few of the step's ~20,000 receiver rows swap two near-tied neighbours and with them
# their dropout masks (an untrained G's particles lie close: one row in seven of its
# batch has two selected keys within a bucket step). The bounds catch a wrong path; bit
# for bit the kernels are held to their plain versions on equal inputs in phase 11
NEAR_TIE_LOSS_TOL = 2e-3
NEAR_TIE_GRAD_TOL = 5e-2
PEAK_FP32 = 67e12  # FLOP/s, H100 SXM outside the tensor cores (NVIDIA data sheet)
PEAK_HBM = 3.35e12  # bytes/s


def dense_fwd_bound(b: int, n: int, fn_out: int | None = None) -> dict:
    """Bound of K2 (``fn_out`` None) or K4 at the published widths."""
    hidden = macs(FE) + sum(FE[1:])  # weights and biases
    floats = 2 * b * n * FE[0] + b * n + hidden + b * n * (FE[-1] if fn_out is None else fn_out)
    flops = 2 * b * n * n * macs(FE)
    if fn_out is not None:
        fn = FN + [fn_out]
        floats += b * n * 32 + macs(fn) + sum(fn[1:])
        flops += 2 * b * n * macs(fn)
    return bound(flops, 4 * floats)


def dense_bwd_bound(b: int, n: int, wgrads: bool = True) -> dict:
    """Bound of K3: the recompute, da and (with ``wgrads``) dW, each one chain."""
    hidden = macs(FE) + sum(FE[1:])
    floats = (2 * b * n * FE[0] + b * n) * 2 + b * n * FE[-1] + hidden * (2 if wgrads else 1)
    return bound((3 if wgrads else 2) * 2 * b * n * n * macs(FE), 4 * floats)


def macs(widths) -> int:
    return sum(a * c for a, c in zip(widths[:-1], widths[1:]))


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def bound(flops: float, moved: int) -> dict:
    """The least time the card could take: operations over the FP32 peak or
    bytes over the memory rate, whichever is larger."""
    ops, mem = flops / PEAK_FP32 * 1e3, moved / PEAK_HBM * 1e3
    return {"bound_ms": max(ops, mem), "bound_by": "operations" if ops >= mem else "bytes",
            "library_ms": None}


def log(phase: str, **kv) -> None:
    print(json.dumps({"phase": phase, **kv}), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def kernel_inputs(dev, b, n, fn_out, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *s, scale=1.0: torch.randn(*s, generator=g, device=dev) * scale
    fe = [96, 160, 192]
    hidden = []
    for a, c in zip(fe[:-1], fe[1:]):
        hidden += [r(a, c, scale=a ** -0.5), r(c, scale=0.1)]
    fn = (r(192, 256, scale=224 ** -0.5), r(32, 256, scale=224 ** -0.5), r(256, scale=0.1),
          r(256, 256, scale=1 / 16), r(256, scale=0.1), r(256, fn_out, scale=1 / 16),
          r(fn_out, scale=0.1))
    mask = (torch.rand(b, n, 1, generator=g, device=dev) > 0.3).float()
    return r(b, n, 96, scale=0.5), r(b, n, 96, scale=0.5), mask, tuple(hidden), r(b, n, 32), fn


def errors(out, ref):
    err = (out - ref).abs()
    bad = (err > TOL + TOL * ref.abs()).sum().item()
    rel = (err / ref.abs().clamp_min(1e-6)).max().item()
    return err.max().item(), rel, bad


def wgrad_err(out, ref, tol=TOL):
    """Max abs error of a weight gradient and whether it is within tol * max(1, max|ref|)."""
    if out.numel() == 0:
        return 0.0, True
    err = (out - ref).abs().max().item()
    return err, err <= tol * max(1.0, ref.abs().max().item())


def best_ms(fn, reps=3, inner=3):
    """Best of ``reps`` CUDA-event timings, each the mean of ``inner`` calls."""
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(reps):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(inner):
            fn()
        e.record()
        torch.cuda.synchronize()
        best = min(best, s.elapsed_time(e) / inner)
    return best


def train_kernel_checks(mk, dev):
    """Phase 7: K2 with dropout and K3 against their plain versions."""
    max_err = {"edge_aggregate": 0.0, "edge_aggregate_bwd": 0.0}
    for b, n in ((256, 30), (16, 150)):
        for sum_agg in (True, False):
            u1, u2, mask, hidden, _, _ = kernel_inputs(dev, b, n, 3, seed=11 + n)
            g = torch.randn(b, n, 192, generator=torch.Generator(device=dev).manual_seed(n),
                            device=dev)
            out = mk.edge_aggregate(u1, u2, mask, hidden, 0.2, sum_agg, 0.5, 123457)
            ref = mk.edge_aggregate_reference(u1, u2, mask, hidden, 0.2, sum_agg, 0.5, 123457)
            torch.cuda.synchronize()
            abs_err, _, bad = errors(out, ref)
            log("train_kernel_check", kernel="edge_aggregate", dropout=0.5, b=b, n=n,
                sum_agg=sum_agg, max_abs_err=abs_err, out_of_tol=bad)
            if bad:
                raise SystemExit(f"edge_aggregate (train) disagrees at b={b} n={n}")
            max_err["edge_aggregate"] = max(max_err["edge_aggregate"], abs_err)
            for p in (0.0, 0.5):
                for need in (True, False):
                    out = mk.edge_aggregate_bwd(u1, u2, mask, hidden, g, 0.2, sum_agg, p, 777,
                                                need)
                    ref = mk.edge_aggregate_bwd_reference(u1, u2, mask, hidden, g, 0.2, sum_agg,
                                                          p, 777, need)
                    torch.cuda.synchronize()
                    errs = [errors(o, r) for o, r in zip(out[:3], ref[:3])]
                    werrs = [wgrad_err(o, r) for o, r in zip(out[3], ref[3])]
                    bad = sum(e[2] for e in errs) + sum(not ok for _, ok in werrs)
                    if not need and any(o.any().item() for o in out[3]):
                        bad += 1
                    err = max([e[0] for e in errs] + [e for e, _ in werrs])
                    log("train_kernel_check", kernel="edge_aggregate_bwd", dropout=p,
                        wgrads=need, b=b, n=n, sum_agg=sum_agg,
                        max_abs_err_du1_du2_dmask=[e[0] for e in errs],
                        max_abs_err_wgrads=[e for e, _ in werrs], failures=bad)
                    if bad:
                        raise SystemExit(f"edge_aggregate_bwd disagrees at b={b} n={n} "
                                         f"p={p} wgrads={need} sum={sum_agg}")
                    max_err["edge_aggregate_bwd"] = max(max_err["edge_aggregate_bwd"], err)
            del out, ref
    torch.cuda.empty_cache()
    return max_err


def make_state(args, device, seed=0):
    """A flagship TrainState: weights drawn from a seeded CPU generator, then moved."""
    from mpgan_tpu_torch.models.mpgan import MPDiscriminator, MPGenerator
    from mpgan_tpu_torch.training.config import build_mpgan_discriminator, build_mpgan_generator
    from mpgan_tpu_torch.training.optimizers import build_optimizer
    from mpgan_tpu_torch.training.train_step import TrainState

    gen = torch.Generator().manual_seed(seed)
    g = MPGenerator(build_mpgan_generator(args), gen, device=device)
    d = MPDiscriminator(build_mpgan_discriminator(args), gen, device=device)
    return TrainState(g, d, build_optimizer(args.optimizer, g.parameters(), args.lr_gen),
                      build_optimizer(args.optimizer, d.parameters(), args.lr_disc), gen)


def use_kernels(state, flag):
    state.g.cfg = dataclasses.replace(state.g.cfg, use_kernels=flag)
    state.d.cfg = dataclasses.replace(state.d.cfg, use_kernels=flag)


def step_fn(state, args, data, labels):
    from mpgan_tpu_torch.training.sampling import noise_spec
    from mpgan_tpu_torch.training.train_step import StepConfig, d_step, g_step

    spec = noise_spec("mpgan", {"latent_node_size": args.latent_node_size}, args.num_hits,
                      args.sd)
    cfg = StepConfig(loss=args.loss)

    def step():
        parts = d_step(state, cfg, spec, data, labels)
        parts.update(g_step(state, cfg, spec, data, labels))
        return parts
    return step


def real_batch(b, n=30):
    from mpgan_tpu_torch.data.jetnet import JetNetDataset

    ds = JetNetDataset("g", num_particles=n, synthetic_num_jets=4 * b + 100)
    return torch.as_tensor(ds.particle_data[:b]), torch.as_tensor(ds.jet_data[:b])


def step_check(dev, from_args_dict, card=FLAGSHIP, batch=16, phase="step_check",
               cpu_plain_kernels=True, loss_tol=TOL, grad_tol=TOL):
    """Phases 8 and 13: a D+G step at the published widths on the card against the
    CPU. The kernel path runs with dropout 0.5 against the kernels' plain
    versions on the CPU. The card's plain path runs with dropout 0: against the
    CPU's kernel path for the dense layer (one function, two paths), against the
    CPU's plain path for the knn layer (``cpu_plain_kernels=False``: its two
    paths search differently)."""
    from mpgan_tpu_torch.utils.weights import jax_leaves

    data, labels = real_batch(batch, card["num_hits"])
    worst = {}
    for path, dropout in (("kernel", 0.5), ("plain", 0.0)):
        args = from_args_dict({**card, "disc_dropout": dropout})
        res = {}
        for side, device, kernels in (("card", dev, path == "kernel"),
                                      ("cpu", torch.device("cpu"),
                                       path == "kernel" or cpu_plain_kernels)):
            st = make_state(args, device)
            use_kernels(st, kernels)
            parts = step_fn(st, args, data.to(device), labels.to(device))()
            grads = [p.grad for p in jax_leaves(st.d, True) + jax_leaves(st.g, True)]
            res[side] = ({k: v.item() for k, v in parts.items()},
                         [gr.detach().cpu() for gr in grads])
        (lc, gc), (lp, gp) = res["card"], res["cpu"]
        loss_err = max(abs(lc[k] - lp[k]) / max(1.0, abs(lp[k])) for k in lp)
        grad_err = [wgrad_err(a, b, grad_tol) for a, b in zip(gc, gp)]
        log(phase, path=path, disc_dropout=dropout, batch=batch, losses_card=lc, losses_cpu=lp,
            max_rel_loss_err=loss_err, max_abs_grad_err=max(e for e, _ in grad_err),
            max_grad_err_over_bound=max(
                (a - b).abs().max().item() / max(1.0, b.abs().max().item())
                for a, b in zip(gc, gp)),
            loss_tol=loss_tol, grad_tol=grad_tol, tensors=len(grad_err))
        if loss_err > loss_tol or not all(ok for _, ok in grad_err):
            raise SystemExit(f"{phase}: D+G step on the card ({path} path) disagrees with the CPU")
        worst[path] = loss_err
    return worst


def main_train_path(mk, train_cli, tmp, device="cuda"):
    """Phase 9: the train CLI for 2 epochs, a resume that restores the state, a 3rd epoch."""
    argv = ["--device", device, "--name", "smoke", "--model", "mpgan", "--jets", "g",
            "--dir-path", str(tmp), "--num-samples", "10000", "--eval-tot-samples", "2000",
            "--w1-num-samples", "1000", "--save-model-epochs", "1", "--save-epochs", "2"]
    mk.reset_launch_counts()
    t0 = time.perf_counter()
    t1 = train_cli.main(argv + ["--num-epochs", "2"])
    wall = time.perf_counter() - t0
    models = tmp / "smoke" / "models"
    files = sorted(p.name for p in models.iterdir())
    before = [t.detach().cpu().clone() for t in _leaves(t1.state)]
    rng_before = t1.state.generator.get_state()
    t_resume = train_cli.main(argv + ["--num-epochs", "2"])  # resume, no epoch to run
    after = [t.detach().cpu() for t in _leaves(t_resume.state)]
    restored = (t_resume.start_epoch == 2 and len(before) == len(after)
                and all(torch.equal(a, b) for a, b in zip(before, after)))
    # the saved run reseeded its generator from the checkpoint's words on save
    restored = restored and torch.equal(t_resume.state.generator.get_state(), rng_before)
    t3 = train_cli.main(argv + ["--num-epochs", "3"])
    counts = dict(mk.launch_counts)  # the three runs: 2 epochs, the resume, the 3rd epoch
    losses = {k: t3.losses[k] for k in ("Dr", "Df", "D", "G")}
    finite = all(np.isfinite(v).all() for v in losses.values()) and \
        all(np.isfinite(np.asarray(t3.losses[k])).all() for k in ("w1p", "w1m"))
    log("main_path_train", wall_s_2_epochs=wall, checkpoints=files,
        resumed_from=t_resume.start_epoch, state_restored=restored,
        epochs=len(t3.losses["G"]), losses=losses, w1m=t3.losses["w1m"], launches=counts)
    if files != ["state_1.npz", "state_2.npz"] or not (models / "state_3.npz").exists():
        raise SystemExit(f"train CLI checkpoints missing: {files}")
    if not restored:
        raise SystemExit("resume did not restore the saved train state")
    if not finite or len(t3.losses["G"]) != 3 or t3.losses["G"][:2] != t1.losses["G"]:
        raise SystemExit(f"train CLI losses not finite or not resumed: {losses}")
    for name in ("edge_aggregate_train", "edge_aggregate_bwd", "edge_aggregate_bwd_no_wgrads",
                 "edge_aggregate_fn"):
        if counts[name] == 0:
            raise SystemExit(f"kernel {name} never launched on the train path")
    return counts


def _leaves(state):
    from mpgan_tpu_torch.utils.weights import jax_leaves

    out = []
    for m, opt in ((state.g, state.g_opt), (state.d, state.d_opt)):
        params = jax_leaves(m, True)
        out += params + jax_leaves(m, False)
        for p in params:
            out += [v for k, v in sorted(opt.state[p].items()) if k != "step"]
    return out


def train_timings(mk, dev, from_args_dict, card):
    """Phase 10: the D+G step, K3 and K2-train against their plain versions; a profile."""
    args = from_args_dict(FLAGSHIP)
    data, labels = (t.to(dev) for t in real_batch(256))
    st = make_state(args, dev)
    step = step_fn(st, args, data, labels)

    def run(flag):
        def f():
            use_kernels(st, flag)
            step()
        return f

    ms = {"kernel": float("inf"), "plain": float("inf")}
    for order in (("plain", "kernel"), ("kernel", "plain")):
        for which in order:
            ms[which] = min(ms[which], best_ms(run(which == "kernel"), inner=2))
    use_kernels(st, True)
    log("train_step_time", card=card, batch=256, n=30, kernel_ms=ms["kernel"],
        plain_ms=ms["plain"], kernel_tflops=STEP_GFLOP / ms["kernel"],
        plain_tflops=STEP_GFLOP / ms["plain"])

    times = {}
    for b, n in ((256, 30), (32, 150)):
        u1, u2, mask, hidden, _, _ = kernel_inputs(dev, b, n, 3, seed=b)
        g = torch.randn(b, n, 192, device=dev)
        times[f"bwd_{n}"] = (
            best_ms(lambda: mk.edge_aggregate_bwd(u1, u2, mask, hidden, g, 0.2, True, 0.5, 5),
                    inner=1),
            best_ms(lambda: mk.edge_aggregate_bwd_reference(u1, u2, mask, hidden, g, 0.2, True,
                                                            0.5, 5), inner=1))
        times[f"bwd_no_wgrads_{n}"] = (
            best_ms(lambda: mk.edge_aggregate_bwd(u1, u2, mask, hidden, g, 0.2, True, 0.5, 5,
                                                  False), inner=1),
            best_ms(lambda: mk.edge_aggregate_bwd_reference(u1, u2, mask, hidden, g, 0.2, True,
                                                            0.5, 5, False), inner=1))
        times[f"train_fwd_{n}"] = (
            best_ms(lambda: mk.edge_aggregate(u1, u2, mask, hidden, 0.2, True, 0.5, 5), inner=1),
            best_ms(lambda: mk.edge_aggregate_reference(u1, u2, mask, hidden, 0.2, True, 0.5, 5),
                    inner=1))
        del u1, u2, mask, hidden, g
        torch.cuda.empty_cache()
    log("train_kernel_times", card=card,
        **{k: {"shape": "B=256 N=30" if k.endswith("_30") else "B=32 N=150", "ms": v[0],
               "plain_ms": v[1]} for k, v in times.items()})

    # device-time breakdown of three kernel-path steps: kernel rows only. CUDA
    # activity alone, since tracing every host op slows the host-bound step
    from torch.profiler import ProfilerActivity, profile

    # host issue time: the host's wall time to enqueue three steps after a sync
    # (an upper bound: a full launch queue makes the host wait for the device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        step()
    host_issue_ms = (time.perf_counter() - t0) * 1e3 / 3
    torch.cuda.synchronize()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        s.record()
        for _ in range(3):
            step()
        e.record()
        torch.cuda.synchronize()
    window_ms = s.elapsed_time(e) / 3  # the profiled steps' own wall time
    rows = []
    for ev in prof.key_averages():
        dt = getattr(ev, "self_device_time_total", None)
        if dt is None:
            dt = getattr(ev, "self_cuda_time_total", 0.0)
        if dt > 0 and ev.self_cpu_time_total == 0:
            rows.append((dt / 1e3 / 3, ev.count // 3, ev.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    log("train_step_profile", card=card, profiled_step_ms=window_ms, device_ms_per_step=busy,
        idle_share=1 - busy / window_ms, host_issue_ms=host_issue_ms,
        kernels_per_step=sum(r[1] for r in rows),
        top=[{"name": k[:90], "ms": t, "share": t / busy, "calls": c} for t, c, k in rows[:14]])
    return ms, times


def knn_inputs(dev, b, n, c, widths, k, seed):
    """Operands of the fused knn layer; jets hold between 1 and n real
    particles (some fewer than k), the first one all n."""
    g = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *s, scale=0.5: torch.randn(*s, generator=g, device=dev) * scale  # noqa: E731
    xs = r(b, n, c, scale=0.3)
    counts = torch.randint(1, n + 1, (b,), generator=g, device=dev)
    counts[0] = n
    mask = (torch.arange(n, device=dev)[None, :] < counts[:, None]).float()[..., None]
    hidden = tuple(t for a, w in zip(widths[:-1], widths[1:])
                   for t in (r(a, w, scale=a ** -0.5), r(w, scale=0.1)))
    return dict(xs=xs, xf=((1 - 1e4) * mask + 1e4) * xs, u1=r(b, n, widths[0]),
                u2m=torch.cat([r(b, n, widths[0]), mask], dim=-1), w_d=r(widths[0], scale=0.3),
                hidden=hidden, g=r(b, n, widths[-1]), mask=mask)


def knn_kernel_checks(kk, mk, dev):
    """Phase 11: K5 and K6 against their plain versions."""
    max_err = {"knn_fused_layer": 0.0, "knn_edge_aggregate_bwd": 0.0}
    rows_differing = rows_total = 0
    for b, n, c, widths, k in ((160, 150, 32, FE, 20), (3, 13, 8, [24, 16, 12], 5)):
        d = knn_inputs(dev, b, n, c, widths, k, seed=100 + n)
        keys = kk.knn_keys(d["xs"], d["xf"])
        for self_loops, sum_agg, pos_diffs in ((True, True, False), (False, False, True),
                                               (True, False, False), (False, True, True)):
            w_d = d["w_d"] if pos_diffs else None
            for p in (0.0, 0.5):
                fwd = (d["xs"], d["xf"], d["u1"], d["u2m"], w_d, d["hidden"], k, self_loops,
                       pos_diffs, 0.2, sum_agg, p, 123457)
                out, idx, dists = kk.knn_fused_layer(*fwd, True)
                out_eval = kk.knn_fused_layer(*fwd)[0]
                ref, idx_ref, dists_ref = kk.knn_fused_layer_reference(*fwd, True)
                torch.cuda.synchronize()
                agree, differing, far = kk.compare_neighbours(idx, idx_ref, keys, d["mask"])
                rows_differing += differing
                rows_total += agree.numel()
                abs_err, _, bad = errors(out[agree], ref[agree])
                if pos_diffs:
                    live = torch.gather(d["mask"][:, None, :, 0].expand(-1, n, -1), 2,
                                        idx_ref.long()) > 0
                    live &= agree[..., None]
                    bad += errors(dists[live], dists_ref[live])[2]
                same = torch.equal(out, out_eval)
                log("knn_kernel_check", kernel="knn_fused_layer", b=b, n=n, k=k, dropout=p,
                    self_loops=self_loops, sum_agg=sum_agg, pos_diffs=pos_diffs,
                    rows_differing=differing, rows_not_near_ties=far, max_abs_err=abs_err,
                    out_of_tol=bad, launch_without_idx_equal=same)
                if bad or far or not same or differing > MAX_DIFFERING_SHARE * agree.numel():
                    raise SystemExit(f"knn_fused_layer disagrees at b={b} n={n} p={p} "
                                     f"self_loops={self_loops} sum={sum_agg} dists={pos_diffs}")
                max_err["knn_fused_layer"] = max(max_err["knn_fused_layer"], abs_err)
                for need in (True, False):
                    bwd = (d["u1"], d["u2m"], idx_ref, dists_ref, w_d, d["hidden"], d["g"], 0.2,
                           sum_agg, p, 123457, need)
                    res = kk.knn_edge_aggregate_bwd(*bwd)
                    again = kk.knn_edge_aggregate_bwd(*bwd)
                    rref = kk.knn_edge_aggregate_bwd_reference(*bwd)
                    torch.cuda.synchronize()
                    flat = lambda t: [x for x in (*t[:5], *t[5]) if x is not None]  # noqa: E731
                    repeat = all(torch.equal(x, y) for x, y in zip(flat(res), flat(again)))
                    # dmask of a masked sender sums activations at the scale of its
                    # pushed-away distance (1e4 under pos_diffs), with cancellation: it is
                    # held to the weight gradients' bound, the real senders' to the strict one
                    real = d["mask"] > 0
                    errs = [errors(o, r) for o, r in ((res[0], rref[0]), (res[1], rref[1]),
                                                      (res[2][real], rref[2][real]))]
                    if pos_diffs:
                        errs.append(errors(res[3], rref[3]))
                    wpairs = list(zip(res[5], rref[5])) + ([(res[4], rref[4])] if pos_diffs
                                                           else [])
                    wpairs.append((res[2][~real], rref[2][~real]))
                    werrs = [wgrad_err(o, r) for o, r in wpairs]
                    bad = sum(e[2] for e in errs) + sum(not ok for _, ok in werrs)
                    wgrads_out = [o for o in (*res[5], res[4]) if o is not None]
                    if not need and any(o.any().item() for o in wgrads_out):
                        bad += 1
                    err = max([e[0] for e in errs] + [e for e, _ in werrs[:-1]])
                    log("knn_kernel_check", kernel="knn_edge_aggregate_bwd", b=b, n=n, k=k,
                        dropout=p, wgrads=need, sum_agg=sum_agg, pos_diffs=pos_diffs,
                        max_abs_err_du1_du2_dmask_ddists=[e[0] for e in errs],
                        max_abs_err_wgrads=[e for e, _ in werrs[:-1]],
                        max_abs_err_dmask_of_masked_senders=werrs[-1][0], failures=bad,
                        two_runs_bit_identical=repeat)
                    if bad or not repeat:
                        raise SystemExit(f"knn_edge_aggregate_bwd disagrees at b={b} n={n} p={p} "
                                         f"wgrads={need} sum={sum_agg} dists={pos_diffs}")
                    max_err["knn_edge_aggregate_bwd"] = max(max_err["knn_edge_aggregate_bwd"],
                                                            err)
                del out, ref, res, again, rref
        del d, keys
        torch.cuda.empty_cache()
    log("knn_neighbour_rows", compared=rows_total, differing=rows_differing,
        share=rows_differing / rows_total, bound=MAX_DIFFERING_SHARE)
    return max_err


def knn_generation(mk, gen_cli, dev, card):
    """Phase 12: the 150-particle knn-20 generation path."""
    from mpgan_tpu_torch.data.jetnet import JetNetDataset
    from mpgan_tpu_torch.models.mpgan import MPGenerator
    from mpgan_tpu_torch.training.config import build_mpgan_generator, from_args_dict
    from mpgan_tpu_torch.training.sampling import generate_multi_batch, noise_spec
    from mpgan_tpu_torch.utils.weights import mp_generator_to_reference_sd

    args = from_args_dict(KNN150)
    cfg = build_mpgan_generator(args)
    g_cpu = MPGenerator(cfg, torch.Generator().manual_seed(3))
    g = MPGenerator(cfg, torch.Generator().manual_seed(3), device=dev)
    spec = noise_spec("mpgan", {"latent_node_size": 32}, 150, args.sd)
    ds = JetNetDataset("g", num_particles=150, split="valid")
    lab = ds.jet_data[np.random.default_rng(0).choice(len(ds), size=2048)]
    mk.reset_launch_counts()
    t0 = time.perf_counter()
    out = generate_multi_batch(g, spec, torch.Generator(device=dev).manual_seed(1), 2048, 512,
                               labels=lab)
    wall = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        (tmp / "card.txt").write_text(repr(args.to_dict()))
        torch.save(mp_generator_to_reference_sd(g_cpu), tmp / "G.pt")
        t0 = time.perf_counter()
        gen_cli.main(["--g-args", str(tmp / "card.txt"), "--g-state", str(tmp / "G.pt"),
                      "--output-file", str(tmp / "gen.npy"), "--device", "cuda", "--seed", "0",
                      "--num-samples", "2048", "--batch-size", "512"])
        wall_cli = time.perf_counter() - t0
        jets = np.load(tmp / "gen.npy")
    launches = dict(mk.launch_counts)
    counts = (lab[:, -1].astype(np.float32) * 150).astype(np.int32)
    if out.shape != (2048, 150, 4) or not np.isfinite(out).all():
        raise SystemExit(f"150p knn output {out.shape} is not finite (2048, 150, 4)")
    if not np.array_equal((out[..., -1] + 0.5).sum(1), counts):
        raise SystemExit("150p knn mask counts disagree with the labels")
    if jets.shape != (2048, 150, 3) or not np.isfinite(jets).all():
        raise SystemExit(f"knn gen CLI output {jets.shape} is not finite (2048, 150, 3)")
    if not np.array_equal(np.any(jets != 0, axis=-1).sum(axis=1), counts) \
            or (jets[:, :, 2] < 0).any():
        raise SystemExit("knn gen CLI output: masked particles not zero or negative pT")
    log("main_path_150p_knn20", jets=list(out.shape), wall_s=wall, cli_jets=list(jets.shape),
        cli_wall_s=wall_cli, launches=launches)
    if launches["knn_fused_layer"] != 2 * 4 * 2:  # 2 layers, 4 batches, both entry points
        raise SystemExit(f"knn generation launched K5 {launches['knn_fused_layer']} times, not 16")

    # 8 jets: against the same path through the plain versions (CPU), and the plain path
    noise = torch.randn(512, 150, 32, generator=torch.Generator(device=dev).manual_seed(2),
                        device=dev) * 0.2
    labels = torch.as_tensor(lab[:512], device=dev)
    kernel_cfg, plain_cfg = cfg, dataclasses.replace(cfg, use_kernels=False)
    g_cpu.cfg = dataclasses.replace(cfg, use_kernels=True)
    with torch.inference_mode():
        y_k = g(noise[:8], labels[:8])
        y_ref = g_cpu(noise[:8].cpu(), labels[:8].cpu()).to(dev)
        g.cfg = plain_cfg
        y_p = g(noise[:8], labels[:8])
        g.cfg = kernel_cfg
    abs_err, rel_err, bad = errors(y_k, y_ref)
    p_err, _, p_bad = errors(y_k, y_p)
    share = p_bad / y_p.numel()
    log("knn_generator_check", n=150, jets=8, max_abs_err_vs_plain_versions=abs_err,
        out_of_tol_vs_plain_versions=bad, max_abs_err_vs_plain_path=p_err,
        share_beyond_tol_vs_plain_path=share)
    if bad or not torch.equal(y_k[..., -1], y_ref[..., -1]):
        raise SystemExit("150p knn generator: kernel path disagrees with its plain versions")
    if share > 0.2 or not torch.equal(y_k[..., -1], y_p[..., -1]):
        raise SystemExit("150p knn generator: kernel path too far from the plain path")

    def run(c):
        def f():
            g.cfg = c
            with torch.inference_mode():
                g(noise, labels)
        return f

    ms = {"kernel": float("inf"), "plain": float("inf")}
    for order in (("plain", "kernel"), ("kernel", "plain")):
        for which in order:
            ms[which] = min(ms[which], best_ms(run(kernel_cfg if which == "kernel"
                                                   else plain_cfg)))
    g.cfg = kernel_cfg
    log("generation_rate", card=card, n=150, knn=20, batch=512, kernel_ms=ms["kernel"],
        plain_ms=ms["plain"], kernel_jets_per_s=512 / ms["kernel"] * 1e3,
        plain_jets_per_s=512 / ms["plain"] * 1e3)
    return launches


def knn_train_path(mk, train_cli, tmp):
    """Phase 14: the train CLI on the 150-particle knn-20 model at its default
    batch, 2 epochs, then a resume that restores the state exactly."""
    argv = ["--device", "cuda", "--name", "knn", "--model", "mpgan", "--jets", "g",
            "--num-hits", "150", "--no-fully-connected", "--num-knn", "20",
            "--dir-path", str(tmp), "--num-samples", "3200", "--eval-tot-samples", "640",
            "--w1-num-samples", "320", "--save-model-epochs", "1", "--save-epochs", "2",
            "--num-epochs", "2"]
    mk.reset_launch_counts()
    t0 = time.perf_counter()
    t1 = train_cli.main(argv)
    wall = time.perf_counter() - t0
    before = [t.detach().cpu().clone() for t in _leaves(t1.state)]
    rng_before = t1.state.generator.get_state()
    t2 = train_cli.main(argv)  # resume, no epoch to run
    counts = dict(mk.launch_counts)
    after = [t.detach().cpu() for t in _leaves(t2.state)]
    restored = (t2.start_epoch == 2 and len(before) == len(after)
                and all(torch.equal(a, b) for a, b in zip(before, after))
                and torch.equal(t2.state.generator.get_state(), rng_before))
    batch = t1.args.batch_size
    steps = 2 * (len(t1.train_dataset) // batch)
    eval_batches = -(-min(t1.args.eval_tot_samples, len(t1.valid_dataset)) // batch)
    # per D+G step: D on real and fake (D step) and G and D (G step) emit idx, 2 layers
    # each; K6 with weight gradients for D twice and G once, without for D in the G step;
    # the D step's fake batch and the evaluation run K5 without idx
    predicted = {"knn_fused_layer_train": 8 * steps, "knn_edge_aggregate_bwd": 6 * steps,
                 "knn_edge_aggregate_bwd_no_wgrads": 2 * steps,
                 "knn_fused_layer": 2 * steps + 2 * eval_batches}
    losses = {k: t1.losses[k] for k in ("Dr", "Df", "D", "G")}
    finite = all(np.isfinite(v).all() for v in losses.values()) and \
        all(np.isfinite(np.asarray(t1.losses[k])).all() for k in ("w1p", "w1m"))
    files = sorted(f.name for f in (tmp / "knn" / "models").iterdir())
    log("main_path_train_knn20", wall_s_2_epochs=wall, batch=batch, steps=steps,
        eval_batches=eval_batches, checkpoints=files, resumed_from=t2.start_epoch,
        state_restored=restored, losses=losses, w1m=t1.losses["w1m"], launches=counts,
        predicted=predicted)
    if batch != 160 or not all(not c.fully_connected and c.num_knn == 20
                               for c in t1.state.d.cfg.layers + t1.state.g.cfg.layers):
        raise SystemExit("knn train CLI did not build the knn-20 model at batch 160")
    if files != ["state_1.npz", "state_2.npz"] or not restored:
        raise SystemExit(f"knn train CLI: checkpoints {files}, state restored: {restored}")
    if not finite or len(t1.losses["G"]) != 2 or t2.losses["G"] != t1.losses["G"]:
        raise SystemExit(f"knn train CLI losses not finite or not resumed: {losses}")
    for name, want in predicted.items():
        if counts[name] != want:
            raise SystemExit(f"knn train path launched {name} {counts[name]} times, "
                             f"predicted {want}")
    if any(v for k, v in counts.items() if k not in predicted):
        raise SystemExit(f"knn train path launched a dense kernel: {counts}")
    return counts


def knn_timings(kk, dev, from_args_dict, card):
    """Phase 15: the knn D+G step at B=128 N=150 and K5/K6 beside their plain versions."""
    args = from_args_dict(KNN150)
    data, labels = (t.to(dev) for t in real_batch(128, 150))
    st = make_state(args, dev)
    step = step_fn(st, args, data, labels)

    def run(flag):
        def f():
            use_kernels(st, flag)
            step()
        return f

    ms = {"kernel": float("inf"), "plain": float("inf")}
    for order in (("plain", "kernel"), ("kernel", "plain")):
        for which in order:
            ms[which] = min(ms[which], best_ms(run(which == "kernel"), inner=2))
    log("train_step_time", card=card, batch=128, n=150, knn=20, kernel_ms=ms["kernel"],
        plain_ms=ms["plain"])
    del st, step
    torch.cuda.empty_cache()

    times = {}
    d = knn_inputs(dev, 512, 150, 32, FE, 20, seed=8)
    fwd = (d["xs"], d["xf"], d["u1"], d["u2m"], None, d["hidden"], 20, True, False, 0.2, True)
    out = kk.knn_fused_layer(*fwd)[0]
    times["eval"] = dict(
        shape="B=512 N=150 k=20 eval",
        ms=best_ms(lambda: kk.knn_fused_layer(*fwd), inner=1),
        plain_ms=best_ms(lambda: kk.knn_fused_layer_reference(*fwd), inner=1),
        **bound(2 * 512 * 150 * (20 * macs(FE) + 150 * 33),
                nbytes(d["xs"], d["xf"], d["u1"], d["u2m"], *d["hidden"], out)))
    del d, fwd, out
    torch.cuda.empty_cache()
    d = knn_inputs(dev, 160, 150, 32, FE, 20, seed=9)
    fwd = (d["xs"], d["xf"], d["u1"], d["u2m"], None, d["hidden"], 20, True, False, 0.2, True,
           0.5, 5)
    out, idx, _ = kk.knn_fused_layer(*fwd, True)
    rows = 160 * 150 * 20
    times["train"] = dict(
        shape="B=160 N=150 k=20 dropout 0.5, idx written",
        ms=best_ms(lambda: kk.knn_fused_layer(*fwd, True), inner=1),
        plain_ms=best_ms(lambda: kk.knn_fused_layer_reference(*fwd, True), inner=1),
        **bound(2 * rows * macs(FE) + 2 * 160 * 150 * 150 * 33,
                nbytes(d["xs"], d["xf"], d["u1"], d["u2m"], *d["hidden"], out, idx)))
    for need in (True, False):
        bwd = (d["u1"], d["u2m"], idx, None, None, d["hidden"], d["g"], 0.2, True, 0.5, 5, need)
        res = kk.knn_edge_aggregate_bwd(*bwd)
        grads = (*res[:3], *(res[5] if need else ()))
        times["bwd" if need else "bwd_no_wgrads"] = dict(
            shape="B=160 N=150 k=20 dropout 0.5, " + ("with" if need else "without")
            + " weight gradients",
            ms=best_ms(lambda: kk.knn_edge_aggregate_bwd(*bwd), inner=1),
            plain_ms=best_ms(lambda: kk.knn_edge_aggregate_bwd_reference(*bwd), inner=1),
            **bound((3 if need else 2) * 2 * rows * macs(FE),
                    nbytes(d["u1"], d["u2m"], idx, d["g"], *d["hidden"], *grads)))
        del res, grads
    log("knn_kernel_times", card=card, **times)
    return ms, times


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device available")
    # the port itself; a directory without the checkout fails here
    from mpgan_tpu_torch.cli import gen
    from mpgan_tpu_torch.cli import train as train_cli
    from mpgan_tpu_torch.data.jetnet import JetNetDataset
    from mpgan_tpu_torch.models.mpgan import MPGenerator
    from mpgan_tpu_torch.ops import _build
    from mpgan_tpu_torch.ops import knn_kernels as kk
    from mpgan_tpu_torch.ops import mp_kernels as mk
    from mpgan_tpu_torch.training.config import build_mpgan_generator, from_args_dict
    from mpgan_tpu_torch.training.sampling import generate_multi_batch, noise_spec
    from mpgan_tpu_torch.utils.weights import mp_generator_to_reference_sd

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()

    # 1. card and toolchain
    nvcc = _build.find_nvcc()
    nvcc_version = subprocess.run(
        [nvcc, "--version"], capture_output=True, text=True, check=True
    ).stdout.strip().splitlines()[-1]
    log("toolchain", card=card, torch=torch.__version__, cuda=torch.version.cuda,
        nvcc=nvcc_version, python=sys.version.split()[0])

    # 2. build
    t0 = time.perf_counter()
    _build.library()
    ptxas = [line.strip() for line in _build.build_info.get("log", "").splitlines()
             if "registers" in line or "spill" in line]
    log("build", seconds=time.perf_counter() - t0, cached=_build.build_info.get("cached"),
        library=_build.build_info.get("path"), ptxas=ptxas)

    # 3. kernels against their plain versions
    max_err = {"edge_aggregate": 0.0, "edge_aggregate_fn": 0.0}
    for b, n in ((256, 30), (16, 150)):
        for sum_agg in (True, False):
            for fn_out in (32, 3):
                u1, u2, mask, hidden, x, fn = kernel_inputs(dev, b, n, fn_out, seed=n + fn_out)
                checks = {
                    "edge_aggregate": (
                        mk.edge_aggregate(u1, u2, mask, hidden, 0.2, sum_agg),
                        mk.edge_aggregate_reference(u1, u2, mask, hidden, 0.2, sum_agg),
                    ),
                    "edge_aggregate_fn": (
                        mk.edge_aggregate_fn(u1, u2, mask, hidden, x, fn, 0.2, sum_agg, 0.2, True),
                        mk.edge_aggregate_fn_reference(u1, u2, mask, hidden, x, fn, 0.2,
                                                       sum_agg, 0.2, True),
                    ),
                }
                torch.cuda.synchronize()
                for name, (out, ref) in checks.items():
                    abs_err, rel_err, bad = errors(out, ref)
                    log("kernel_check", kernel=name, b=b, n=n, sum_agg=sum_agg, fn_out=fn_out,
                        max_abs_err=abs_err, max_rel_err=rel_err, out_of_tol=bad)
                    if bad:
                        raise SystemExit(f"{name} disagrees with its plain version at "
                                         f"b={b} n={n} sum={sum_agg}: {bad} elements beyond "
                                         f"rtol=atol={TOL}")
                    max_err[name] = max(max_err[name], abs_err)

    # 4. main path: 50,000 flagship jets through the gen CLI
    mk.reset_launch_counts()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        args = from_args_dict(FLAGSHIP)
        (tmp / "card.txt").write_text(repr(args.to_dict()))
        g30 = MPGenerator(build_mpgan_generator(args), torch.Generator().manual_seed(0))
        torch.save(mp_generator_to_reference_sd(g30), tmp / "G.pt")
        out_file = tmp / "gen.npy"
        t0 = time.perf_counter()
        gen.main(["--g-args", str(tmp / "card.txt"), "--g-state", str(tmp / "G.pt"),
                  "--output-file", str(out_file), "--device", "cuda", "--seed", "0",
                  "--num-samples", "50000", "--batch-size", "4096"])
        wall = time.perf_counter() - t0
        jets = np.load(out_file)
    ds = JetNetDataset("g", num_particles=30, split="valid")
    labels = ds.jet_data[np.random.default_rng(0).choice(len(ds), size=50000)]
    counts = (labels[:, -1].astype(np.float32) * 30).astype(np.int32)
    real = np.any(jets != 0, axis=-1).sum(axis=1)
    if jets.shape != (50000, 30, 3) or not np.isfinite(jets).all():
        raise SystemExit(f"gen output {jets.shape} is not finite (50000, 30, 3)")
    if not np.array_equal(real, counts) or (jets[:, :, 2] < 0).any():
        raise SystemExit("gen output: masked particles not zero or negative pT")
    log("main_path_30p", jets=list(jets.shape), wall_s=wall, launches=dict(mk.launch_counts))

    # 5. 150-particle dense generation
    args150 = from_args_dict({**FLAGSHIP, "num_hits": 150})
    cfg150 = build_mpgan_generator(args150)
    g150 = MPGenerator(cfg150, torch.Generator().manual_seed(1), device=dev)
    spec150 = noise_spec("mpgan", {"latent_node_size": 32}, 150, args150.sd)
    ds150 = JetNetDataset("g", num_particles=150, split="valid", synthetic_num_jets=10000)
    lab150 = ds150.jet_data[np.random.default_rng(1).choice(len(ds150), size=2048)]
    t0 = time.perf_counter()
    out150 = generate_multi_batch(g150, spec150, torch.Generator(device=dev).manual_seed(1),
                                  2048, 512, labels=lab150)
    wall150 = time.perf_counter() - t0
    launches = dict(mk.launch_counts)
    mask150 = out150[..., -1] + 0.5
    if out150.shape != (2048, 150, 4) or not np.isfinite(out150).all():
        raise SystemExit(f"150p output {out150.shape} is not finite (2048, 150, 4)")
    if not np.array_equal(mask150.sum(1), (lab150[:, 0] * 150).astype(np.int32)):
        raise SystemExit("150p mask counts disagree with the labels")
    log("main_path_150p", jets=list(out150.shape), wall_s=wall150, launches=launches)
    for name in ("edge_aggregate", "edge_aggregate_fn"):
        if launches[name] == 0:
            raise SystemExit(f"kernel {name} never launched on the generation path")

    # 6. kernel path against plain path, then timings (kernel and plain in turns)
    timings = {}
    for n, b, g in ((30, 4096, g30.to(dev)), (150, 512, g150)):
        noise = torch.randn(b, n, 32, generator=torch.Generator(device=dev).manual_seed(2),
                            device=dev) * 0.2
        lab = torch.as_tensor(
            (np.random.default_rng(2).integers(1, n + 1, size=(b, 1)) / n).astype(np.float32),
            device=dev,
        )
        kernel_cfg = g.cfg
        plain_cfg = dataclasses.replace(kernel_cfg, use_kernels=False)
        with torch.inference_mode():
            y_k = g(noise[:8], lab[:8])
            g.cfg = plain_cfg
            y_p = g(noise[:8], lab[:8])
            g.cfg = kernel_cfg
        abs_err, rel_err, bad = errors(y_k, y_p)
        if bad or not torch.equal(y_k[..., -1], y_p[..., -1]):
            raise SystemExit(f"{n}p generator: kernel path disagrees with plain path")
        log("generator_check", n=n, max_abs_err=abs_err, max_rel_err=rel_err)

        def run(cfg):
            def f():
                g.cfg = cfg
                with torch.inference_mode():
                    g(noise, lab)
            return f

        ms = {"kernel": float("inf"), "plain": float("inf")}
        for order in (("plain", "kernel"), ("kernel", "plain")):
            for which in order:
                ms[which] = min(ms[which], best_ms(run(kernel_cfg if which == "kernel"
                                                       else plain_cfg)))
        g.cfg = kernel_cfg
        timings[n] = ms
        log("generation_rate", card=card, n=n, batch=b,
            kernel_ms=ms["kernel"], plain_ms=ms["plain"],
            kernel_jets_per_s=b / ms["kernel"] * 1e3, plain_jets_per_s=b / ms["plain"] * 1e3)

    # per-kernel times at the main path's shapes
    u1, u2, mask, hidden, x, fn = kernel_inputs(dev, 4096, 30, 3, seed=7)
    k4 = (best_ms(lambda: mk.edge_aggregate_fn(u1, u2, mask, hidden, x, fn, 0.2, True, 0.2,
                                               True)),
          best_ms(lambda: mk.edge_aggregate_fn_reference(u1, u2, mask, hidden, x, fn, 0.2, True,
                                                         0.2, True)))
    del u1, u2, mask, hidden, x, fn
    torch.cuda.empty_cache()
    u1, u2, mask, hidden, _, _ = kernel_inputs(dev, 512, 150, 3, seed=8)
    k2 = (best_ms(lambda: mk.edge_aggregate(u1, u2, mask, hidden, 0.2, True), inner=1),
          best_ms(lambda: mk.edge_aggregate_reference(u1, u2, mask, hidden, 0.2, True), inner=1))
    log("kernel_times", card=card,
        edge_aggregate={"shape": "B=512 N=150", "ms": k2[0], "plain_ms": k2[1]},
        edge_aggregate_fn={"shape": "B=4096 N=30", "ms": k4[0], "plain_ms": k4[1]})

    # 7-10. training
    train_err = train_kernel_checks(mk, dev)
    step_check(dev, from_args_dict)
    with tempfile.TemporaryDirectory() as tmp:
        train_launches = main_train_path(mk, train_cli, pathlib.Path(tmp))
    step_ms, ttimes = train_timings(mk, dev, from_args_dict, card)

    # 11-15. the 150-particle knn-20 path
    knn_err = knn_kernel_checks(kk, mk, dev)
    knn_gen_launches = knn_generation(mk, gen, dev, card)
    step_check(dev, from_args_dict, card=KNN150, batch=8, phase="knn_step_check",
               cpu_plain_kernels=False, loss_tol=NEAR_TIE_LOSS_TOL, grad_tol=NEAR_TIE_GRAD_TOL)
    with tempfile.TemporaryDirectory() as tmp:
        knn_train_launches = knn_train_path(mk, train_cli, pathlib.Path(tmp))
    knn_step_ms, ktimes = knn_timings(kk, dev, from_args_dict, card)

    fwd_src = "mpgan_tpu_torch/csrc/edge_aggregate.cu"
    kernels = [
        {"name": "edge_aggregate", "route": "cuda", "source": fwd_src,
         "replaces": REPLACES["edge_aggregate"], "includes": K1,
         "launches": launches["edge_aggregate"] + train_launches["edge_aggregate"]
         + train_launches["edge_aggregate_train"],
         "max_abs_err": max(max_err["edge_aggregate"], train_err["edge_aggregate"]),
         "ms": k2[0], "plain_ms": k2[1], **dense_fwd_bound(512, 150), "shape": "B=512 N=150 eval",
         "train_ms": ttimes["train_fwd_30"][0], "train_plain_ms": ttimes["train_fwd_30"][1],
         "train_shape": "B=256 N=30 dropout 0.5",
         "train_bound_ms": dense_fwd_bound(256, 30)["bound_ms"]},
        {"name": "edge_aggregate_fn", "route": "cuda", "source": fwd_src,
         "replaces": REPLACES["edge_aggregate_fn"],
         "launches": launches["edge_aggregate_fn"] + train_launches["edge_aggregate_fn"],
         "max_abs_err": max_err["edge_aggregate_fn"], "ms": k4[0], "plain_ms": k4[1],
         **dense_fwd_bound(4096, 30, 3), "shape": "B=4096 N=30"},
        {"name": "edge_aggregate_bwd", "route": "cuda",
         "source": "mpgan_tpu_torch/csrc/edge_aggregate_bwd.cu",
         "replaces": REPLACES["edge_aggregate_bwd"], "includes": K1,
         "launches": train_launches["edge_aggregate_bwd"]
         + train_launches["edge_aggregate_bwd_no_wgrads"],
         "max_abs_err": train_err["edge_aggregate_bwd"],
         "ms": ttimes["bwd_30"][0], "plain_ms": ttimes["bwd_30"][1], **dense_bwd_bound(256, 30),
         "shape": "B=256 N=30 dropout 0.5 with weight gradients",
         "ms_150": ttimes["bwd_150"][0], "plain_ms_150": ttimes["bwd_150"][1],
         "bound_ms_150": dense_bwd_bound(32, 150)["bound_ms"]},
        {"name": "knn_fused_layer", "route": "cuda",
         "source": "mpgan_tpu_torch/csrc/knn_fused.cu", "replaces": REPLACES["knn_fused_layer"],
         "includes": K1,
         "launches": knn_gen_launches["knn_fused_layer"] + knn_train_launches["knn_fused_layer"]
         + knn_train_launches["knn_fused_layer_train"],
         "max_abs_err": knn_err["knn_fused_layer"], **ktimes["eval"],
         "train_ms": ktimes["train"]["ms"], "train_plain_ms": ktimes["train"]["plain_ms"],
         "train_shape": ktimes["train"]["shape"], "train_bound_ms": ktimes["train"]["bound_ms"]},
        {"name": "knn_edge_aggregate_bwd", "route": "cuda",
         "source": "mpgan_tpu_torch/csrc/knn_edge_bwd.cu",
         "replaces": REPLACES["knn_edge_aggregate_bwd"], "includes": K1,
         "launches": knn_train_launches["knn_edge_aggregate_bwd"]
         + knn_train_launches["knn_edge_aggregate_bwd_no_wgrads"],
         "max_abs_err": knn_err["knn_edge_aggregate_bwd"], **ktimes["bwd"],
         "ms_no_wgrads": ktimes["bwd_no_wgrads"]["ms"],
         "plain_ms_no_wgrads": ktimes["bwd_no_wgrads"]["plain_ms"],
         "bound_ms_no_wgrads": ktimes["bwd_no_wgrads"]["bound_ms"]},
    ]
    log("knn_train_step", batch=128, kernel_ms=knn_step_ms["kernel"],
        plain_ms=knn_step_ms["plain"])
    log("train_step", kernel_ms=step_ms["kernel"], plain_ms=step_ms["plain"])
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
