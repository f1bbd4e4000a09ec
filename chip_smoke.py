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
    its idle share taken against those steps' own wall time.

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
}
K1 = "mpgan_tpu/ops/mp_pallas.py:80 (_dropmul, K1, a device function inside the kernel)"
STEP_GFLOP = 679.0  # one flagship D+G step at B=256, N=30 (PERF.md)


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


def wgrad_err(out, ref):
    """Max abs error of a weight gradient and whether it is within 1e-4 * max(1, max|ref|)."""
    err = (out - ref).abs().max().item()
    return err, err <= TOL * max(1.0, ref.abs().max().item())


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


def step_check(dev, from_args_dict):
    """Phase 8: a flagship-width D+G step on the card against the CPU."""
    from mpgan_tpu_torch.utils.weights import jax_leaves

    data, labels = real_batch(16)
    worst = {}
    for path, dropout in (("kernel", 0.5), ("plain", 0.0)):
        args = from_args_dict({**FLAGSHIP, "disc_dropout": dropout})
        res = {}
        for side, device, kernels in (("card", dev, path == "kernel"),
                                      ("cpu", torch.device("cpu"), True)):
            st = make_state(args, device)
            use_kernels(st, kernels)
            parts = step_fn(st, args, data.to(device), labels.to(device))()
            grads = [p.grad for p in jax_leaves(st.d, True) + jax_leaves(st.g, True)]
            res[side] = ({k: v.item() for k, v in parts.items()},
                         [gr.detach().cpu() for gr in grads])
        (lc, gc), (lp, gp) = res["card"], res["cpu"]
        loss_err = max(abs(lc[k] - lp[k]) / max(1.0, abs(lp[k])) for k in lp)
        grad_err = [wgrad_err(a, b) for a, b in zip(gc, gp)]
        log("step_check", path=path, disc_dropout=dropout, losses_card=lc, losses_cpu=lp,
            max_rel_loss_err=loss_err, max_abs_grad_err=max(e for e, _ in grad_err),
            tensors=len(grad_err))
        if loss_err > TOL or not all(ok for _, ok in grad_err):
            raise SystemExit(f"D+G step on the card ({path} path) disagrees with the CPU")
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


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device available")
    # the port itself; a directory without the checkout fails here
    from mpgan_tpu_torch.cli import gen
    from mpgan_tpu_torch.cli import train as train_cli
    from mpgan_tpu_torch.data.jetnet import JetNetDataset
    from mpgan_tpu_torch.models.mpgan import MPGenerator
    from mpgan_tpu_torch.ops import _build
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

    fwd_src = "mpgan_tpu_torch/csrc/edge_aggregate.cu"
    kernels = [
        {"name": "edge_aggregate", "route": "cuda", "source": fwd_src,
         "replaces": REPLACES["edge_aggregate"], "includes": K1,
         "launches": launches["edge_aggregate"] + train_launches["edge_aggregate"]
         + train_launches["edge_aggregate_train"],
         "max_abs_err": max(max_err["edge_aggregate"], train_err["edge_aggregate"]),
         "ms": k2[0], "plain_ms": k2[1], "shape": "B=512 N=150 eval",
         "train_ms": ttimes["train_fwd_30"][0], "train_plain_ms": ttimes["train_fwd_30"][1],
         "train_shape": "B=256 N=30 dropout 0.5"},
        {"name": "edge_aggregate_fn", "route": "cuda", "source": fwd_src,
         "replaces": REPLACES["edge_aggregate_fn"],
         "launches": launches["edge_aggregate_fn"] + train_launches["edge_aggregate_fn"],
         "max_abs_err": max_err["edge_aggregate_fn"], "ms": k4[0], "plain_ms": k4[1],
         "shape": "B=4096 N=30"},
        {"name": "edge_aggregate_bwd", "route": "cuda",
         "source": "mpgan_tpu_torch/csrc/edge_aggregate_bwd.cu",
         "replaces": REPLACES["edge_aggregate_bwd"], "includes": K1,
         "launches": train_launches["edge_aggregate_bwd"]
         + train_launches["edge_aggregate_bwd_no_wgrads"],
         "max_abs_err": train_err["edge_aggregate_bwd"],
         "ms": ttimes["bwd_30"][0], "plain_ms": ttimes["bwd_30"][1],
         "shape": "B=256 N=30 dropout 0.5 with weight gradients",
         "ms_150": ttimes["bwd_150"][0], "plain_ms_150": ttimes["bwd_150"][1]},
    ]
    log("train_step", kernel_ms=step_ms["kernel"], plain_ms=step_ms["plain"])
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
