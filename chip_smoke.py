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
   beside its plain version's.

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
}


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


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device available")
    # the port itself; a directory without the checkout fails here
    from mpgan_tpu_torch.cli import gen
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
    for name, count in launches.items():
        if count == 0:
            raise SystemExit(f"kernel {name} never launched on the main path")

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

    src = "mpgan_tpu_torch/csrc/edge_aggregate.cu"
    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": REPLACES[name],
         "launches": launches[name], "max_abs_err": max_err[name], "ms": t[0], "plain_ms": t[1]}
        for name, t in (("edge_aggregate", k2), ("edge_aggregate_fn", k4))
    ]
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
