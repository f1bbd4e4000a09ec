"""The mesh on four ranks: NCCL across four cards (``cuda``), or gloo on the CPU
to rehearse (``cpu``). Each rank runs the flagship D+G step at a global B=256
on the mesh and the same step on a gloo group of the CPU (losses and gradients
held within 1e-4, the parameters equal across ranks), and a 5-batch epoch on
the captured graph against the eager epoch, bit for bit; on the cards, the
graph step's wall ms at a global B=1024 (256 a rank) and the all-reduce's
device ms from a profile. Runs write under ``build/mesh4_runs``.

    python3 scripts/torch_mesh4.py cuda    # four cards
    OMP_NUM_THREADS=1 python3 scripts/torch_mesh4.py cpu
"""
import faulthandler
import json
import pathlib
import sys
import time

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402


def rank_fn(device_type, tmp):
    faulthandler.dump_traceback_later(400, exit=True)
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from mpgan_tpu_torch.data.loader import BatchLoader
    from mpgan_tpu_torch.parallel.mesh import Mesh, make_mesh
    from mpgan_tpu_torch.training.config import from_args_dict
    from mpgan_tpu_torch.utils.weights import jax_leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh(4, device_type=device_type)
    dev = mesh.device
    cpu = torch.device("cpu")
    cpu_mesh = Mesh(mesh.rank, 4, cpu, dist.new_group(backend="gloo"), "gloo")
    out = {"rank": mesh.rank, "backend": mesh.backend, "device": str(dev)}
    args = from_args_dict(cs.FLAGSHIP)
    data, labels = cs.real_batch(256)
    rows = mesh.rows(256)
    data, labels = data[rows], labels[rows]
    for side, device, m in (("card", dev, mesh), ("cpu", cpu, cpu_mesh)):
        st = cs.make_state(args, device)
        cs.use_kernels(st, True)
        x, lab = data.to(device), labels.to(device)
        parts = cs.drawn_step(st, args, x, lab, cs.step_draws(args, x, 100 + mesh.rank), m)
        params = jax_leaves(st.d, True) + jax_leaves(st.g, True)
        out[side] = {"losses": {k: v.item() for k, v in parts.items()},
                     "grads": [q.grad.detach().cpu() for q in params],
                     "params": [q.detach().cpu() for q in params]}
    # the captured epoch (NCCL: the all-reduce inside the graph) against the eager one
    args.batch_size = 256
    jets, jlab = cs.graph_data(args, cs.GRAPH_STEPS * 256)
    runs = {}
    for scan in (False, True):
        t = cs.mesh_trainer(args, dev, tmp, f"mesh4_{int(scan)}", scan, mesh)
        loader = BatchLoader(jets, jlab if t.use_labels else None, batch_size=256,
                             shuffle=True, seed=args.seed)
        t.train_epoch(1, loader)
        runs[scan] = t
    same, rel = cs.state_diff(runs[False].state, runs[True].state)
    out["epoch"] = {"bit_identical": same, "max_rel": rel, "captures": runs[True].graphs.captures,
                    "losses_equal": runs[False].losses == runs[True].losses}
    if dev.type == "cuda":
        # the graph step at 256 rows a rank (a global B=1024)
        args.batch_size = 1024
        jets, jlab = cs.graph_data(args, cs.GRAPH_STEPS * 1024)
        t = cs.mesh_trainer(args, dev, tmp, "mesh4_time", True, mesh)
        loader = BatchLoader(jets, jlab if t.use_labels else None, batch_size=1024,
                             shuffle=True, seed=args.seed)
        t.train_epoch(1, loader)
        out["graph_step_ms_b1024"] = [cs.timed_epoch(t, e, loader) for e in (2, 3, 4)]
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t.train_epoch(5, loader)
            torch.cuda.synchronize()
        nccl = busy = 0.0
        for ev in prof.key_averages():
            dt = getattr(ev, "self_device_time_total", None) or getattr(ev, "self_cuda_time_total", 0)
            if dt > 0 and ev.self_cpu_time_total == 0:
                busy += dt / 1e3
                if "nccl" in ev.key.lower():
                    nccl += dt / 1e3
        out["device_ms_per_step"] = busy / len(loader)
        out["nccl_ms_per_step"] = nccl / len(loader)
    return out


if __name__ == "__main__":
    from mpgan_tpu_torch.ops import _build
    from mpgan_tpu_torch.parallel.mesh import launch

    device_type = sys.argv[1] if len(sys.argv) > 1 else "cuda"
    faulthandler.dump_traceback_later(700, exit=True)
    print(sys.version, torch.__version__, torch.version.cuda, flush=True)
    if device_type == "cuda":
        print(cs.card_line(), torch.cuda.device_count(), flush=True)
        t0 = time.time()
        _build.library()
        print("build_s", time.time() - t0, flush=True)
    tmp = pathlib.Path("build/mesh4_runs")
    tmp.mkdir(parents=True, exist_ok=True)
    t0 = time.time()
    ranks = launch(rank_fn, 4, device_type, device_type, tmp)
    print("launch_s", time.time() - t0, flush=True)
    bad = []
    for r in ranks:
        c, h = r["card"], r["cpu"]
        loss_err = max(abs(c["losses"][k] - h["losses"][k]) / max(1.0, abs(h["losses"][k]))
                       for k in h["losses"])
        grad_ok = all(ok for _, ok in (cs.wgrad_err(a, b) for a, b in zip(c["grads"], h["grads"])))
        summary = {k: v for k, v in r.items() if k not in ("card", "cpu")}
        summary.update(max_rel_loss_err=loss_err, grads_within_tol=grad_ok,
                       losses_card=c["losses"], losses_cpu=h["losses"])
        print(json.dumps(summary), flush=True)
        if loss_err > cs.TOL or not grad_ok or not r["epoch"]["bit_identical"]:
            bad.append(r["rank"])
    same = all(torch.equal(a, b) for r in ranks[1:] for side in ("card", "cpu")
               for a, b in zip(ranks[0][side]["params"], r[side]["params"]))
    print(json.dumps({"params_equal_across_ranks": same, "bad_ranks": bad}), flush=True)
    print("MESH4 OK" if same and not bad else "MESH4 FAILED", flush=True)
