"""Rank functions of the mesh tests (``tests/test_torch_mesh*.py``), run by
``mpgan_tpu_torch.parallel.mesh.launch`` in spawned processes: a gloo world
on the CPU, one thread a rank. :func:`run_tasks` makes the mesh and runs a
test module's tasks in turn in that one world (a world's start costs seconds),
returning their results, numpy arrays and losses, which ``launch`` hands back
in rank order. JAX is not imported: the ranks take the JAX state's key words
and draw from them as the JAX step does."""

from __future__ import annotations

import numpy as np
import torch

from mpgan_tpu_torch.ops import prng
from mpgan_tpu_torch.parallel.mesh import make_mesh
from mpgan_tpu_torch.training import optimizers as topt
from mpgan_tpu_torch.training import train_step as tts
from mpgan_tpu_torch.training.sampling import generate_multi_batch
from mpgan_tpu_torch.utils.weights import jax_leaves


def _leaves(module, params):
    return [t.detach().numpy().copy() for t in jax_leaves(module, params)]


def _grads(module):
    return [None if t.grad is None else t.grad.numpy().copy() for t in jax_leaves(module, True)]


def run_tasks(ranks: int, tasks: list[tuple[str, object]]) -> list:
    """``[TASKS[name](mesh, arg) for name, arg in tasks]`` on this rank's mesh."""
    torch.set_num_threads(1)
    mesh = make_mesh(ranks, device_type="cpu")
    return [TASKS[name](mesh, arg) for name, arg in tasks]


def step(mesh, p: dict) -> dict:
    """One D step and one G step on this rank's rows of ``p["data"]``, drawing
    from the JAX state's key ``p["rng"]`` (no draws passed): each rank folds its
    rank into the step's split keys, as the JAX step under ``shard_map`` does."""
    rows = mesh.rows(len(p["data"]))
    g, d, a = p["g"], p["d"], p["opt"]
    opt = lambda m, lr: topt.build_optimizer(a["optimizer"], m.parameters(), lr,  # noqa: E731
                                             beta1=a["beta1"], beta2=a["beta2"])
    state = tts.TrainState(g, d, opt(g, a["lr_gen"]), opt(d, a["lr_disc"]),
                           torch.from_numpy(p["rng"].copy()))
    data = torch.from_numpy(p["data"][rows])
    labels = None if p["labels"] is None else torch.from_numpy(p["labels"][rows])
    cfg = p["step_cfg"]
    out = {}
    parts = tts.d_step(state, cfg, p["spec"], data, labels, mesh=mesh,
                       post_gen=p["post_gen"], encode_real=p["encode_real"])
    out.update({k: v.numpy() for k, v in parts.items()})
    out["d_grads"], out["d_params"] = _grads(d), _leaves(d, True)
    out["rng_d"] = state.rng.numpy().copy()
    out["G"] = tts.g_step(state, cfg, p["spec"], data, labels, mesh=mesh,
                          post_gen=p["post_gen"])["G"].numpy()
    out["g_grads"], out["g_params"] = _grads(g), _leaves(g, True)
    out["rng_g"] = state.rng.numpy().copy()
    out["state"] = _leaves(g, False) + _leaves(d, False)
    out["all"] = [t.detach().numpy().copy() for m in (g, d)
                  for t in (*m.parameters(), *m.buffers())]
    return out


def sample(mesh, p: dict) -> np.ndarray:
    """``generate_multi_batch`` on the mesh."""
    return generate_multi_batch(p["g"], p["spec"], prng.PRNGKey(p["seed"]), p["n"], p["batch"],
                                labels=p["labels"],
                                mesh=mesh, static=p["static"])


def train(mesh, argv: list[str]) -> dict:
    """``cli.train.main(argv)`` on this rank (a process of a world, as under
    ``torchrun``, runs its rank in-process): its losses and the parameters and
    buffers it ends with."""
    from mpgan_tpu_torch.cli import train as ttrain_cli

    t = ttrain_cli.main(["--device", "cpu", *argv])
    assert t.mesh.size == mesh.size and t.device.type == "cpu"
    return {"losses": t.losses, "start_epoch": t.start_epoch, "captures": t.graphs.captures,
            "steps": len(t.graphs.steps),
            "state": [x.detach().numpy().copy() for m in (t.state.g, t.state.d)
                      for x in (*m.parameters(), *m.buffers())]}


def train_mnist(mesh, argv: list[str]) -> dict:
    """``cli.train_mnist.main(argv)`` on this rank."""
    from mpgan_tpu_torch.cli import train_mnist as ttrain_mnist

    t = ttrain_mnist.main(["--device", "cpu", *argv])
    assert t.mesh.size == mesh.size
    return {"losses": t.losses}


def gen(mesh, argv: list[str]) -> None:
    """``cli.gen.main(argv)`` on this rank (rank 0 writes)."""
    from mpgan_tpu_torch.cli import gen as tgen_cli

    tgen_cli.main(["--device", "cpu", *argv])


TASKS = {"step": step, "sample": sample, "train": train, "train_mnist": train_mnist, "gen": gen}
