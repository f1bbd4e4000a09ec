"""Data parallelism over ranks of ``torch.distributed`` (``mpgan_tpu/parallel/mesh.py``).

The JAX package runs one step under ``shard_map`` over a 1-D ``data`` mesh:
every device runs the whole step, its kernels included, on its contiguous
``B/M`` rows of the global batch, and the step ``pmean``s the gradients, the
loss parts and both models' state before the optimizer update
(``mpgan_tpu/training/train_step.py:244-248, 287-291``), so the parameters and
the optimizer states stay replicated. Here a mesh is a world of ``M``
processes, one a rank, each running the same step on its rows, and
:func:`pmean_` is that reduce, written out: one ``all_reduce`` of a flat
float32 bucket, then ``/ M``. ``DistributedDataParallel`` is not used: its
hooks assume one forward and one backward a step and *broadcast* buffers from
rank 0, where the D step runs D twice (three times with the gradient penalty's
double backward), the G step switches D's ``requires_grad`` off, and JAX
*averages* the state.

- :func:`make_mesh` joins (or, for a mesh of one, makes) the world: NCCL where
  every rank has a card of its own, gloo on the CPU or where ranks share a
  card (``devices=``), the gloo reduces then staged through the host;
- :func:`launch` runs a function on every rank: in-process for one rank or
  inside a world that is already set up (``torchrun``: ``WORLD_SIZE`` and
  ``RANK`` in the environment), else in ``M`` spawned processes that meet at a
  ``file://`` rendezvous in a temporary directory;
- :func:`local_path` gives a rank its own keys from the replicated one, JAX's
  ``fold_in(key, rank)`` on each of a step's split keys, as a step of a plan's
  path (the JAX step's ``_localize``).

Not ported: ``jit_step`` (the GSPMD step, which the JAX package's tests alone
use) and ``shard_batch_spec``/``replicated_spec`` (sharding objects of JAX;
here a rank holds the replicated state and slices its rows with
:meth:`Mesh.rows`).
"""

from __future__ import annotations

import atexit
import dataclasses
import inspect
import os
import pickle
import shutil
import tempfile
from typing import Any, Callable, Sequence

import torch
import torch.distributed as dist


# a spawned rank's rendezvous, rank and world size (set by :func:`launch`'s worker)
_INIT_METHOD: str | None = None
_RANK, _WORLD = 0, 1


@dataclasses.dataclass(eq=False)
class Mesh:
    """A 1-D data mesh as one rank sees it: its rank, the number of ranks, its
    device, the process group and its backend."""

    rank: int
    size: int
    device: torch.device
    group: Any
    backend: str
    _buckets: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def rows(self, batch_size: int) -> slice:
        """This rank's contiguous rows of a global batch (``B/M`` of them)."""
        if batch_size % self.size:
            raise ValueError(f"a batch of {batch_size} does not split over {self.size} ranks")
        b = batch_size // self.size
        return slice(self.rank * b, (self.rank + 1) * b)

    def bucket(self, name: str, numel: int, device: torch.device | str) -> torch.Tensor:
        """A flat float32 buffer of ``numel`` elements on ``device``, kept for
        ``name``: the same storage at every call, so that a captured CUDA graph
        reads and writes fixed addresses."""
        key = (name, torch.device(device))
        buf = self._buckets.get(key)
        if buf is None or buf.numel() != numel:
            buf = torch.empty(numel, dtype=torch.float32, device=device)
            self._buckets[key] = buf
        return buf

    def bucket_bytes(self) -> dict[str, int]:
        """The kept buckets' bytes, by name (a step reduces each once)."""
        return {name: b.numel() * b.element_size() for (name, _), b in self._buckets.items()}

    def _staged(self, t: torch.Tensor) -> bool:
        return self.backend == "gloo" and t.is_cuda

    def all_reduce_(self, t: torch.Tensor) -> None:
        """Sum ``t`` over the ranks in place (through the host with gloo on a card)."""
        if self._staged(t):
            host = t.cpu()
            dist.all_reduce(host, group=self.group)
            t.copy_(host)
        else:
            dist.all_reduce(t, group=self.group)

    def broadcast_(self, t: torch.Tensor) -> None:
        """``t`` of rank 0 on every rank, in place."""
        if self._staged(t):
            host = t.cpu()
            dist.broadcast(host, 0, group=self.group)
            t.copy_(host)
        else:
            dist.broadcast(t, 0, group=self.group)

    def all_gather(self, t: torch.Tensor) -> list[torch.Tensor]:
        """Every rank's ``t`` (equal shapes), in rank order."""
        src = t.cpu() if self._staged(t) else t.contiguous()
        out = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(out, src, group=self.group)
        return [o.to(t.device) for o in out]

    def broadcast_object(self, obj: Any) -> Any:
        """Rank 0's ``obj`` (picklable) on every rank."""
        box = [obj]
        dist.broadcast_object_list(box, 0, group=self.group,
                                   device=self.device if self.backend == "nccl" else None)
        return box[0]

    def barrier(self) -> None:
        if self.backend == "nccl":
            dist.barrier(group=self.group, device_ids=[self.device.index])
        else:
            dist.barrier(group=self.group)


def available_devices(device_type: str = "cuda") -> list[torch.device]:
    """The devices a mesh may take: the cards, or one CPU a core."""
    if device_type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")] * (os.cpu_count() or 1)


def in_world() -> bool:
    """Whether this process is a rank of a world set up outside it: by
    ``torchrun`` (``WORLD_SIZE`` and ``RANK`` in the environment) or by
    :func:`launch`."""
    return _INIT_METHOD is not None or ("WORLD_SIZE" in os.environ and "RANK" in os.environ)


def world_rank() -> int:
    """This process's rank in the world it is part of (0 outside any)."""
    if _INIT_METHOD is not None:
        return _RANK
    return int(os.environ.get("RANK", 0)) if in_world() else 0


def _world() -> tuple[str, int, int]:
    """The rendezvous, rank and world size this process joins."""
    if _INIT_METHOD is not None:
        return _INIT_METHOD, _RANK, _WORLD
    if in_world():
        return "env://", int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    return _one_rank_rendezvous(), 0, 1


def _one_rank_rendezvous() -> str:
    """A rendezvous for a world of this process alone, ended at exit: the group
    first (an NCCL group's monitor thread reads the store), then the store."""
    tmp = tempfile.mkdtemp(prefix="mpgan_mesh_")
    atexit.register(shutil.rmtree, tmp, True)
    atexit.register(close)
    return f"file://{tmp}/rendezvous"


def close() -> None:
    """End this process's world, if it has one (a mesh made later starts anew)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def make_mesh(num_devices: int | None = None, devices: Sequence[torch.device] | None = None,
              device_type: str = "cuda") -> Mesh:
    """The 1-D data mesh over the first ``num_devices`` of ``devices`` (default:
    :func:`available_devices` of ``device_type``), as this rank sees it; raises
    ``ValueError`` when more are asked for than there are. A mesh of ``M > 1``
    is made on each rank of an ``M``-rank world (:func:`launch`, ``torchrun``);
    a mesh of one in a process outside any world makes a world of its own.
    Rank ``r`` takes ``devices[r]``. The backend is NCCL when every rank has a
    card of its own, else gloo. An NCCL world binds the rank's card and runs
    one collective, so that its communicator exists before any capture."""
    if devices is None:
        devices = available_devices(device_type)
    devices = [torch.device(d) for d in devices]
    if num_devices is not None:
        if num_devices > len(devices):
            raise ValueError(f"requested a {num_devices}-device mesh but only {len(devices)} "
                             "device(s) are available")
        devices = devices[:num_devices]
    size = len(devices)
    if size == 0:
        raise ValueError("a mesh needs at least one device")
    cards = all(d.type == "cuda" for d in devices)
    backend = "nccl" if cards and len(set(devices)) == size else "gloo"
    if dist.is_initialized():
        rank, world = dist.get_rank(), dist.get_world_size()
        if world != size:
            raise ValueError(f"a {size}-device mesh in a world of {world} ranks")
        if dist.get_backend() != backend:
            raise RuntimeError(f"this process's world runs {dist.get_backend()}, a mesh of "
                               f"{[str(d) for d in devices]} needs {backend}")
    else:
        if size > 1 and not in_world():
            raise RuntimeError(f"a {size}-rank mesh is made on each rank of a {size}-rank "
                               "world: run through mesh.launch or torchrun")
        init, rank, world = _world()
        if world != size:
            raise ValueError(f"a {size}-device mesh in a world of {world} ranks")
        if init.startswith("file://"):
            # the ranks of a file rendezvous share this host: gloo connects them
            # over loopback, not over the address the host name resolves to
            os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        kwargs = {}
        if backend == "nccl" and "device_id" in inspect.signature(
                dist.init_process_group).parameters:
            kwargs["device_id"] = devices[rank]
        dist.init_process_group(backend, init_method=init, rank=rank, world_size=size, **kwargs)
    mesh = Mesh(rank, size, devices[rank], dist.group.WORLD, backend)
    if backend == "nccl":
        torch.cuda.set_device(mesh.device)
        mesh.all_reduce_(torch.zeros(1, device=mesh.device))
        torch.cuda.synchronize(mesh.device)
    return mesh



def pmean_(tensors: Sequence[torch.Tensor | None], mesh: Mesh, name: str = "pmean") -> int:
    """Replace each of ``tensors`` (None skipped) by its mean over the ranks, in
    place: the JAX step's ``pmean`` (``psum / M``). One ``all_reduce`` of the
    kept bucket ``name`` (:meth:`Mesh.bucket`) holding them all as float32, a
    division by ``M``, and the values copied back. Returns the bucket's bytes."""
    tensors = [t for t in tensors if t is not None]
    sizes = [t.numel() for t in tensors]
    bucket = mesh.bucket(name, sum(sizes), tensors[0].device)
    torch.cat([t.detach().reshape(-1).float() for t in tensors], out=bucket)
    mesh.all_reduce_(bucket)
    bucket.div_(mesh.size)
    views = [v.view(t.shape) for v, t in zip(bucket.split(sizes), tensors)]
    with torch.no_grad():
        torch._foreach_copy_([t.detach() for t in tensors], views)
    return bucket.numel() * bucket.element_size()


def broadcast_modules(modules: Sequence[torch.nn.Module], mesh: Mesh) -> None:
    """Rank 0's parameters and buffers in every rank's ``modules``, in place."""
    tensors = [t for m in modules for t in (*m.parameters(), *m.buffers())]
    with torch.no_grad():
        for t in tensors:
            mesh.broadcast_(t.data)


def local_path(mesh: Mesh | None) -> tuple:
    """What a step's split key is folded with on this rank, as a path of children:
    ``(rank,)`` on a mesh (``fold_in(k, rank)`` is child ``rank`` of ``k``), else ``()``.
    A mesh of one draws otherwise than no mesh, as in JAX."""
    return () if mesh is None else (mesh.rank,)


def _worker(rank: int, size: int, tmp: str, call: bytes) -> None:
    global _INIT_METHOD, _RANK, _WORLD
    _INIT_METHOD, _RANK, _WORLD = f"file://{tmp}/rendezvous", rank, size
    torch.set_num_threads(max(1, torch.get_num_threads() // size))
    try:
        fn, args = pickle.loads(call)
        out = fn(*args)
        with open(os.path.join(tmp, f"result_{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        close()


def launch(fn: Callable, size: int, device_type: str, *args) -> list:
    """``fn(*args)`` on every rank of a ``size``-rank world; returns the ranks'
    results in rank order (picklable ones, when they come from spawned ranks).
    ``fn`` makes its mesh itself (:func:`make_mesh`, usually through the
    trainer). In-process for one rank, or when this process is a rank of a
    world already (``torchrun``, whose ``WORLD_SIZE`` must be ``size``): then
    the list holds this rank's result alone. Else ``size`` processes are
    spawned (``torch.multiprocessing.spawn``), meeting at a ``file://``
    rendezvous in a temporary directory; on a card the kernel library is built
    first, so that the ranks load it rather than each running ``nvcc``."""
    if in_world():
        world = _world()[2]
        if world != size:
            raise ValueError(f"--mesh-shape {size} in a world of {world} ranks")
        return [fn(*args)]
    if size <= 1:
        return [fn(*args)]
    if device_type == "cuda":
        from ..ops import _build

        _build.library()
    with tempfile.TemporaryDirectory(prefix="mpgan_launch_") as tmp:
        # pickled here: torch.multiprocessing would share the tensors' memory
        # between the ranks, where each rank must hold a copy of its own
        call = pickle.dumps((fn, args))
        torch.multiprocessing.spawn(_worker, args=(size, tmp, call), nprocs=size, join=True)
        results = []
        for r in range(size):
            with open(os.path.join(tmp, f"result_{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results
