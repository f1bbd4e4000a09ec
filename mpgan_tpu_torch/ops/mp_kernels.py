"""Dense message-passing edge kernels: plain PyTorch versions and CUDA wrappers.

Counterpart of ``mpgan_tpu/ops/mp_pallas.py``. Each function has a plain
version and a wrapper around a hand-written Hopper kernel (the forward
``csrc/edge_aggregate.cu`` and the backward ``csrc/edge_aggregate_bwd.cu``, both
on the pass and products of ``csrc/edge_products.cuh``):

- ``edge_aggregate`` (K2 forward): ``agg[b, i] = sum_j mask[b, j] *
  chain(leaky(u1[b, i] + u2[b, j]))``, divided by ``n`` for the mean, where
  ``chain`` is the fe MLP's hidden layers ``hidden_flat = (w2, b2, w3, b3,
  ...)`` with weights ``[in, out]`` and LeakyReLU after each. The fe first-layer
  bias and any per-jet conditioning are folded into ``u2`` by the caller. With
  ``dropout_p > 0`` (train mode) each activation is multiplied by the K1 hash
  multiplier (``_dropmul``) after layer 1's LeakyReLU and after each hidden
  layer.
- ``edge_aggregate_bwd`` (K3): the backward of K2. It recomputes the chain,
  replays the dropout masks and returns ``du1, du2, dmask`` and the hidden
  layers' weight and bias gradients (zeros with ``need_wgrads=False``).
- ``edge_aggregate_fn`` (K4, eval only): the K2 aggregate followed by the
  node MLP on ``[agg | x]``; ``fn_flat = (w1_top, w1_bot, b1, w2, b2, ...)``
  with fn's first layer split along its ``[agg | x]`` input rows.
- :class:`EdgeAggregate`: the autograd ``Function`` of K2 forward and K3
  backward. It launches K3 without the weight contractions when no hidden
  weight needs a gradient (the G step through D).
- :class:`EdgeAggregateFn`: K4 forward; its backward recomputes K2 and runs
  fn in torch, K3 as K2's backward, as the JAX custom VJP does.

K1 (``mp_pallas._dropmul``) keys each element on a global pair id, the feature
column, the layer salt (0 for layer 1, k for hidden layer k) and an integer
seed. The kernels read the seed from device memory, as the TPU kernel reads
``seed_ref[0]``, so a launch captured in a CUDA graph draws fresh masks from
whatever seed its buffer holds at a replay: every function that takes a
``seed`` takes a one-element int32 tensor (a key slot, :class:`.keys.KeySlots`)
or a Python int in ``[0, 2**31)``, and both give the same masks. The dense kernels' ids are ``b*n*ns + i*ns + j`` with ``ns =
ceil(n/8)*8`` (the TPU kernel's sender padding, kept in the ids though nothing
is padded here); the knn kernels of :mod:`.knn_kernels` use ``b*n*k + i*k + s``
with the unpadded ``n`` and the neighbour's extraction rank ``s``.

Each takes all-float32 tensors, or all-bf16 ones for the bf16 mode
(``StepConfig.bf16``; the Pallas kernels called with bf16 refs): the hidden
products on bf16-rounded activations and bf16 weights with float32
accumulation, everything around them in float32, the outputs rounded to bf16
once (K3: its backward's products in float32, the weight gradients summed in
float32 and rounded to bf16). On the card the bf16 mode has kernels of its own
(``csrc/edge_aggregate_bf16.cu``, ``edge_aggregate_bwd_bf16.cu``: the products
on tensor cores) and launch counts of its own (``*_bf16``).

The launches are planned here (:func:`fwd_plan`, :func:`bwd_plan`: the pass
shape, the items of the persistent grid, the grid; :func:`bf16_tile_plan` for
the bf16 mode's forward pass, ``csrc/edge_fwd_bf16_tiles.cuh``), so that the
planning is tested where there is no card. A wrapper runs the plain version for tensors on
the CPU, and the kernel for tensors on a CUDA device; anything else raises. ``launch_counts`` counts kernel
launches (the knn kernels' too), so a run can show that it went through the
kernels. A launch inside a CUDA-graph capture runs nothing: :class:`CountedGraph`
takes the counts its capture added back and adds them again at every replay, so
the counts stay the launches that ran.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import weakref
from typing import Any, Callable, Sequence

import torch
from torch.autograd.function import once_differentiable

from . import _build
from .prng import launch_counts as threefry_counts
from .linear import _M32, _hash_keys, _i32, dropout_threshold_mult, hash_mult

MAX_WIDTH = 256  # widest layer the kernels hold in shared memory
MAX_LAYERS = 8

launch_counts = {
    "edge_aggregate": 0,            # K2, eval (no dropout)
    "edge_aggregate_train": 0,      # K2 with in-kernel dropout
    "edge_aggregate_fn": 0,         # K4
    "edge_aggregate_bwd": 0,        # K3 with weight gradients
    "edge_aggregate_bwd_no_wgrads": 0,  # K3 without them
    "knn_fused_layer": 0,           # K5 without residuals (no gradient needed)
    "knn_fused_layer_train": 0,     # K5 emitting idx (and dists) for the backward
    "knn_edge_aggregate_bwd": 0,    # K6 with weight gradients
    "knn_edge_aggregate_bwd_no_wgrads": 0,  # K6 without them
    "knn_search": 0,                # K7
    "knn_edge_aggregate": 0,        # K8
    "gapt_g_fused": 0,              # K9
    # the bf16 mode (bf16 inputs and weights, StepConfig.bf16) of K2, K4 and K3
    "edge_aggregate_bf16": 0,
    "edge_aggregate_train_bf16": 0,
    "edge_aggregate_fn_bf16": 0,
    "edge_aggregate_bwd_bf16": 0,
    "edge_aggregate_bwd_no_wgrads_bf16": 0,
    # the bf16 mode of K5-K9 (K9: bf16 inputs widened to its float32 body)
    "knn_fused_layer_bf16": 0,
    "knn_fused_layer_train_bf16": 0,
    "knn_edge_aggregate_bwd_bf16": 0,
    "knn_edge_aggregate_bwd_no_wgrads_bf16": 0,
    "knn_search_bf16": 0,
    "knn_edge_aggregate_bf16": 0,
    "gapt_g_fused_bf16": 0,
}


# every count a graph's capture and replays account for: these kernels' and the
# PRNG's (``prng.launch_counts``, ``threefry_draws``)
_COUNTS = (launch_counts, threefry_counts)


def reset_launch_counts() -> None:
    """Set the kernels' counts, the PRNG's among them, to 0."""
    for counts in _COUNTS:
        for k in counts:
            counts[k] = 0


class CountedGraph:
    """``body`` captured once into a CUDA graph (``torch.cuda.CUDAGraph``, in
    the memory ``pool`` when given), with replay accounting for
    ``launch_counts`` and the PRNG's ``threefry_draws`` count: the launches the
    capture counted are taken back (nothing ran) and kept in ``launches``, and
    every :meth:`replay` adds them. ``out``
    is what ``body`` returned. A capture error raises.

    ``graph`` may be another object with ``capture()`` (a context manager) and
    ``replay()``, so the accounting is tested where there is no card."""

    def __init__(self, body: Callable[[], Any], pool=None, graph=None):
        self.graph = graph if graph is not None else torch.cuda.CUDAGraph()
        self.pool = pool
        before = [dict(counts) for counts in _COUNTS]
        if isinstance(self.graph, torch.cuda.CUDAGraph):
            capture = torch.cuda.graph(self.graph, pool=pool)
        else:
            capture = self.graph.capture()
        try:
            with capture:
                self.out = body()
        finally:
            self.launches = {k: counts[k] - old[k] for counts, old in zip(_COUNTS, before)
                             for k in counts if counts[k] != old[k]}
            for counts, old in zip(_COUNTS, before):
                counts.update(old)
        _LIVE_GRAPHS.add(self)

    def replay(self) -> None:
        self.graph.replay()
        for counts in _COUNTS:
            for k in counts.keys() & self.launches.keys():
                counts[k] += self.launches[k]


def warm_up(fn: Callable[[], Any], device: torch.device) -> Any:
    """``fn()`` on a side stream ordered after the current one and before its
    next work: the run torch.cuda.graphs asks for before a capture. A tensor
    it returns is marked as used by the current stream."""
    main = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(main)
    with torch.cuda.stream(side):
        out = fn()
    main.wait_stream(side)
    if isinstance(out, torch.Tensor):
        out.record_stream(main)
    return out


_GRAPH_POOL = None
_LIVE_GRAPHS: "weakref.WeakSet[CountedGraph]" = weakref.WeakSet()


def graph_pool():
    """The memory pool that the port's live CUDA graphs share
    (``torch.cuda.graph_pool_handle()``): the train steps' and the samplers'.
    A graph's replay is followed by its consumer before another graph runs, so
    their temporaries may share memory. Once no graph of the pool is alive the
    allocator releases the pool (when the tensors made in it are gone too) and
    does not take its handle again: the next capture gets a new one."""
    global _GRAPH_POOL
    if _GRAPH_POOL is None or not any(g.pool == _GRAPH_POOL for g in _LIVE_GRAPHS):
        _GRAPH_POOL = torch.cuda.graph_pool_handle()
    return _GRAPH_POOL


def _leaky(x: torch.Tensor, alpha: float) -> torch.Tensor:
    return torch.where(x >= 0, x, alpha * x)


def _dleaky(x: torch.Tensor, alpha: float) -> torch.Tensor:
    return torch.where(x >= 0, torch.ones_like(x), torch.full_like(x, alpha))


def _pairs(hidden_flat: Sequence[torch.Tensor]) -> list[tuple[torch.Tensor, torch.Tensor]]:
    return [(hidden_flat[2 * k], hidden_flat[2 * k + 1]) for k in range(len(hidden_flat) // 2)]


def pad_senders(n: int) -> int:
    """The sender count the dropout ids are laid out on (``mp_pallas._pad_senders``)."""
    return (n + 7) // 8 * 8


def pair_ids(b: int, n: int, device) -> torch.Tensor:
    """``[B, N, N, 1]`` global pair ids ``b*n*ns + i*ns + j`` mod 2**32, as
    int32 bit patterns."""
    ns = pad_senders(n)
    ar = lambda m: torch.arange(m, dtype=torch.int64, device=device)  # noqa: E731
    ids = ar(b)[:, None, None] * (n * ns) + ar(n)[None, :, None] * ns + ar(n)[None, None, :]
    return (((ids + 2**31) & _M32) - 2**31).to(torch.int32)[..., None]


def _seed_key(seed, salt: int):
    """K1's key ``seed * 0xC2B2AE3D + salt * 0x27D4EB2F`` as int32 bits: an int
    for an int seed, a one-element int32 tensor for a seed tensor (int32
    arithmetic wraps like uint32, so both give the same bits)."""
    if isinstance(seed, torch.Tensor):
        return seed * _i32(0xC2B2AE3D) + _i32(salt * 0x27D4EB2F)
    return _i32(seed * 0xC2B2AE3D + salt * 0x27D4EB2F)


def _dropmul(ids: torch.Tensor, cols: int, p: float, seed, salt: int) -> torch.Tensor:
    """K1 (``mp_pallas._dropmul``): the float32 dropout multiplier for pair ids
    ``ids`` (``[..., 1]``, from :func:`pair_ids`) and columns ``0..cols-1``;
    shape ``ids.shape[:-1] + (cols,)``. ``seed``: an int or a one-element int32
    tensor."""
    _, ckey = _hash_keys(1, cols, str(ids.device))
    return hash_mult(ids * _i32(0x9E3779B1) + _seed_key(seed, salt) + ckey, p, torch.float32)


def _is_bf16(*tensors: torch.Tensor) -> bool:
    """True for all-bfloat16 tensors (the bf16 mode), False for all-float32
    (or all-float64 on the CPU: the plain versions' FP32 mode run in float64);
    raises on anything else or a mix."""
    dtypes = {t.dtype for t in tensors}
    if dtypes == {torch.bfloat16}:
        return True
    if dtypes == {torch.float32} or (dtypes == {torch.float64}
                                     and all(t.device.type == "cpu" for t in tensors)):
        return False
    raise TypeError(f"the kernels take all-float32 or all-bfloat16 tensors, got "
                    f"{sorted(map(str, dtypes))}")


def _bf16_operand(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bfloat16 and held in float32: the operand the bf16 mode
    feeds a product. Products of bf16 values are exact in float32, so a float32
    matmul of such operands is the bf16 product with float32 accumulation."""
    return t.to(torch.bfloat16).float()


def _chain_recompute(u1, u2, hidden_flat, alpha, dropout_p, seed):
    """Pre-activations ``z_l``, activations ``a_l`` (after dropout) and the
    dropout multipliers of every layer of the edge chain, ``[B, N, N, H_l]``.
    bf16 inputs (the bf16 mode, ``mp_pallas._split_mlp_chain``): everything is
    float32 but each hidden product's operand, rounded to bf16 (the stored
    activations are not)."""
    pairs = _pairs(hidden_flat)
    bf16 = u1.dtype == torch.bfloat16
    if bf16:
        u1, u2 = u1.float(), u2.float()
        pairs = [(w.float(), b.float()) for w, b in pairs]
    ids = pair_ids(u1.shape[0], u1.shape[1], u1.device) if dropout_p > 0 else None
    zs, acts, mults = [], [], []
    z = u1[:, :, None, :] + u2[:, None, :, :]
    for salt in range(len(pairs) + 1):
        if salt:
            w, b = pairs[salt - 1]
            z = torch.matmul(_bf16_operand(acts[-1]) if bf16 else acts[-1], w) + b
        a = _leaky(z, alpha)
        m = _dropmul(ids, z.shape[-1], dropout_p, seed, salt) if dropout_p > 0 else None
        zs.append(z)
        mults.append(m)
        acts.append(a if m is None else a * m)
    return zs, acts, mults


def _edge_aggregate_f32(u1, u2, mask, hidden_flat, alpha, sum_agg, dropout_p, seed):
    """The K2 aggregate in float32 (bf16 inputs: the bf16 mode's, unrounded)."""
    _, acts, _ = _chain_recompute(u1, u2, hidden_flat, alpha, dropout_p, seed)
    a = acts[-1] * mask.float()[:, None, :, :]
    return a.sum(dim=2) if sum_agg else a.sum(dim=2) / u1.shape[1]


def edge_aggregate_reference(u1, u2, mask, hidden_flat, alpha: float, sum_agg: bool,
                             dropout_p: float = 0.0, seed: int = 0):
    """Plain PyTorch version of the K2 forward (``mp_pallas.edge_aggregate_reference``,
    plus the in-kernel dropout of ``_fwd_kernel``). bf16 inputs select the bf16
    mode (``_fwd_kernel`` on bf16 refs): the chain as :func:`_chain_recompute`
    rounds it, the masked sum and the mean in float32, the output rounded to
    bf16 once."""
    if _is_bf16(u1, u2, mask, *hidden_flat):
        agg = _edge_aggregate_f32(u1, u2, mask, hidden_flat, alpha, sum_agg, dropout_p, seed)
        return agg.to(torch.bfloat16)
    _, acts, _ = _chain_recompute(u1, u2, hidden_flat, alpha, dropout_p, seed)
    a = acts[-1] * mask[:, None, :, :]
    return a.sum(dim=2) if sum_agg else a.mean(dim=2)


def edge_aggregate_bwd_reference(u1, u2, mask, hidden_flat, g, alpha: float, sum_agg: bool,
                                 dropout_p: float = 0.0, seed: int = 0,
                                 need_wgrads: bool = True):
    """Plain PyTorch version of K3 (``mp_pallas._bwd_kernel``): recompute the
    chain, replay the dropout masks, backprop. Returns ``(du1, du2, dmask,
    dhidden_flat)``; the hidden gradients are zeros without ``need_wgrads``.
    bf16 inputs select the bf16 mode: the recompute rounds as the forward's,
    the backward runs in float32 (dW on the unrounded activations, da on the
    float32 values of the bf16 weights), du1, du2 and dmask are rounded to
    bf16 once, the weight gradients summed in float32 and then rounded to the
    weights' dtype (``mp_pallas._edge_aggregate_bwd``)."""
    bf16 = _is_bf16(u1, u2, mask, g, *hidden_flat)
    out_dtype = u1.dtype
    pairs = _pairs(hidden_flat)
    zs, acts, mults = _chain_recompute(u1, u2, hidden_flat, alpha, dropout_p, seed)
    if bf16:
        g, mask = g.float(), mask.float()
        pairs = [(w.float(), b.float()) for w, b in pairs]
    if not sum_agg:
        g = g / u1.shape[1]
    dmask = (acts[-1] * g[:, :, None, :]).sum(dim=(1, 3))[..., None]
    da = g[:, :, None, :] * mask[:, None, :, :]
    dhidden = [torch.zeros_like(t) for t in hidden_flat]
    for layer in range(len(pairs), -1, -1):
        if mults[layer] is not None:
            da = da * mults[layer]
        dz = da * _dleaky(zs[layer], alpha)
        if layer == 0:
            break
        w = pairs[layer - 1][0]
        if need_wgrads:
            a_in = acts[layer - 1]
            dw = torch.matmul(a_in.reshape(-1, a_in.shape[-1]).t(), dz.reshape(-1, dz.shape[-1]))
            db = dz.sum(dim=(0, 1, 2))
            dhidden[2 * (layer - 1)] = dw.to(out_dtype)
            dhidden[2 * (layer - 1) + 1] = db.to(out_dtype)
        da = torch.matmul(dz, w.t())
    du1, du2 = dz.sum(dim=2), dz.sum(dim=1)
    if bf16:
        du1, du2, dmask = (t.to(out_dtype) for t in (du1, du2, dmask))
    return du1, du2, dmask, tuple(dhidden)


def _fn_chain(agg, x, fn_flat, fn_alpha: float, fn_final_linear: bool, bf16: bool = False):
    """fn on ``[agg | x]`` with its first layer split. ``bf16``: float32 ``agg``
    and bf16 ``x`` and weights (``mp_pallas._fn_tail``): the first layer takes
    float32 operands, later layers bf16-rounded ones, every sum float32."""
    num_layers = (len(fn_flat) - 3) // 2 + 1
    if bf16:
        x = x.float()
        fn_flat = [t.float() for t in fn_flat]

    def act(i: int) -> bool:
        return i != num_layers - 1 or not fn_final_linear

    z = torch.matmul(agg, fn_flat[0]) + torch.matmul(x, fn_flat[1]) + fn_flat[2]
    if act(0):
        z = _leaky(z, fn_alpha)
    for layer, (w, b) in enumerate(_pairs(fn_flat[3:])):
        z = torch.matmul(_bf16_operand(z) if bf16 else z, w) + b
        if act(layer + 1):
            z = _leaky(z, fn_alpha)
    return z.to(torch.bfloat16) if bf16 else z


def edge_aggregate_fn_reference(
    u1, u2, mask, hidden_flat, x, fn_flat, alpha: float, sum_agg: bool,
    fn_alpha: float, fn_final_linear: bool,
):
    """Plain PyTorch version of K4: the K2 aggregate, then fn on ``[agg | x]``
    with its first layer decomposed (``mp_pallas._edge_fn_composed``). bf16
    inputs select the bf16 mode (``_fwd_kernel_jets_fn``): the aggregate stays
    float32 into fn (see :func:`_fn_chain`), the output is rounded to bf16."""
    if _is_bf16(u1, u2, mask, x, *hidden_flat, *fn_flat):
        agg = _edge_aggregate_f32(u1, u2, mask, hidden_flat, alpha, sum_agg, 0.0, 0)
        return _fn_chain(agg, x, fn_flat, fn_alpha, fn_final_linear, bf16=True)
    agg = edge_aggregate_reference(u1, u2, mask, hidden_flat, alpha, sum_agg)
    return _fn_chain(agg, x, fn_flat, fn_alpha, fn_final_linear)


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------


def _on_cpu(*tensors: torch.Tensor) -> bool:
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on different devices: {sorted(map(str, devices))}")
    device = devices.pop()
    if device.type == "cpu":
        return True
    if device.type != "cuda":
        raise ValueError(f"no kernel for device {device}")
    return False


def _check_cuda_args(name: str, tensors: dict[str, torch.Tensor],
                     weights: Sequence[torch.Tensor], dtype: torch.dtype = torch.float32) -> None:
    for k, t in tensors.items():
        if t.dtype != dtype:
            raise TypeError(f"{name}: {k} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {k} must be contiguous")
    # the kernels read 4 weight columns as one 128-bit load
    if any(w.data_ptr() % 16 for w in weights):
        raise ValueError(f"{name}: weights must start on a 16-byte boundary")


def _chain_dims(name: str, what: str, dims: list[int], pairs) -> list[int]:
    """Extend ``dims`` with the output width of each ``(w [in, out], b)`` layer,
    raising where a layer does not take the previous width; checks the caps."""
    for w, b in pairs:
        if w.dim() != 2 or w.shape[0] != dims[-1] or b.shape != (w.shape[1],):
            raise ValueError(f"{name}: {what} layer shapes {tuple(w.shape)}, {tuple(b.shape)} "
                             f"do not chain from width {dims[-1]}")
        dims.append(w.shape[1])
    if any(d > MAX_WIDTH for d in dims):
        raise ValueError(f"{name}: layer widths {dims} exceed the kernel cap {MAX_WIDTH}")
    if len(dims) - 1 > MAX_LAYERS:
        raise ValueError(f"{name}: {len(dims) - 1} layers exceed the kernel cap {MAX_LAYERS}")
    return dims


def _chain_args(pairs):
    """ctypes arrays of a layer chain's weight and bias pointers."""
    n = len(pairs)
    w = (ctypes.c_void_p * max(n, 1))(*[p[0].data_ptr() for p in pairs])
    b = (ctypes.c_void_p * max(n, 1))(*[p[1].data_ptr() for p in pairs])
    return w, b


def _check_edge_shapes(name, u1, u2, mask, pairs):
    if u1.dim() != 3 or u2.shape != u1.shape:
        raise ValueError(f"{name}: u1 {tuple(u1.shape)} and u2 {tuple(u2.shape)} must be [B, N, H1]")
    if mask.shape != (*u1.shape[:2], 1):
        raise ValueError(f"{name}: mask {tuple(mask.shape)} must be [B, N, 1]")
    return _chain_dims(name, "hidden", [u1.shape[2]], pairs)


def _check_dropout(name: str, dropout_p: float, seed) -> None:
    """The rate, and an int seed's range; a seed tensor's value is not read, since
    that would wait for the device (the keys' seeds lie in [0, 2**30] by
    construction: ``prng.edge_seed_of``)."""
    if not 0.0 <= dropout_p < 1.0:
        raise ValueError(f"{name}: dropout_p {dropout_p} outside [0, 1)")
    if dropout_p <= 0:
        return
    if isinstance(seed, torch.Tensor):
        if seed.dtype != torch.int32 or seed.numel() != 1:
            raise TypeError(f"{name}: a seed tensor must hold one int32, got {seed.dtype} "
                            f"{tuple(seed.shape)}")
    elif not 0 <= int(seed) < 2**31:
        raise ValueError(f"{name}: dropout seed {seed} outside [0, 2**31)")


def seed_arg(name: str, seed, device: torch.device) -> torch.Tensor:
    """The seed as the one-element int32 tensor on ``device`` that a kernel
    reads: a seed tensor as it is, an int written there by a fill (no host
    copy, so the host does not wait)."""
    if isinstance(seed, torch.Tensor):
        if seed.device != device:
            raise ValueError(f"{name}: seed on {seed.device}, the inputs on {device}")
        return seed.contiguous()
    return torch.full((1,), int(seed), dtype=torch.int32, device=device)


def edge_aggregate(u1, u2, mask, hidden_flat, alpha: float, sum_agg: bool,
                   dropout_p: float = 0.0, seed=0):
    """K2 forward: the plain version on the CPU, the CUDA kernel on a GPU; all
    inputs float32, or all bf16 for the bf16 mode (its own kernel and count)."""
    hidden_flat = tuple(hidden_flat)
    bf16 = _is_bf16(u1, u2, mask, *hidden_flat)
    name = ("edge_aggregate_train" if dropout_p > 0 else "edge_aggregate") + \
        ("_bf16" if bf16 else "")
    _check_dropout(name, dropout_p, seed)
    if _on_cpu(u1, u2, mask, *hidden_flat):
        return edge_aggregate_reference(u1, u2, mask, hidden_flat, alpha, sum_agg,
                                        dropout_p, seed)
    pairs = _pairs(hidden_flat)
    dims = _check_edge_shapes(name, u1, u2, mask, pairs)
    _check_cuda_args(name, {"u1": u1, "u2": u2, "mask": mask,
                            **{f"hidden[{i}]": t for i, t in enumerate(hidden_flat)}},
                     hidden_flat[::2], u1.dtype)
    b_sz, n, h1 = u1.shape
    out = torch.empty((b_sz, n, dims[-1]), dtype=u1.dtype, device=u1.device)
    if bf16:
        plan16 = bf16_tile_plan(b_sz, n, dims, _sm_count(u1.device))
    else:
        plan = fwd_plan(b_sz, n, dims, _sm_count(u1.device))
    # the kernel's own copy of the weights, laid out for its products
    packed_floats = fwd_packed_floats_bf16(dims) if bf16 else fwd_packed_floats(dims, plan.rows)
    packed = torch.empty((max(packed_floats, 1),), dtype=torch.float32, device=u1.device)
    lib = _build.library()
    w, b = _chain_args(pairs)
    dim_arr = (ctypes.c_int * len(dims))(*dims)
    with torch.cuda.device(u1.device):
        stream = torch.cuda.current_stream().cuda_stream
        ptrs = (u1.data_ptr(), u2.data_ptr(), mask.data_ptr(), out.data_ptr(), packed.data_ptr())
        if bf16:
            thr, mult = dropout_threshold_mult(dropout_p) if dropout_p > 0 else (0, 1.0)
            seed_t = seed_arg(name, seed, u1.device) if dropout_p > 0 else None
            code = lib.mpgan_edge_aggregate_bf16(
                *ptrs, packed_floats, b_sz, n, h1, len(pairs), w, b, dim_arr, float(alpha),
                int(bool(sum_agg)), int(dropout_p > 0),
                None if seed_t is None else seed_t.data_ptr(), thr, mult, plan16.width,
                plan16.warps, int(plan16.resident), plan16.ti, plan16.jc, plan16.grid, stream,
            )
            _build.check(code, name)
            launch_counts[name] += 1
            return out
        shape = (plan.ti, plan.jc, plan.rows, plan.grid, plan.slab_floats, stream)
        if dropout_p > 0:
            thr, mult = dropout_threshold_mult(dropout_p)
            seed_t = seed_arg(name, seed, u1.device)
            code = lib.mpgan_edge_aggregate_train(
                *ptrs, b_sz, n, h1, len(pairs), w, b, dim_arr, float(alpha), int(bool(sum_agg)),
                seed_t.data_ptr(), thr, mult, *shape,
            )
        else:
            code = lib.mpgan_edge_aggregate(
                *ptrs, b_sz, n, h1, len(pairs), w, b, dim_arr, float(alpha), int(bool(sum_agg)),
                *shape,
            )
    _build.check(code, name)
    launch_counts[name] += 1
    return out


# The backward kernels' plan (csrc/edge_bwd_common.cuh), made here so that it is
# tested where there is no card; the launchers check it and lay out the buffers.
BWD_THREADS = 512
BWD_SLAB_FLOATS = 4096  # each of the two weight k-slab buffers
BWD_ROW_ARRAYS = 10
MAX_SMEM_BYTES = 227 * 1024


@dataclasses.dataclass(frozen=True)
class BwdPlan:
    """One launch of K3 or K6: a pass is ``ti`` receivers x ``jc`` senders (knn:
    neighbour ranks) in buffers of ``rows`` pair rows; an item is a block of
    ``ti`` receivers of a jet (``blocks`` a jet); ``grid`` CTAs each walk a
    contiguous range of the ``items``; a jet's sender gradients are summed over
    ``slots`` slabs, one per CTA that touches the jet."""
    ti: int
    jc: int
    rows: int
    blocks: int
    items: int
    grid: int
    slots: int
    smem_bytes: int

    def item_range(self, cta: int) -> tuple[int, int]:
        return cta * self.items // self.grid, (cta + 1) * self.items // self.grid

    def item_owner(self, item: int) -> int:
        return ((item + 1) * self.grid - 1) // self.items

    def slabs_of_jet(self, b: int) -> int:
        """How many CTAs touch jet ``b``: the slabs its reduction sums."""
        return (self.item_owner((b + 1) * self.blocks - 1)
                - self.item_owner(b * self.blocks) + 1)


def bwd_smem_bytes(dims: Sequence[int], rows: int) -> int:
    """Shared memory of a pass of ``rows`` pair rows through the chain ``dims``:
    a_1..a_{L-1}, one buffer for a_0 and dz_L in turn (two with a single hidden
    layer), the weight slabs, the last layer's partial row sums and the per-row
    arrays."""
    n_layers = len(dims) - 1
    if n_layers >= 2:
        width = max(dims[0], dims[-1]) + sum(dims[1:-1])
    else:
        width = sum(dims)
    ldr = rows + 4
    col_warps = (BWD_THREADS // 32) // (rows // 32)
    return 4 * (width * ldr + 2 * BWD_SLAB_FLOATS + (col_warps + BWD_ROW_ARRAYS) * ldr)


def bwd_packed_floats(dims: Sequence[int], rows: int) -> int:
    """Floats of the packed copy of the chain's weights that a launch makes: per
    hidden layer W and W^T, each row padded to a whole number of columns for
    every column thread of the products."""
    col_threads = 8 * ((BWD_THREADS // 32) // (rows // 32))
    tn = lambda m: -(-m // col_threads)  # noqa: E731
    return sum((k * tn(m) + m * tn(k)) * col_threads for k, m in zip(dims[:-1], dims[1:]))


def bwd_wslab_floats(dims: Sequence[int], n_extra: int = 0) -> int:
    """Floats of one CTA's weight-gradient partials: per hidden layer dW in tiles
    of 32 x 32 (padded) and db (padded to 4), then ``n_extra`` (knn: dw_d)."""
    pad4 = lambda v: -(-v // 4) * 4  # noqa: E731
    return sum(-(-k // 32) * -(-m // 32) * 1024 + pad4(m)
               for k, m in zip(dims[:-1], dims[1:])) + pad4(n_extra)


def _pass_cost(dims: Sequence[int], rows: int) -> int:
    """FMAs a thread issues in one pass: every product gives a thread 8 rows by
    ceil(M / column threads) columns; the contractions share K x M x rows."""
    col_threads = 8 * ((BWD_THREADS // 32) // (rows // 32))
    tn = lambda m: -(-m // col_threads)  # noqa: E731
    cost = sum(8 * (tn(m) * k + tn(k) * m) + rows * k * m // BWD_THREADS
               for k, m in zip(dims[:-1], dims[1:]))
    return max(cost, 1)


def bwd_plan(batch: int, n_recv: int, n_send: int, dims: Sequence[int], sms: int) -> BwdPlan:
    """Plan a backward launch over ``batch`` jets of ``n_recv`` receivers with
    ``n_send`` senders (knn: ``k`` ranks) each, on a card with ``sms`` SMs. The
    pass is the one that gives the busiest CTA the least arithmetic among those
    that fit in shared memory (ties: longer sender chunks, then more receivers).
    A step launches the same few shapes over and over: the search runs once a shape."""
    return _bwd_plan(batch, n_recv, n_send, tuple(dims), sms)


@functools.lru_cache(maxsize=256)
def _bwd_plan(batch: int, n_recv: int, n_send: int, dims: tuple, sms: int) -> BwdPlan:
    best = None
    for rows in (128, 64, 32):
        smem = bwd_smem_bytes(dims, rows)
        if smem > MAX_SMEM_BYTES:
            continue
        per_pass = _pass_cost(dims, rows)
        for jc in range(1, min(n_send, rows) + 1):
            ti = min(n_recv, rows // jc)
            # the busiest CTA's passes: its items, each walking the sender chunks
            items = batch * -(-n_recv // ti)
            cost = -(-items // min(sms, items)) * -(-n_send // jc) * per_pass
            key = (cost, -jc, -ti)
            if best is None or key < best[0]:
                best = (key, ti, jc, rows, smem)
    if best is None:
        raise ValueError(f"layer widths {list(dims)} do not fit the backward kernel's "
                         f"shared memory ({MAX_SMEM_BYTES} bytes) even at 32 pair rows")
    _, ti, jc, rows, smem = best
    blocks = -(-n_recv // ti)
    items = batch * blocks
    grid = max(1, min(sms, items))
    per_cta = items // grid  # the shortest range
    slots = min(blocks, -(-(blocks - 1) // per_cta) + 1)
    return BwdPlan(ti, jc, rows, blocks, items, grid, slots, smem)


FWD_ROW_ARRAYS = 4  # u1, u2, id, mask
FWD_TAB_FLOATS = 2 * MAX_LAYERS * 6  # the kernel's layer table: 16 entries of 24 bytes
FWD_SLAB_FLOATS = (16384, 12288, 8192)  # weight slab sizes the forward tries before the least


@dataclasses.dataclass(frozen=True)
class FwdPlan:
    """One launch of K2 or K4: a pass is ``ti`` receivers x ``jc`` senders in
    buffers of ``rows`` pair rows, a receiver taking ``rs = max(jc, 8)`` of them.
    An item is ``span`` consecutive receivers of the batch's flat receiver list
    ``b * n + i`` (K2: ``ti``; K4: a multiple of ``ti``, at most ``rows``, whose
    rows fn then takes at once), walked ``ti`` at a time over the senders of each
    receiver's own jet in chunks of ``jc``; ``grid`` CTAs each walk a contiguous
    range of the ``items``. The two weight slab buffers hold ``slab_floats``
    each."""
    ti: int
    jc: int
    rows: int
    span: int
    items: int
    grid: int
    smem_bytes: int
    slab_floats: int

    @property
    def rs(self) -> int:
        return max(self.jc, 8)

    def item_range(self, cta: int) -> tuple[int, int]:
        return cta * self.items // self.grid, (cta + 1) * self.items // self.grid

    def item_receivers(self, item: int, batch: int, n: int) -> range:
        """The flat receivers ``b * n + i`` of an item."""
        return range(item * self.span, min((item + 1) * self.span, batch * n))


def _fwd_rest_floats(dims: Sequence[int], rows: int, ti: int,
                     fn_dims: Sequence[int] | None, row_arrays: int = FWD_ROW_ARRAYS,
                     min_act: int = 0) -> int:
    """Shared memory of a forward pass but its weight slabs, in floats: one
    buffer as wide as the widest of a_0 .. a_{L-1} (the products write over their
    input, and the last layer's partial sums go there when it is large enough,
    else to a region of their own), K2's (and the knn kernels') aggregate of
    ``ti`` receivers or K4's transposed ``[agg | x]`` rows that fn then runs on in
    place, the region before the slabs at least ``min_act`` floats (K5: the
    search's scratch), the row arrays and a table of the layers."""
    ldr = rows + 4
    width = max(dims[:-1]) if len(dims) > 1 else dims[0]
    if fn_dims:
        act = max([dims[-1] + width, *fn_dims]) * ldr
    else:
        act = width * ldr + -(-ti * dims[-1] // 4) * 4
    act = max(act, -(-min_act // 4) * 4)
    part = 2 * (rows // 8) * dims[-1]
    return act + row_arrays * ldr + FWD_TAB_FLOATS + (part if part > width * ldr else 0)


def fwd_slab_floats(dims: Sequence[int], rows: int, ti: int,
                    fn_dims: Sequence[int] | None = None) -> int:
    """Floats of each of a forward pass's two weight slab buffers: the largest
    size that fits beside the rest (fewer barriers a product), else the least.
    The launcher takes it from the plan and checks that it fits."""
    rest = _fwd_rest_floats(dims, rows, ti, fn_dims)
    return next((c for c in FWD_SLAB_FLOATS if 4 * (rest + 2 * c) <= MAX_SMEM_BYTES),
                BWD_SLAB_FLOATS)


def fwd_smem_bytes(dims: Sequence[int], rows: int, ti: int,
                   fn_dims: Sequence[int] | None = None) -> int:
    """Shared memory of a forward pass of ``rows`` pair rows through the chain
    ``dims``: the rest (``_fwd_rest_floats``) and two weight slabs of
    ``fwd_slab_floats``."""
    return 4 * (_fwd_rest_floats(dims, rows, ti, fn_dims)
                + 2 * fwd_slab_floats(dims, rows, ti, fn_dims))


def _ceil(v: int, m: int) -> int:
    return -(-v // m) * m


def _fn_layer_floats(fn_dims: Sequence[int], layer: int) -> int:
    """Floats of K4's fn layer in the packed copy (``fn_layer_floats``): the first
    as bf16 rows with M padded to 64 (the FMA chains' columns), the later ones as
    bf16 fragments."""
    k, m = fn_dims[layer], fn_dims[layer + 1]
    return k * _ceil(m, 64) // 2 if layer == 0 else _ceil(k, 16) * _ceil(m, 8) // 2


def fwd_packed_floats_bf16(dims: Sequence[int], fn_dims: Sequence[int] | None = None) -> int:
    """Floats of the copy of the weights that a bf16-mode forward launch packs
    (``edge_fwd_bf16_tiles.cuh``: fwd_pack_bf16, and fn_pack_bf16 for K4): per fe
    layer a bf16 copy in fragment order, K padded to 16 and M to 8, two values a
    float, then every fe bias as float32, padded to 4; K4's fn after it, its
    layers as :func:`_fn_layer_floats` gives, then its biases."""
    fe = list(zip(dims[:-1], dims[1:]))
    floats = sum(_ceil(k, 16) * _ceil(m, 8) // 2 + _ceil(m, 4) for k, m in fe)
    if fn_dims:
        floats += sum(_fn_layer_floats(fn_dims, i) + _ceil(m, 4)
                      for i, m in enumerate(fn_dims[1:]))
    return floats


def bwd_packed_floats_bf16(dims: Sequence[int], rows: int) -> int:
    """Floats of the copy of the weights that a bf16-mode backward launch packs
    (``edge_bwd_bf16.cuh``): per hidden layer ``[k x m]`` the recompute's bf16
    copy in fragment order (k padded to 16, m to 8, two values a float), W^T
    for the split-TF32 da product (``edge_bwd_tf32x3.cuh``: float32 values, exact
    in TF32, so no lo slab; m padded to 8, k to 8) and the bias as float32
    (padded to 4). ``rows``, the pass's pair rows, does not change it (the
    FP32 mode's size, :func:`bwd_packed_floats`, takes the same arguments)."""
    return sum(_ceil(k, 16) * _ceil(m, 8) // 2 + _ceil(m, 8) * _ceil(k, 8) + _ceil(m, 4)
               for k, m in zip(dims[:-1], dims[1:]))


# The bf16 mode's forward pass (csrc/edge_fwd_bf16_tiles.cuh: K2 here, K5 and K8 in
# knn_kernels): the chain's weights resident in shared memory, a warp taking 16 pair
# rows through the chain; planned here, checked again by the launcher.
TILE_CLASSES = (64, 128, 256)  # width classes the kernel is built for (tile_class)
TILE_ROWS = 16
TILE_MAX_ROWS = 256  # rows of an item, ti * rs
TILE_RUN_FLOATS = 256  # a warp's running receiver sums (kTileRunFloats)
FN_TILE_ROWS = 16  # K4: receivers of an fn tile
FN_SLOT_WARPS = 4  # K4: warps of an fn tile


def tile_warps(width: int) -> int:
    """The most warps a CTA of the width class runs (``tile_warps``)."""
    return 16 if width <= 128 else 12


def tile_class(dims: Sequence[int]) -> int:
    """The width class of a chain: the least class that holds every input of its
    hidden layers (all but the last), whose A fragments stay in registers."""
    if max(dims) > MAX_WIDTH:
        raise ValueError(f"layer widths {list(dims)} exceed the kernel cap {MAX_WIDTH}")
    widest = max(dims[:-2], default=0)
    return next(w for w in TILE_CLASSES if widest <= w)


@dataclasses.dataclass(frozen=True)
class Bf16TilePlan:
    """One launch of the bf16 forward pass: the kernel of width class ``width``
    with ``warps`` warps a CTA; an item is ``ti`` receivers (K2, K4: consecutive in
    the batch's flat list ``b * n + i``; K5, K8: a block of one jet, ``blocks``
    a jet), each taking ``rs = max(jc, 8)`` rows, walked over the senders
    (ranks) in chunks of ``jc`` by one warp, 16 rows a tile. ``grid`` CTAs each
    take a contiguous range of the ``items``, their warps in turn; K5's CTAs
    search the jets of at most ``sspan_items`` of their items at a time. With
    ``resident`` the weights sit in shared memory; a chain too wide for that
    runs on the 256 class reading them from the packed copy in device memory.
    ``warps`` is at most ``tile_warps(width)``, all of them for K5 (its search
    runs on every thread). K4 then runs fn on tiles of 16 receivers (every
    receiver once, tile ``t`` on CTA ``t % grid``), ``fn_slots`` tiles of a CTA at
    a time on 4 warps each (``warps`` a multiple of 4)."""
    width: int
    warps: int
    resident: bool
    ti: int
    jc: int
    items: int
    grid: int
    blocks: int
    sspan_items: int
    smem_bytes: int
    fn_slots: int = 0

    @property
    def rs(self) -> int:
        return max(self.jc, 8)

    def item_range(self, cta: int) -> tuple[int, int]:
        return cta * self.items // self.grid, (cta + 1) * self.items // self.grid

    def tiles(self, ti_eff: int, jc_eff: int) -> int:
        """16-row tiles of an item's chunk with ``ti_eff`` receivers and
        ``jc_eff`` senders (ranks)."""
        return -(-((ti_eff - 1) * self.rs + jc_eff) // TILE_ROWS)


def fn_smem_bytes(fn_dims: Sequence[int], fn_slots: int) -> int:
    """Shared memory of K4's second phase (``fn_layout``): the staged layer's
    weights (the largest of :func:`_fn_layer_floats`) and bias, then ``fn_slots``
    slots, each a tile's input rows ``[K x 16]`` float32 (or, when larger, the A
    fragments of the widest input of a later layer), then A fragments of that
    widest input (16 rows in bf16); then the staging's mbarrier."""
    layers = len(fn_dims) - 1
    weights = max(_fn_layer_floats(fn_dims, i) for i in range(layers))
    frag = max((-(-k // 16) * 128 for k in fn_dims[1:-1]), default=0)
    slot = max(16 * fn_dims[0], frag) + frag
    return 4 * (weights + _ceil(max(fn_dims[1:]), 4) + fn_slots * slot + 4)


def bf16_tile_smem_bytes(dims: Sequence[int], senders: int, ti: int, jc: int, *,
                         resident: bool = True, warps: int = 0, k: int = 0,
                         sspan_items: int = 0, search_floats: int = 0,
                         fn_dims: Sequence[int] | None = None, fn_slots: int = 0) -> int:
    """Shared memory of the bf16 forward pass (``tile_layout``): the resident copy
    of the weights and biases (:func:`fwd_packed_floats_bf16`), the layer table (K4:
    fe's and fn's) and the copy's mbarrier; K5 (``search_floats`` > 0, the search's
    scratch) its neighbours and distances ``[sspan_items * ti, k]``; then the work
    region: each of ``warps`` warps' tile region (its 16 rows' activations as A
    fragments, 16 x the widest layer input in bf16; its running receiver sums; the
    receivers' aggregates ``[ti x h_out]`` where a receiver takes several chunks of
    ``jc`` of its ``senders``), and K5's search scratch between chunks. K4
    (``fn_dims``): the larger of that and its second phase's
    (:func:`fn_smem_bytes`), which reuses it all."""
    packed = fwd_packed_floats_bf16(dims) if resident else 0
    sel = _ceil(sspan_items * ti * k, 4) if search_floats else 0
    off_work = packed + 4 * MAX_LAYERS * (2 if fn_dims else 1) + 4 + 2 * sel
    chunks = -(-senders // jc)
    warps = warps or tile_warps(tile_class(dims) if resident else 256)
    act = -(-max(dims[:-1], default=0) // 16) * 128
    warp_floats = act + TILE_RUN_FLOATS + (_ceil(ti * dims[-1], 4) if chunks > 1 else 0)
    work = max(warps * warp_floats, search_floats)
    first = 4 * (off_work + work)
    return max(first, fn_smem_bytes(fn_dims, fn_slots)) if fn_dims else first


def tile_plan_core(batch: int, n: int, dims: Sequence[int], sms: int, fp32_ti: int,
                   jc: int, *, knn_k: int = 0, search_floats: int = 0,
                   fn_dims: Sequence[int] | None = None) -> Bf16TilePlan:
    """The bf16 forward pass's plan given the FP32 plan's row order (its sender or
    rank chunk ``jc`` and receivers a pass ``fp32_ti``): items of ``ti``
    receivers where ``ti * rs`` is a multiple of 8 (every receiver's rows then fall
    into 8-row groups as the FP32 plan's did, so the sums are the same), else the
    FP32 plan's ``ti``; of those the one whose busiest warp takes the fewest tiles
    (ties: fewer tiles in all, then more receivers an item). ``knn_k``: a knn
    launch (items per jet over its ``knn_k`` ranks); ``search_floats`` > 0: K5,
    whose search chunks then take as many of a CTA's items as fit; ``fn_dims``: K4,
    whose warps are a multiple of 4 and whose fn tiles take as many slots as fit.
    Where no item size fits with the weights resident, the same without them."""
    fn_dims = tuple(fn_dims) if fn_dims else None
    for resident in (True, False):
        plan = _tile_plan(batch, n, dims, sms, fp32_ti, jc, knn_k, search_floats, resident,
                          fn_dims)
        if plan is not None:
            return plan
    raise ValueError(f"layer widths {list(dims)} (fn {list(fn_dims or [])}) at n={n} do not fit "
                     f"the bf16 forward pass's shared memory ({MAX_SMEM_BYTES} bytes)")


def _tile_plan(batch, n, dims, sms, fp32_ti, jc, knn_k, search_floats, resident, fn_dims):
    width = tile_class(dims) if resident else 256
    rs = max(jc, 8)
    senders = knn_k or n
    top = n if knn_k else batch * n
    if fp32_ti * rs % 8 == 0:
        cands = [t for t in range(1, min(TILE_MAX_ROWS // rs, top) + 1) if t * rs % 8 == 0]
    else:
        cands = [fp32_ti]
    chunks = [min(jc, senders - j0) for j0 in range(0, senders, jc)]

    def item_tiles(ti_eff: int) -> int:
        return sum(-(-((ti_eff - 1) * rs + je) // TILE_ROWS) for je in chunks)

    best = None
    for ti in cands:
        if knn_k:
            blocks = -(-n // ti)
            items = batch * blocks
            total = batch * ((blocks - 1) * item_tiles(ti) + item_tiles(n - (blocks - 1) * ti))
        else:
            blocks = 0
            items = -(-batch * n // ti)
            total = (items - 1) * item_tiles(ti) + item_tiles(batch * n - (items - 1) * ti)
        grid = min(sms, items)
        per_cta = -(-items // grid)

        def smem(warps: int, sspan: int, slots: int = 0) -> int:
            return bf16_tile_smem_bytes(dims, senders, ti, jc, resident=resident, warps=warps,
                                        k=knn_k, sspan_items=sspan, search_floats=search_floats,
                                        fn_dims=fn_dims, fn_slots=slots)
        slots = 0
        if fn_dims:
            # the most warps (a multiple of 4) and then the most fn slots that fit
            fits = [(w, s) for w in range(tile_warps(width) // FN_SLOT_WARPS * FN_SLOT_WARPS, 0,
                                          -FN_SLOT_WARPS)
                    for s in range(w // FN_SLOT_WARPS, 0, -1) if smem(w, 0, s) <= MAX_SMEM_BYTES]
            if not fits:
                continue
            warps, slots = fits[0]
            sspan = 0
            rounds = -(-per_cta // warps)
        elif search_floats:
            warps = tile_warps(width)
            sspan = next((s for s in range(per_cta, 0, -1)
                          if smem(warps, s) <= MAX_SMEM_BYTES), 0)
            if not sspan:
                continue
            rounds = sum(-(-min(sspan, per_cta - i) // warps) for i in range(0, per_cta, sspan))
        else:
            sspan = 0
            warps = next((w for w in range(tile_warps(width), 0, -1)
                          if smem(w, 0) <= MAX_SMEM_BYTES), 0)
            if not warps:
                continue
            rounds = -(-per_cta // warps)
        key = (rounds * item_tiles(ti), total, -ti)
        if best is None or key < best[0]:
            best = (key, Bf16TilePlan(width, warps, resident, ti, jc, items, grid, blocks,
                                      sspan, smem(warps, sspan, slots), slots))
    return None if best is None else best[1]


def bf16_tile_plan(batch: int, n: int, dims: Sequence[int], sms: int,
                   fn_dims: Sequence[int] | None = None) -> Bf16TilePlan:
    """Plan K2's bf16 launch over ``batch`` jets of ``n`` particles through the
    fe chain ``dims`` on a card with ``sms`` SMs, and with ``fn_dims`` K4's (see
    :func:`tile_plan_core`; the row order from :func:`fwd_plan`, K4's from its
    own, so that the aggregate's sums are the FP32 pass's). Memoised per shape."""
    if fn_dims and max(fn_dims) > MAX_WIDTH:
        raise ValueError(f"fn widths {list(fn_dims)} exceed the kernel cap {MAX_WIDTH}")
    return _bf16_tile_plan(batch, n, tuple(dims), sms, tuple(fn_dims) if fn_dims else None)


@functools.lru_cache(maxsize=256)
def _bf16_tile_plan(batch: int, n: int, dims: tuple, sms: int,
                    fn_dims: tuple | None) -> Bf16TilePlan:
    fp32 = fwd_plan(batch, n, dims, sms, fn_dims)
    return tile_plan_core(batch, n, dims, sms, fp32.ti, fp32.jc, fn_dims=fn_dims)


def fwd_packed_floats(dims: Sequence[int], rows: int, fn_dims: Sequence[int] | None = None) -> int:
    """Floats of the copy of the weights that a forward launch packs for its
    products: per fe (and fn) layer, K rows of M padded to the column threads."""
    col_threads = 8 * ((BWD_THREADS // 32) // (rows // 32))
    layers = list(zip(dims[:-1], dims[1:])) + list(zip((fn_dims or [])[:-1], (fn_dims or [])[1:]))
    return sum(k * -(-m // col_threads) * col_threads for k, m in layers)


def _product_cost(dims: Sequence[int], rows: int) -> int:
    """Instructions a thread issues in the k loops of a chain's products over one
    pass: a k-step of a product with TN = ceil(M / column threads) columns is 8 x
    TN FMAs, two loads of the activations and one a weight group (128-bit, 64-bit,
    single), so narrow tiles cost more a FLOP."""
    col_threads = 8 * ((BWD_THREADS // 32) // (rows // 32))

    def step(m: int) -> int:
        tn = -(-m // col_threads)
        return 8 * tn + 2 + tn // 4 + (tn % 4) // 2 + tn % 2
    return sum(k * step(m) for k, m in zip(dims[:-1], dims[1:]))


def fwd_plan(batch: int, n: int, dims: Sequence[int], sms: int,
             fn_dims: Sequence[int] | None = None) -> FwdPlan:
    """Plan a forward launch over ``batch`` jets of ``n`` particles through the
    fe chain ``dims`` (K2), and with ``fn_dims`` the node MLP after it (K4), on a
    card with ``sms`` SMs: the pass, the receivers of an item and the grid that
    give the busiest CTA the least arithmetic among those that fit in shared
    memory (ties: longer sender chunks, then more receivers a pass, then longer
    items). Memoised per shape."""
    return _fwd_plan(batch, n, tuple(dims), sms, tuple(fn_dims) if fn_dims else None)


@functools.lru_cache(maxsize=256)
def _fwd_plan(batch: int, n: int, dims: tuple, sms: int, fn_dims: tuple | None) -> FwdPlan:
    best = None
    for rows in (128, 64, 32):
        per_pass = _product_cost(dims, rows) + rows * dims[0] // BWD_THREADS  # + a_0
        fn_cost = _product_cost(fn_dims, rows) if fn_dims else 0
        for jc in range(1, min(n, rows) + 1):
            rs = max(jc, 8)
            if rs > rows:
                continue
            ti = min(rows // rs, batch * n)
            smem = fwd_smem_bytes(dims, rows, ti, fn_dims)
            if smem > MAX_SMEM_BYTES:
                continue
            per_block = -(-n // jc) * per_pass
            # K4: an item of k blocks, fn once on its rows
            blocks = range(1, rows // ti + 1) if fn_dims else (1,)
            for k in blocks:
                items = -(-batch * n // (k * ti))
                grid = min(sms, items)
                key = (-(-items // grid) * (k * per_block + fn_cost), -jc, -ti, -k)
                if best is None or key < best[0]:
                    best = (key, FwdPlan(ti, jc, rows, k * ti, items, grid, smem,
                                         fwd_slab_floats(dims, rows, ti, fn_dims)))
    if best is None:
        raise ValueError(f"layer widths {list(dims)} (fn {list(fn_dims or [])}) at n={n} do not "
                         f"fit the forward kernel's shared memory ({MAX_SMEM_BYTES} bytes) "
                         "even at 32 pair rows")
    return best[1]


@functools.lru_cache(maxsize=None)
def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _flat_wgrads(flat: torch.Tensor, hidden_flat, extra: int = 0):
    """Views of the flat weight-gradient buffer, one per hidden tensor, and the
    trailing ``extra`` elements."""
    out, off = [], 0
    for t in hidden_flat:
        out.append(flat[off:off + t.numel()].view(t.shape))
        off += t.numel()
    return tuple(out), flat[off:off + extra]


def edge_aggregate_bwd(u1, u2, mask, hidden_flat, g, alpha: float, sum_agg: bool,
                       dropout_p: float = 0.0, seed=0, need_wgrads: bool = True):
    """K3: the plain backward on the CPU, the CUDA kernel on a GPU. Returns
    ``(du1, du2, dmask, dhidden_flat)``, in the inputs' dtype: all float32, or
    all bf16 for the bf16 mode (its own kernel and count; the weight gradients
    summed in float32, then rounded to bf16)."""
    hidden_flat = tuple(hidden_flat)
    bf16 = _is_bf16(u1, u2, mask, g, *hidden_flat)
    name = ("edge_aggregate_bwd" if need_wgrads else "edge_aggregate_bwd_no_wgrads") + \
        ("_bf16" if bf16 else "")
    _check_dropout(name, dropout_p, seed)
    if _on_cpu(u1, u2, mask, g, *hidden_flat):
        return edge_aggregate_bwd_reference(u1, u2, mask, hidden_flat, g, alpha, sum_agg,
                                            dropout_p, seed, need_wgrads)
    if alpha <= 0:
        # the kernel reads LeakyReLU's slope off the sign of the stored activation
        raise ValueError(f"{name}: the kernel needs leaky_relu_alpha > 0, got {alpha}")
    pairs = _pairs(hidden_flat)
    dims = _check_edge_shapes(name, u1, u2, mask, pairs)
    b_sz, n, h1 = u1.shape
    if g.shape != (b_sz, n, dims[-1]):
        raise ValueError(f"{name}: g {tuple(g.shape)} must be {(b_sz, n, dims[-1])}")
    _check_cuda_args(name, {"u1": u1, "u2": u2, "mask": mask, "g": g,
                            **{f"hidden[{i}]": t for i, t in enumerate(hidden_flat)}},
                     hidden_flat[::2], u1.dtype)
    dev = u1.device
    f32 = dict(dtype=torch.float32, device=dev)
    # bf16: du1 is summed in float32 over the sender chunks, then rounded here
    du1 = torch.empty(u1.shape, **f32) if bf16 else torch.empty_like(u1)
    du2 = torch.empty_like(u2)
    dmask = torch.empty_like(mask)
    w_total = sum(t.numel() for t in hidden_flat)
    # the kernel's second pass writes every weight gradient; without them they are zeros
    flat = torch.empty((w_total,), **f32) if need_wgrads else torch.zeros((w_total,), **f32)
    dhidden, _ = _flat_wgrads(flat, hidden_flat)
    plan = bwd_plan(b_sz, n, n, dims, _sm_count(dev))
    # partial sums, reduced in a second pass in a fixed order: a slab per (jet, CTA
    # that touches it) for du2 and dmask, one per CTA for the weights
    sender_part = torch.empty((b_sz, plan.slots, n, h1 + 1), **f32)
    w_part = torch.empty((plan.grid, bwd_wslab_floats(dims)) if need_wgrads and w_total
                         else (1,), **f32)
    # the kernel's own copy of the weights, W and W^T laid out for its products
    packed_floats = (bwd_packed_floats_bf16 if bf16 else bwd_packed_floats)(dims, plan.rows)
    packed = torch.empty((max(packed_floats, 1),), **f32)
    lib = _build.library()
    w, b = _chain_args(pairs)
    dim_arr = (ctypes.c_int * len(dims))(*dims)
    thr, mult = dropout_threshold_mult(dropout_p) if dropout_p > 0 else (0, 1.0)
    seed_t = seed_arg(name, seed, dev) if dropout_p > 0 else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        ptrs = (u1.data_ptr(), u2.data_ptr(), mask.data_ptr(), g.data_ptr(),
                du1.data_ptr(), du2.data_ptr(), dmask.data_ptr(), flat.data_ptr(),
                sender_part.data_ptr(), w_part.data_ptr(), b_sz, n, h1, len(pairs), w,
                packed.data_ptr())
        rest = (b, dim_arr, float(alpha), int(bool(sum_agg)), int(dropout_p > 0),
                None if seed_t is None else seed_t.data_ptr(), thr, mult, int(bool(need_wgrads)),
                plan.ti, plan.jc, plan.rows, plan.grid, plan.slots, stream)
        if bf16:
            code = lib.mpgan_edge_aggregate_bwd_bf16(*ptrs, packed_floats, *rest)
        else:
            code = lib.mpgan_edge_aggregate_bwd(*ptrs, *rest)
    _build.check(code, name)
    launch_counts[name] += 1
    if bf16:
        du1 = du1.to(torch.bfloat16)
        dhidden = tuple(t.to(torch.bfloat16) for t in dhidden)
    return du1, du2, dmask, dhidden


class EdgeAggregate(torch.autograd.Function):
    """K2 forward, K3 backward (``mp_pallas.edge_aggregate``'s custom VJP).

    ``EdgeAggregate.apply(u1, u2, mask, alpha, sum_agg, dropout_p, seed,
    *hidden_flat)``, ``seed`` an int or a one-element int32 tensor. The backward launches K3 with the weight contractions only
    when a hidden weight or bias needs a gradient, so a D pass whose parameters
    have ``requires_grad`` off (the G step) skips them. It is once
    differentiable: the GP double backward raises (GP configs run D on the
    plain path, as in the JAX package)."""

    @staticmethod
    def forward(ctx, u1, u2, mask, alpha, sum_agg, dropout_p, seed, *hidden_flat):
        ctx.save_for_backward(u1, u2, mask, *hidden_flat)
        ctx.cfg = (alpha, sum_agg, dropout_p, seed)
        return edge_aggregate(u1, u2, mask, hidden_flat, alpha, sum_agg, dropout_p, seed)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        u1, u2, mask, *hidden_flat = ctx.saved_tensors
        alpha, sum_agg, dropout_p, seed = ctx.cfg
        need_wgrads = any(ctx.needs_input_grad[7:])
        du1, du2, dmask, dhidden = edge_aggregate_bwd(
            u1, u2, mask, hidden_flat, g.contiguous(), alpha, sum_agg, dropout_p, seed,
            need_wgrads,
        )
        if not need_wgrads:
            dhidden = (None,) * len(hidden_flat)
        return (du1, du2, dmask, None, None, None, None, *dhidden)


def edge_aggregate_fn(
    u1, u2, mask, hidden_flat, x, fn_flat, alpha: float, sum_agg: bool,
    fn_alpha: float, fn_final_linear: bool,
):
    """K4: the plain version on the CPU, the CUDA kernel on a GPU; all inputs
    float32, or all bf16 for the bf16 mode (its own kernel and count)."""
    hidden_flat, fn_flat = tuple(hidden_flat), tuple(fn_flat)
    bf16 = _is_bf16(u1, u2, mask, x, *hidden_flat, *fn_flat)
    if _on_cpu(u1, u2, mask, x, *hidden_flat, *fn_flat):
        return edge_aggregate_fn_reference(
            u1, u2, mask, hidden_flat, x, fn_flat, alpha, sum_agg, fn_alpha, fn_final_linear
        )
    name = "edge_aggregate_fn" + ("_bf16" if bf16 else "")
    pairs = _pairs(hidden_flat)
    dims = _check_edge_shapes(name, u1, u2, mask, pairs)
    b_sz, n, h1 = u1.shape
    h_out, feat = dims[-1], x.shape[-1]
    w_top, w_bot, b1 = fn_flat[0], fn_flat[1], fn_flat[2]
    if x.shape != (b_sz, n, feat) or w_top.dim() != 2 or w_top.shape[0] != h_out \
            or w_bot.shape != (feat, w_top.shape[1]) or b1.shape != (w_top.shape[1],):
        raise ValueError(f"{name}: fn first layer {tuple(w_top.shape)} + {tuple(w_bot.shape)} "
                         f"does not take [agg {h_out} | x {feat}]")
    fn_pairs = [(w_top, b1)] + _pairs(fn_flat[3:])
    fn_dims = _chain_dims(name, "fn", [h_out + feat, w_top.shape[1]], fn_pairs[1:])
    _check_cuda_args(name, {"u1": u1, "u2": u2, "mask": mask, "x": x,
                            **{f"hidden[{i}]": t for i, t in enumerate(hidden_flat)},
                            **{f"fn[{i}]": t for i, t in enumerate(fn_flat)}},
                     hidden_flat[::2] + (w_top, w_bot) + fn_flat[3::2], u1.dtype)
    out = torch.empty((b_sz, n, fn_dims[-1]), dtype=u1.dtype, device=u1.device)
    lib = _build.library()
    w, b = _chain_args(pairs)
    fw, fb = _chain_args(fn_pairs)
    dim_arr = (ctypes.c_int * len(dims))(*dims)
    fn_dim_arr = (ctypes.c_int * len(fn_dims))(*fn_dims)
    with torch.cuda.device(u1.device):
        stream = torch.cuda.current_stream().cuda_stream
        chains = (b_sz, n, h1, feat, len(pairs), w, b, dim_arr,
                  len(fn_pairs), fw, w_bot.data_ptr(), fb, fn_dim_arr,
                  float(alpha), int(bool(sum_agg)), float(fn_alpha), int(not fn_final_linear))
        if bf16:
            plan16 = bf16_tile_plan(b_sz, n, dims, _sm_count(u1.device), fn_dims)
            packed_floats = fwd_packed_floats_bf16(dims, fn_dims)
            packed = torch.empty((packed_floats,), dtype=torch.float32, device=u1.device)
            # the receivers' float32 aggregates, in fn's tiles of 16 receivers
            aggs = torch.empty((-(-b_sz * n // FN_TILE_ROWS) * FN_TILE_ROWS * h_out,),
                               dtype=torch.float32, device=u1.device)
            code = lib.mpgan_edge_aggregate_fn_bf16(
                u1.data_ptr(), u2.data_ptr(), mask.data_ptr(), x.data_ptr(), out.data_ptr(),
                packed.data_ptr(), packed_floats, aggs.data_ptr(), *chains, plan16.width,
                plan16.warps, int(plan16.resident), plan16.ti, plan16.jc, plan16.fn_slots,
                plan16.grid, stream)
        else:
            plan = fwd_plan(b_sz, n, dims, _sm_count(u1.device), fn_dims)
            packed = torch.empty((fwd_packed_floats(dims, plan.rows, fn_dims),),
                                 dtype=torch.float32, device=u1.device)
            code = lib.mpgan_edge_aggregate_fn(
                u1.data_ptr(), u2.data_ptr(), mask.data_ptr(), x.data_ptr(), out.data_ptr(),
                packed.data_ptr(), *chains, plan.ti, plan.jc, plan.rows, plan.span, plan.grid,
                plan.slab_floats, stream)
    _build.check(code, name)
    launch_counts[name] += 1
    return out


class EdgeAggregateFn(torch.autograd.Function):
    """K4 forward; the backward recomputes through the unfused composition, K2
    then fn in torch, with K3 as K2's backward (``mp_pallas.edge_aggregate_fn``'s
    custom VJP), so that a layer on the K4 route is differentiable in eval mode.

    ``EdgeAggregateFn.apply(u1, u2, mask, x, alpha, sum_agg, fn_alpha,
    fn_final_linear, n_hidden, *hidden_flat, *fn_flat)``, ``n_hidden`` the
    length of ``hidden_flat``. Once differentiable."""

    @staticmethod
    def forward(ctx, u1, u2, mask, x, alpha, sum_agg, fn_alpha, fn_final_linear, n_hidden,
                *flat):
        ctx.save_for_backward(u1, u2, mask, x, *flat)
        ctx.cfg = (alpha, sum_agg, fn_alpha, fn_final_linear, n_hidden)
        return edge_aggregate_fn(u1, u2, mask, flat[:n_hidden], x, flat[n_hidden:], alpha,
                                 sum_agg, fn_alpha, fn_final_linear)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        alpha, sum_agg, fn_alpha, fn_final_linear, n_hidden = ctx.cfg
        needs = ctx.needs_input_grad[:4] + ctx.needs_input_grad[9:]
        inputs = [t.detach().requires_grad_(need) for t, need in zip(ctx.saved_tensors, needs)]
        u1, u2, mask, x, *flat = inputs
        bf16 = _is_bf16(u1, u2, mask, x, *flat)
        with torch.enable_grad():
            agg = EdgeAggregate.apply(u1, u2, mask, alpha, sum_agg, 0.0, 0, *flat[:n_hidden])
            y = _fn_chain(agg.float() if bf16 else agg, x, flat[n_hidden:], fn_alpha,
                          fn_final_linear, bf16)
        wanted = [t for t, need in zip(inputs, needs) if need]
        got = iter(torch.autograd.grad(y, wanted, g, allow_unused=True))
        grads = [next(got) if need else None for need in needs]
        return (*grads[:4], None, None, None, None, None, *grads[4:])
