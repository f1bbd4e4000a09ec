"""Dense message-passing edge kernels: plain PyTorch versions and CUDA wrappers.

Counterpart of ``mpgan_tpu/ops/mp_pallas.py``. Each function has a plain
version and a wrapper around a hand-written Hopper kernel
(``csrc/edge_aggregate.cu``):

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

K1 (``mp_pallas._dropmul``) keys each element on a global pair id, the feature
column, the layer salt (0 for layer 1, k for hidden layer k) and an integer
seed. The dense kernels' ids are ``b*n*ns + i*ns + j`` with ``ns =
ceil(n/8)*8`` (the TPU kernel's sender padding, kept in the ids though nothing
is padded here); the knn kernels of :mod:`.knn_kernels` use ``b*n*k + i*k + s``
with the unpadded ``n`` and the neighbour's extraction rank ``s``.

A wrapper runs the plain version for tensors on the CPU, and the kernel for
tensors on a CUDA device; anything else raises. ``launch_counts`` counts kernel
launches (the knn kernels' too), so a run can show that it went through the
kernels.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch
from torch.autograd.function import once_differentiable

from . import _build
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
}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


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


def _dropmul(ids: torch.Tensor, cols: int, p: float, seed: int, salt: int) -> torch.Tensor:
    """K1 (``mp_pallas._dropmul``): the float32 dropout multiplier for pair ids
    ``ids`` (``[..., 1]``, from :func:`pair_ids`) and columns ``0..cols-1``;
    shape ``ids.shape[:-1] + (cols,)``."""
    key = _i32(seed * 0xC2B2AE3D + salt * 0x27D4EB2F)
    _, ckey = _hash_keys(1, cols, str(ids.device))
    return hash_mult(ids * _i32(0x9E3779B1) + key + ckey, p, torch.float32)


def _chain_recompute(u1, u2, hidden_flat, alpha, dropout_p, seed):
    """Pre-activations ``z_l``, activations ``a_l`` (after dropout) and the
    dropout multipliers of every layer of the edge chain, ``[B, N, N, H_l]``."""
    pairs = _pairs(hidden_flat)
    ids = pair_ids(u1.shape[0], u1.shape[1], u1.device) if dropout_p > 0 else None
    zs, acts, mults = [], [], []
    z = u1[:, :, None, :] + u2[:, None, :, :]
    for salt in range(len(pairs) + 1):
        if salt:
            w, b = pairs[salt - 1]
            z = torch.matmul(acts[-1], w) + b
        a = _leaky(z, alpha)
        m = _dropmul(ids, z.shape[-1], dropout_p, seed, salt) if dropout_p > 0 else None
        zs.append(z)
        mults.append(m)
        acts.append(a if m is None else a * m)
    return zs, acts, mults


def edge_aggregate_reference(u1, u2, mask, hidden_flat, alpha: float, sum_agg: bool,
                             dropout_p: float = 0.0, seed: int = 0):
    """Plain PyTorch version of the K2 forward (``mp_pallas.edge_aggregate_reference``,
    plus the in-kernel dropout of ``_fwd_kernel``)."""
    _, acts, _ = _chain_recompute(u1, u2, hidden_flat, alpha, dropout_p, seed)
    a = acts[-1] * mask[:, None, :, :]
    return a.sum(dim=2) if sum_agg else a.mean(dim=2)


def edge_aggregate_bwd_reference(u1, u2, mask, hidden_flat, g, alpha: float, sum_agg: bool,
                                 dropout_p: float = 0.0, seed: int = 0,
                                 need_wgrads: bool = True):
    """Plain PyTorch version of K3 (``mp_pallas._bwd_kernel``): recompute the
    chain, replay the dropout masks, backprop. Returns ``(du1, du2, dmask,
    dhidden_flat)``; the hidden gradients are zeros without ``need_wgrads``."""
    pairs = _pairs(hidden_flat)
    zs, acts, mults = _chain_recompute(u1, u2, hidden_flat, alpha, dropout_p, seed)
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
            dhidden[2 * (layer - 1)] = torch.matmul(
                a_in.reshape(-1, a_in.shape[-1]).t(), dz.reshape(-1, dz.shape[-1]))
            dhidden[2 * (layer - 1) + 1] = dz.sum(dim=(0, 1, 2))
        da = torch.matmul(dz, w.t())
    return dz.sum(dim=2), dz.sum(dim=1), dmask, tuple(dhidden)


def _fn_chain(agg, x, fn_flat, fn_alpha: float, fn_final_linear: bool):
    num_layers = (len(fn_flat) - 3) // 2 + 1

    def act(i: int) -> bool:
        return i != num_layers - 1 or not fn_final_linear

    z = torch.matmul(agg, fn_flat[0]) + torch.matmul(x, fn_flat[1]) + fn_flat[2]
    if act(0):
        z = _leaky(z, fn_alpha)
    for layer, (w, b) in enumerate(_pairs(fn_flat[3:])):
        z = torch.matmul(z, w) + b
        if act(layer + 1):
            z = _leaky(z, fn_alpha)
    return z


def edge_aggregate_fn_reference(
    u1, u2, mask, hidden_flat, x, fn_flat, alpha: float, sum_agg: bool,
    fn_alpha: float, fn_final_linear: bool,
):
    """Plain PyTorch version of K4: the K2 aggregate, then fn on ``[agg | x]``
    with its first layer decomposed (``mp_pallas._edge_fn_composed``)."""
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
                     weights: Sequence[torch.Tensor]) -> None:
    for k, t in tensors.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {k} must be float32, got {t.dtype}")
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


def _check_dropout(name: str, dropout_p: float, seed: int) -> None:
    if not 0.0 <= dropout_p < 1.0:
        raise ValueError(f"{name}: dropout_p {dropout_p} outside [0, 1)")
    if dropout_p > 0 and not 0 <= int(seed) < 2**31:
        raise ValueError(f"{name}: dropout seed {seed} outside [0, 2**31)")


def edge_aggregate(u1, u2, mask, hidden_flat, alpha: float, sum_agg: bool,
                   dropout_p: float = 0.0, seed: int = 0):
    """K2 forward: the plain version on the CPU, the CUDA kernel on a GPU."""
    hidden_flat = tuple(hidden_flat)
    name = "edge_aggregate_train" if dropout_p > 0 else "edge_aggregate"
    _check_dropout(name, dropout_p, seed)
    if _on_cpu(u1, u2, mask, *hidden_flat):
        return edge_aggregate_reference(u1, u2, mask, hidden_flat, alpha, sum_agg,
                                        dropout_p, seed)
    pairs = _pairs(hidden_flat)
    dims = _check_edge_shapes(name, u1, u2, mask, pairs)
    _check_cuda_args(name, {"u1": u1, "u2": u2, "mask": mask,
                            **{f"hidden[{i}]": t for i, t in enumerate(hidden_flat)}},
                     hidden_flat[::2])
    b_sz, n, h1 = u1.shape
    out = torch.empty((b_sz, n, dims[-1]), dtype=torch.float32, device=u1.device)
    lib = _build.library()
    w, b = _chain_args(pairs)
    dim_arr = (ctypes.c_int * len(dims))(*dims)
    with torch.cuda.device(u1.device):
        stream = torch.cuda.current_stream().cuda_stream
        if dropout_p > 0:
            thr, mult = dropout_threshold_mult(dropout_p)
            code = lib.mpgan_edge_aggregate_train(
                u1.data_ptr(), u2.data_ptr(), mask.data_ptr(), out.data_ptr(),
                b_sz, n, h1, len(pairs), w, b, dim_arr, float(alpha), int(bool(sum_agg)),
                int(seed), thr, mult, stream,
            )
        else:
            code = lib.mpgan_edge_aggregate(
                u1.data_ptr(), u2.data_ptr(), mask.data_ptr(), out.data_ptr(),
                b_sz, n, h1, len(pairs), w, b, dim_arr, float(alpha), int(bool(sum_agg)), stream,
            )
    _build.check(code, name)
    launch_counts[name] += 1
    return out


def edge_aggregate_bwd(u1, u2, mask, hidden_flat, g, alpha: float, sum_agg: bool,
                       dropout_p: float = 0.0, seed: int = 0, need_wgrads: bool = True):
    """K3: the plain backward on the CPU, the CUDA kernel on a GPU. Returns
    ``(du1, du2, dmask, dhidden_flat)``."""
    hidden_flat = tuple(hidden_flat)
    name = "edge_aggregate_bwd" if need_wgrads else "edge_aggregate_bwd_no_wgrads"
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
    # the kernel reads W^T for da = dz @ W^T: [out, in] copies of the hidden weights
    w_t = tuple(w.t().contiguous() for w, _ in pairs)
    _check_cuda_args(name, {"u1": u1, "u2": u2, "mask": mask, "g": g,
                            **{f"hidden[{i}]": t for i, t in enumerate(hidden_flat)}},
                     hidden_flat[::2] + w_t)
    dev = u1.device
    du1 = torch.empty_like(u1)
    du2 = torch.empty_like(u2)
    dmask = torch.empty_like(mask)
    dhidden = tuple(torch.zeros_like(t) for t in hidden_flat)
    lib = _build.library()
    n_groups = lib.mpgan_edge_aggregate_groups(n)
    n_cta = b_sz * n_groups
    w_total = sum(a * c + c for a, c in zip(dims[:-1], dims[1:]))
    # per-CTA partial sums, reduced in a second pass in a fixed order
    du2_part = torch.empty((b_sz, n_groups, n, h1), dtype=torch.float32, device=dev)
    dmask_part = torch.empty((b_sz, n_groups, n), dtype=torch.float32, device=dev)
    w_part = torch.empty((n_cta, w_total) if need_wgrads and pairs else (1,),
                         dtype=torch.float32, device=dev)
    w, b = _chain_args(pairs)
    wt_arr = (ctypes.c_void_p * max(len(pairs), 1))(*[t.data_ptr() for t in w_t])
    dw_arr = (ctypes.c_void_p * max(len(hidden_flat), 1))(*[t.data_ptr() for t in dhidden])
    dim_arr = (ctypes.c_int * len(dims))(*dims)
    thr, mult = dropout_threshold_mult(dropout_p) if dropout_p > 0 else (0, 1.0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.mpgan_edge_aggregate_bwd(
            u1.data_ptr(), u2.data_ptr(), mask.data_ptr(), g.data_ptr(),
            du1.data_ptr(), du2.data_ptr(), dmask.data_ptr(), dw_arr,
            du2_part.data_ptr(), dmask_part.data_ptr(), w_part.data_ptr(),
            b_sz, n, h1, len(pairs), w, wt_arr, b, dim_arr, float(alpha), int(bool(sum_agg)),
            int(dropout_p > 0), int(seed), thr, mult, int(bool(need_wgrads)), stream,
        )
    _build.check(code, name)
    launch_counts[name] += 1
    return du1, du2, dmask, dhidden


class EdgeAggregate(torch.autograd.Function):
    """K2 forward, K3 backward (``mp_pallas.edge_aggregate``'s custom VJP).

    ``EdgeAggregate.apply(u1, u2, mask, alpha, sum_agg, dropout_p, seed,
    *hidden_flat)``. The backward launches K3 with the weight contractions only
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
    """K4: the plain version on the CPU, the CUDA kernel on a GPU."""
    hidden_flat, fn_flat = tuple(hidden_flat), tuple(fn_flat)
    if _on_cpu(u1, u2, mask, x, *hidden_flat, *fn_flat):
        return edge_aggregate_fn_reference(
            u1, u2, mask, hidden_flat, x, fn_flat, alpha, sum_agg, fn_alpha, fn_final_linear
        )
    name = "edge_aggregate_fn"
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
                     hidden_flat[::2] + (w_top, w_bot) + fn_flat[3::2])
    out = torch.empty((b_sz, n, fn_dims[-1]), dtype=torch.float32, device=u1.device)
    lib = _build.library()
    w, b = _chain_args(pairs)
    fw, fb = _chain_args(fn_pairs)
    dim_arr = (ctypes.c_int * len(dims))(*dims)
    fn_dim_arr = (ctypes.c_int * len(fn_dims))(*fn_dims)
    with torch.cuda.device(u1.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.mpgan_edge_aggregate_fn(
            u1.data_ptr(), u2.data_ptr(), mask.data_ptr(), x.data_ptr(), out.data_ptr(),
            b_sz, n, h1, feat, len(pairs), w, b, dim_arr,
            len(fn_pairs), fw, w_bot.data_ptr(), fb, fn_dim_arr,
            float(alpha), int(bool(sum_agg)), float(fn_alpha), int(not fn_final_linear), stream,
        )
    _build.check(code, name)
    launch_counts[name] += 1
    return out
