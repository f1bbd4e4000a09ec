"""Dense message-passing edge kernels: plain PyTorch versions and CUDA wrappers.

Counterpart of ``mpgan_tpu/ops/mp_pallas.py``. Two functions, each with a plain
version and a wrapper around a hand-written Hopper kernel
(``csrc/edge_aggregate.cu``):

- ``edge_aggregate`` (K2 forward): ``agg[b, i] = sum_j mask[b, j] *
  chain(leaky(u1[b, i] + u2[b, j]))``, divided by ``n`` for the mean, where
  ``chain`` is the fe MLP's hidden layers ``hidden_flat = (w2, b2, w3, b3,
  ...)`` with weights ``[in, out]`` and LeakyReLU after each. The fe first-layer
  bias and any per-jet conditioning are folded into ``u2`` by the caller.
- ``edge_aggregate_fn`` (K4, eval only): the same aggregate followed by the
  node MLP on ``[agg | x]``; ``fn_flat = (w1_top, w1_bot, b1, w2, b2, ...)``
  with fn's first layer split along its ``[agg | x]`` input rows.

A wrapper runs the plain version for tensors on the CPU, and the kernel for
tensors on a CUDA device; anything else raises. ``launch_counts`` counts kernel
launches, so a run can show that it went through the kernels.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from . import _build

MAX_WIDTH = 256  # widest layer the kernels hold in shared memory
MAX_LAYERS = 8

launch_counts = {"edge_aggregate": 0, "edge_aggregate_fn": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _leaky(x: torch.Tensor, alpha: float) -> torch.Tensor:
    return torch.where(x >= 0, x, alpha * x)


def _pairs(hidden_flat: Sequence[torch.Tensor]) -> list[tuple[torch.Tensor, torch.Tensor]]:
    return [(hidden_flat[2 * k], hidden_flat[2 * k + 1]) for k in range(len(hidden_flat) // 2)]


def edge_aggregate_reference(u1, u2, mask, hidden_flat, alpha: float, sum_agg: bool):
    """Plain PyTorch version of the K2 forward (``mp_pallas.edge_aggregate_reference``)."""
    a = _leaky(u1[:, :, None, :] + u2[:, None, :, :], alpha)
    for w, b in _pairs(hidden_flat):
        a = _leaky(torch.matmul(a, w) + b, alpha)
    a = a * mask[:, None, :, :]
    return a.sum(dim=2) if sum_agg else a.mean(dim=2)


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


def edge_aggregate(u1, u2, mask, hidden_flat, alpha: float, sum_agg: bool):
    """K2 forward (no dropout): the plain version on the CPU, the CUDA kernel on a GPU."""
    hidden_flat = tuple(hidden_flat)
    if _on_cpu(u1, u2, mask, *hidden_flat):
        return edge_aggregate_reference(u1, u2, mask, hidden_flat, alpha, sum_agg)
    name = "edge_aggregate"
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
        code = lib.mpgan_edge_aggregate(
            u1.data_ptr(), u2.data_ptr(), mask.data_ptr(), out.data_ptr(),
            b_sz, n, h1, len(pairs), w, b, dim_arr, float(alpha), int(bool(sum_agg)), stream,
        )
    _build.check(code, name)
    launch_counts[name] += 1
    return out


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
