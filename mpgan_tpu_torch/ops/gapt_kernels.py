"""The fused GAPT generator forward: plain PyTorch version and CUDA wrapper.

Counterpart of ``mpgan_tpu/ops/gapt_pallas.py``: ``gapt_g_fused`` (K9,
``csrc/gapt_fused.cu``) runs the whole eval-mode generator in one kernel. For
``x [B, N, E]`` and an optional ``mask [B, N, 1]`` (1 real, 0 padded), per layer::

    qkv  = x @ in_w.T + in_b                                  one product, [B, N, 3E]
    s_h  = q_h @ k_h.T / sqrt(hd) + (mask_j - 1) * 1e30       per head h
    x    = x + concat_h(softmax(s_h) @ v_h) @ out_w.T + out_b
    x    = x + leaky(x @ ff_w.T + ff_b, alpha)

then ``tanh(x @ fc_w.T + fc_b)`` and, with a mask, ``mask - 0.5`` as the last
column. ``exp(-1e30 - max)`` underflows to exactly 0, which equals the model
path's ``-inf``; every jet holds at least one real particle. Padded receivers
are computed like any row.

What bounds it on an H100: 5.9 MFLOP a jet at the default width (N = 30, E = 64,
4 layers, 4 heads) against 9 KB of noise and output a jet, so the FP32 FMA rate.
The kernel's item path stacks the rows of ``G = max(1, 128 // ns)`` jets into
an item (``ns`` = N rounded up to 4: 4 jets of 32 rows at N = 30), keeps the
item's activations transposed in shared memory across all layers, copies each
layer's weights (transposed and stacked over layers, :func:`pack_gapt_weights`)
in k-slabs into shared memory once an item, and walks the items on a
persistent grid of at most one CTA an SM; its launch is planned here
(:func:`gapt_plan`), so that the planning is tested where there is no card.
Sizes the item path does not take (``E % 4 != 0``, a head wider than 32, or
items whose products need more than 8 columns a thread: N > 160 at E = 64) run
the per-jet path, one jet a CTA. The source note has the rest.

The TPU kernel packs ``128 // N`` jets into one block-diagonal attention and
needs a batch divisible by that block; here an item's jets share the
projections but each keeps its own attention, and the last item may be short,
so the gate (:func:`fused_gapt_eligible`) has no batch condition. The rest of
the gate is the JAX package's: generator, eval, no ISAB, no layer norm, no
extra FC layers, no batch or spectral norm, ``E % H == 0``, ``N <= 512``.

The bf16 mode (``StepConfig.bf16``: the D step's fake batch of a bf16 GAPT
step) is the JAX wrapper's own: ``gapt_pallas.gapt_g_fused`` widens ``x``, the
mask and every weight to float32 before its ``pallas_call`` (``:196-213``), runs
the float32 body and rounds the output to ``x.dtype`` (``:251``). Here K9's bf16
entry (``mpgan_gapt_fused_bf16``) reads the bf16 tensors, widens each element
as it stages it, runs the same float32 body and rounds the output at its store,
in one launch with no cast around it; its output is the FP32 launch's on the
widened inputs, rounded. Such a launch is counted under ``gapt_g_fused_bf16``. A
mix of dtypes raises.

The kernel is eval only and has no backward, as in the JAX package: the wrapper
raises when gradients are enabled and an input requires one. It runs the plain
version for tensors on the CPU and the kernel for tensors on a CUDA device;
anything else raises. Launches are counted in ``mp_kernels.launch_counts``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import NamedTuple, Sequence

import torch

from . import _build
from .mp_kernels import (
    MAX_SMEM_BYTES,
    _check_cuda_args,
    _is_bf16,
    _on_cpu,
    _sm_count,
    launch_counts,
)

_NEG = 1e30
MAX_PARTICLES = 512
ITEM_ROWS = 128    # rows an item fills with whole jets (one jet at least)
ITEM_THREADS = 512
MAX_TILE_COLS = 8  # columns of a thread's product tile, at most
MAX_HEAD_DIM = 32  # head width the attention's registers hold, at most


def fused_gapt_eligible(cfg, train: bool) -> bool:
    """Whether ``gapt_g_fused`` computes this config's forward
    (``gapt_pallas.fused_gapt_eligible`` without its batch condition)."""
    la = dict(cfg.linear_args)
    if not cfg.is_generator or train:
        return False
    if cfg.use_isab or cfg.layer_norm:
        return False
    if len(cfg.sab_fc_layers) != 0 or len(cfg.final_fc_layers) != 0:
        return False
    if la.get("batch_norm") or la.get("spectral_norm"):
        return False
    if cfg.embed_dim % cfg.num_heads != 0:
        return False
    return cfg.num_particles <= MAX_PARTICLES


class GaptWeights(NamedTuple):
    """The generator's weights as the kernel reads them: ``[in, out]``, stacked
    over the ``L`` layers, contiguous."""

    in_wt: torch.Tensor   # [L, E, 3E]
    in_b: torch.Tensor    # [L, 3E]
    out_wt: torch.Tensor  # [L, E, E]
    out_b: torch.Tensor   # [L, E]
    ff_wt: torch.Tensor   # [L, E, E]
    ff_b: torch.Tensor    # [L, E]
    fc_wt: torch.Tensor   # [E, F]
    fc_b: torch.Tensor    # [F]


def pack_gapt_weights(layers: Sequence[Sequence[torch.Tensor]], fc_w: torch.Tensor,
                      fc_b: torch.Tensor) -> GaptWeights:
    """Stack per-layer ``(in_w [3E, E], in_b, out_w [E, E], out_b, ff_w [E, E],
    ff_b)`` (weights ``[out, in]``) and the final ``fc_w [F, E]``, ``fc_b``."""
    e = fc_w.shape[1]
    cols = list(zip(*layers)) if layers else [()] * 6
    shapes = ((e, 3 * e), (3 * e,), (e, e), (e,), (e, e), (e,))

    def stack(ts, shape, transpose):
        if not ts:
            return fc_w.new_zeros((0,) + shape)
        return torch.stack([t.t() if transpose else t for t in ts]).contiguous()

    packed = [stack(ts, shape, i % 2 == 0) for i, (ts, shape) in enumerate(zip(cols, shapes))]
    return GaptWeights(*packed, fc_w.t().contiguous(), fc_b.contiguous())


def gapt_g_fused_reference(x: torch.Tensor, mask: torch.Tensor | None, w: GaptWeights,
                           num_heads: int, alpha: float) -> torch.Tensor:
    """Plain PyTorch version of K9 (``gapt_pallas._kernel``'s arithmetic); bf16
    inputs (the bf16 mode): the float32 body on their float32 values, the output
    rounded to bf16."""
    if _is_bf16(*_tensors(x, mask, w)):
        x, mask, w = _widened(x, mask, w)
        return gapt_g_fused_reference(x, mask, w, num_heads, alpha).to(torch.bfloat16)
    b, n, e = x.shape
    hd = e // num_heads
    bias = None if mask is None else ((mask[:, :, 0] - 1.0) * _NEG)[:, None, None, :]
    inv_sqrt_hd = 1.0 / math.sqrt(hd)
    for layer in range(w.in_wt.shape[0]):
        qkv = torch.matmul(x, w.in_wt[layer]) + w.in_b[layer]
        q, k, v = (t.reshape(b, n, num_heads, hd).transpose(1, 2) for t in qkv.split(e, dim=-1))
        sc = torch.matmul(q, k.transpose(-1, -2)) * inv_sqrt_hd
        if bias is not None:
            sc = sc + bias
        p = torch.exp(sc - sc.max(dim=-1, keepdim=True).values)
        p = p / p.sum(dim=-1, keepdim=True)
        attn = torch.matmul(p, v).transpose(1, 2).reshape(b, n, e)
        x = x + torch.matmul(attn, w.out_wt[layer]) + w.out_b[layer]
        ff = torch.matmul(x, w.ff_wt[layer]) + w.ff_b[layer]
        x = x + torch.where(ff >= 0, ff, alpha * ff)
    y = torch.tanh(torch.matmul(x, w.fc_wt) + w.fc_b)
    return y if mask is None else torch.cat([y, mask - 0.5], dim=2)


@dataclasses.dataclass(frozen=True)
class GaptPlan:
    """One K9 launch. On the item path (``jets`` > 0) an item is ``jets`` jets,
    each ``ns`` rows apart (N rounded up to 4), in buffers of ``rows`` rows (a
    multiple of 32); ``grid`` CTAs each walk a contiguous range of the ``items``;
    the two weight slab buffers hold ``slab_floats`` each. ``jets == 0``: the
    per-jet path (one jet a CTA, its launch sized by the kernel)."""
    jets: int
    ns: int
    rows: int
    items: int
    grid: int
    slab_floats: int
    smem_bytes: int

    def item_range(self, cta: int) -> tuple[int, int]:
        return cta * self.items // self.grid, (cta + 1) * self.items // self.grid

    def item_jets(self, item: int, batch: int) -> range:
        """The jets an item computes and stores (the last item may hold fewer)."""
        return range(item * self.jets, min((item + 1) * self.jets, batch))


def item_smem_floats(e: int, rows: int, slab_floats: int) -> int:
    """Shared memory of an item in floats: x^T ``[E, ldr]``, qkv^T ``[3E, ldr]``,
    the senders' mask bias ``[ldr]`` (``ldr = rows + 4``) and two weight slabs."""
    ldr = rows + 4
    return 4 * e * ldr + ldr + 2 * slab_floats


def gapt_plan(batch: int, n: int, e: int, num_heads: int, sms: int) -> GaptPlan:
    """Plan a K9 launch over ``batch`` jets of ``n`` particles, embedding ``e``
    and ``num_heads`` heads, on a card with ``sms`` SMs: the item path where it
    takes the size, with the largest slabs that fit (at most one layer's qkv
    weights), else the per-jet path. Memoised per shape."""
    return _gapt_plan(batch, n, e, num_heads, sms)


@functools.lru_cache(maxsize=256)
def _gapt_plan(batch: int, n: int, e: int, num_heads: int, sms: int) -> GaptPlan:
    ns = -(-n // 4) * 4
    jets = max(1, ITEM_ROWS // ns)
    rows = -(-(jets * ns) // 32) * 32
    row_warps = rows // 32
    col_threads = 8 * ((ITEM_THREADS // 32) // row_warps)
    rest = item_smem_floats(e, rows, 0)
    slab = min(3 * e * e, (MAX_SMEM_BYTES // 4 - rest) // 2 // 4 * 4)
    fits = (e % 4 == 0 and e // num_heads <= MAX_HEAD_DIM
            and -(-3 * e // col_threads) <= MAX_TILE_COLS and slab >= 12 * e)
    if not fits:
        return GaptPlan(0, ns, 0, 0, 0, 0, 0)
    items = -(-batch // jets)
    return GaptPlan(jets, ns, rows, items, min(sms, items), slab,
                    4 * item_smem_floats(e, rows, slab))


def _check_shapes(name: str, x, mask, w: GaptWeights, num_heads: int) -> None:
    if x.dim() != 3:
        raise ValueError(f"{name}: x {tuple(x.shape)} must be [B, N, E]")
    b, n, e = x.shape
    if e % num_heads or num_heads < 1:
        raise ValueError(f"{name}: embed_dim {e} is not divisible by {num_heads} heads")
    if not 1 <= n <= MAX_PARTICLES:
        raise ValueError(f"{name}: {n} particles exceed the kernel cap {MAX_PARTICLES}")
    if mask is not None and mask.shape != (b, n, 1):
        raise ValueError(f"{name}: mask {tuple(mask.shape)} must be [{b}, {n}, 1]")
    layers = w.in_wt.shape[0]
    want = ((layers, e, 3 * e), (layers, 3 * e), (layers, e, e), (layers, e), (layers, e, e),
            (layers, e))
    for field, t, shape in zip(w._fields, w, want):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {field} {tuple(t.shape)} must be {shape}")
    if w.fc_wt.dim() != 2 or w.fc_wt.shape[0] != e or w.fc_b.shape != (w.fc_wt.shape[1],):
        raise ValueError(f"{name}: fc_wt {tuple(w.fc_wt.shape)}, fc_b {tuple(w.fc_b.shape)} "
                         f"must be [{e}, F], [F]")


def _tensors(x, mask, w: GaptWeights) -> tuple:
    return (x, *w) if mask is None else (x, mask, *w)


def _widened(x, mask, w: GaptWeights):
    """The float32 values of bf16 inputs (``gapt_pallas.py:196-213``), as the plain
    version takes them."""
    return x.float(), None if mask is None else mask.float(), GaptWeights(*(t.float() for t in w))


def gapt_g_fused(x: torch.Tensor, mask: torch.Tensor | None, w: GaptWeights, num_heads: int,
                 alpha: float) -> torch.Tensor:
    """K9: the plain version on the CPU, the CUDA kernel on a GPU. Returns
    ``[B, N, F (+1 with a mask)]`` in the inputs' dtype: all float32, or all
    bf16 for the bf16 mode (K9's bf16 entry: its float32 body on the widened
    values, the output rounded to bf16; its own count). Eval only: raises where a
    gradient is asked for."""
    tensors = _tensors(x, mask, w)
    bf16 = _is_bf16(*tensors)
    name = "gapt_g_fused" + ("_bf16" if bf16 else "")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{name} is eval only and has no backward: call it under "
                           "torch.no_grad(), or take the model's plain path")
    _check_shapes(name, x, mask, w, num_heads)
    if _on_cpu(*tensors):
        return gapt_g_fused_reference(x, mask, w, num_heads, alpha)
    _check_cuda_args(name, {"x": x, **({} if mask is None else {"mask": mask}),
                            **dict(zip(w._fields, w))}, (w.in_wt, w.out_wt, w.ff_wt), x.dtype)
    b, n, e = x.shape
    feat = w.fc_wt.shape[1]
    out = torch.empty((b, n, feat + (mask is not None)), dtype=x.dtype, device=x.device)
    lib = _build.library()
    plan = gapt_plan(b, n, e, num_heads, _sm_count(x.device))
    scratch = None
    if not plan.jets:
        grid, scratch_floats = ctypes.c_int(), ctypes.c_longlong()
        _build.check(lib.mpgan_gapt_fused_plan(b, n, e, num_heads, ctypes.byref(grid),
                                               ctypes.byref(scratch_floats)), name)
        if scratch_floats.value:
            scratch = torch.empty((scratch_floats.value,), dtype=torch.float32, device=x.device)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    with torch.cuda.device(x.device):
        code = (lib.mpgan_gapt_fused_bf16 if bf16 else lib.mpgan_gapt_fused)(
            x.data_ptr(), ptr(mask), out.data_ptr(), *(t.data_ptr() for t in w), ptr(scratch),
            b, n, e, num_heads, w.in_wt.shape[0], feat, float(alpha), plan.jets, plan.rows,
            plan.grid, plan.slab_floats, torch.cuda.current_stream().cuda_stream,
        )
    _build.check(code, name)
    launch_counts[name] += 1
    return out
