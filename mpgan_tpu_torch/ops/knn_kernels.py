"""knn message-passing edge kernels: plain PyTorch versions and CUDA wrappers.

Counterpart of ``mpgan_tpu/ops/knn_pallas.py``, as :mod:`.mp_kernels` is of
``mp_pallas.py``: its fully fused generation (``_fused_kernel_v4`` forward,
``_bwd_kernel_v3`` backward) and its older split one, a search kernel followed
by an aggregate kernel fed with ``idx``:

- ``knn_fused_layer`` (K5, ``csrc/knn_fused.cu``): per jet, the neighbour
  search, the sender gather, the edge MLP and the masked aggregation over the
  ``k`` neighbours in one kernel (the search is K7's, the chain the forward
  pass of K2 and K4)::

      d[i, j]   = (-2 xs[i] | 1) . (xf[j] | |xf[j]|^2) + |xs[i]|^2
      key[i, j] = bits(max(d, 0)) & ~(2^bits - 1) | j,   bits = max(8, bitlen(n - 1))
      idx[i, s] = the sender of the s-th smallest key of row i
                  (the first dropped without self loops)
      z1        = u1[i] + u2m[idx[i, s], :H1] (+ dist[i, s] * w_d)
      agg[i]    = sum_s u2m[idx[i, s], H1] * chain(leaky(z1))      (/ k for the mean)

  ``xs`` are the receivers' selection features, ``xf`` the senders' with masked
  particles pushed away, ``u1``/``u2m = [u2 | mask]`` the decomposed first fe
  layer (bias and per-jet conditioning folded into ``u2``), ``chain`` the
  hidden fe layers ``hidden_flat = (w2, b2, ...)`` with weights ``[in, out]``
  and LeakyReLU after each. ``dist = |xf[idx] - xs + 1e-12|`` is computed on
  the selected edges when ``want_dists``. With ``dropout_p > 0`` every
  activation is multiplied by the K1 hash multiplier, keyed on the pair id
  ``b*n*k + i*k + s`` (the extraction rank ``s`` is part of the id, so the
  neighbours come out in ascending key order), salt 0 after layer 1 and
  ``l`` after hidden layer ``l``. A launch that feeds a backward also returns
  ``idx`` (int32 ``[B, N, k]``) and ``dists``.
- ``knn_edge_aggregate_bwd`` (K6, ``csrc/knn_edge_bwd.cu``): the backward from
  ``idx``/``dists``. It recomputes the chain, replays the dropout masks and
  returns ``du1`` (sum over ``k``), ``du2`` and ``dmask`` (scatter-add into the
  sender rows), ``ddists``, ``dw_d`` and the hidden layers' weight and bias
  gradients (zeros with ``need_wgrads=False``).
- :class:`KnnFusedLayer`: the autograd ``Function`` of K5 and K6. The selection
  is detached and the distances are differentiable, as in the JAX package: the
  ``ddists -> dxs, dxf`` step is plain torch.
- ``knn_search`` (K7, ``csrc/knn_search.cu``): K5's search stage alone, ``idx``
  and, with ``want_dists``, the selected edges' exact distances. Replaces
  ``knn_select`` and ``knn_select_nm``; the latter's neighbour-major
  ``[B, k*NP8, 1]`` output is a TPU layout, here both stay ``[B, N, k]``.
  :class:`KnnSearch` carries the distances' gradient (plain torch).
- ``knn_edge_aggregate`` (K8, ``csrc/knn_edge_aggregate.cu``): K5 without the
  search, from a given ``idx`` (and ``dists``). Replaces the forwards of the three older
  aggregate generations (``_fwd_impl``, ``_fwd_impl_v2``, ``_fwd_impl_v3``): one
  function with one dropout mask in three TPU row layouts. :class:`KnnEdgeAggregate`
  pairs it with K6, which is also those generations' backward.
  :func:`knn_aggregate_split` chains K7, K8 (and K6).

Each takes all-float32 tensors, or all-bf16 ones for the bf16 mode
(``StepConfig.bf16``; the Pallas kernels called with bf16 refs), ``idx`` int32
and ``dists`` float32 in both: the search on the float32 values of ``xs`` and
``xf`` (so the same keys, ``idx`` and float32 distances), ``z1`` and a_0 in
float32 (``dist * f32(w_d)`` included), each hidden product on bf16-rounded
activations and bf16 weights with float32 accumulation, the masked sum and the
mean in float32 and the output rounded to bf16 once; K6's backward products in
float32 on the weights' float32 values, its gradients rounded once to the
primals' dtypes (``ddists`` float32, the distances' dtype). On the card the
bf16 mode has kernels of its own (``csrc/knn_fused_bf16.cu`` for K5 and K8,
``knn_edge_bwd_bf16.cu`` for K6, ``knn_search.cu``'s bf16 entry for K7: the
hidden products on tensor cores) and launch counts of its own (``*_bf16``). A
mix of dtypes raises.

The neighbour sets of two implementations may differ only at near-ties:
sums taken in another order move a ``d`` by an ulp, and a key sits on a
bucket edge once in a while. :func:`compare_neighbours` counts such rows and
checks that the swapped senders' keys are within one bucket step.

K5 and K8 run on a persistent grid whose launch is planned here
(:func:`knn_fwd_plan`: the pass, the items, the grid, K5's search span, the
weight slabs), so that the planning is tested where there is no card. A wrapper
runs the plain version for tensors on the CPU, and the kernel for tensors on a
CUDA device; anything else raises. Launches are counted in
``mp_kernels.launch_counts``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Sequence

import torch
from torch.autograd.function import once_differentiable

from . import _build
from .linear import _M32, dropout_threshold_mult
from .mp_kernels import (
    BWD_SLAB_FLOATS,
    BWD_THREADS,
    FWD_SLAB_FLOATS,
    MAX_SMEM_BYTES,
    MAX_WIDTH,
    _bf16_operand,
    _chain_args,
    _chain_dims,
    _check_cuda_args,
    _check_dropout,
    _dleaky,
    _dropmul,
    _flat_wgrads,
    _fwd_rest_floats,
    _is_bf16,
    _leaky,
    _on_cpu,
    _pairs,
    _product_cost,
    _sm_count,
    bwd_packed_floats,
    bwd_packed_floats_bf16,
    bwd_wslab_floats,
    bwd_plan,
    fwd_packed_floats,
    fwd_packed_floats_bf16,
    launch_counts,
    seed_arg,
    tile_plan_core,
)


def key_bits(n: int) -> int:
    """Low key bits that hold the sender index (``knn_pallas.py:1727``)."""
    return max(8, (n - 1).bit_length())


def knn_pair_ids(b: int, n: int, k: int, device) -> torch.Tensor:
    """``[B, N, k, 1]`` global pair ids ``b*n*k + i*k + s`` mod 2**32 as int32
    bit patterns (``knn_pallas._v3_ids_at``; unpadded ``n``, unlike the dense ids)."""
    ar = lambda m: torch.arange(m, dtype=torch.int64, device=device)  # noqa: E731
    ids = ar(b)[:, None, None] * (n * k) + ar(n)[None, :, None] * k + ar(k)[None, None, :]
    return (((ids + 2**31) & _M32) - 2**31).to(torch.int32)[..., None]


def _sq_norm(x: torch.Tensor) -> torch.Tensor:
    """``sum_c x_c^2`` over the last axis, each product and each sum rounded on
    its own, in column order."""
    s = x[..., 0] * x[..., 0]
    for c in range(1, x.shape[-1]):
        s = s + x[..., c] * x[..., c]
    return s


def knn_keys(xs: torch.Tensor, xf: torch.Tensor) -> torch.Tensor:
    """The packed int32 selection keys ``[B, N, N]`` (receiver, sender): the
    float32 bits of the squared distance with the low :func:`key_bits` bits
    replaced by the sender index, so keys are unique and ties inside a
    truncation bucket break by index.

    ``d = (-2 xs | 1) . (xf | |xf|^2) + |xs|^2`` is summed term by term in
    column order, every product and every sum rounded to float32 on its own (no
    fused multiply-add, no library matmul). K5 takes the same steps in the same
    order, so the kernel and this version build the same keys bit for bit, on
    any device; against another implementation of the formula (the JAX
    package's matmul) a ``d`` may move by an ulp, see :func:`compare_neighbours`."""
    n, c = xs.shape[1], xs.shape[2]
    a = -2.0 * xs
    d = a[:, :, None, 0] * xf[:, None, :, 0]
    for col in range(1, c):
        d = d + a[:, :, None, col] * xf[:, None, :, col]
    d = d + _sq_norm(xf)[:, None, :]
    d = d + _sq_norm(xs)[:, :, None]
    d = torch.where(d > 0, d, torch.zeros_like(d))
    low = (1 << key_bits(n)) - 1
    cols = torch.arange(n, dtype=torch.int32, device=xs.device)
    return (d.contiguous().view(torch.int32) & ~low) | cols


def knn_select_reference(xs, xf, k: int, self_loops: bool) -> torch.Tensor:
    """int32 ``[B, N, k]`` neighbours in ascending key order: ``k`` (or ``k + 1``,
    the first dropped) min-extractions of the packed keys (of the float32 values
    of bf16 inputs)."""
    start = 0 if self_loops else 1
    keys = knn_keys(xs.float(), xf.float())
    low = (1 << key_bits(xs.shape[1])) - 1
    smallest = torch.topk(keys, k + start, dim=-1, largest=False, sorted=True).values
    return (smallest[..., start:] & low).contiguous()


def compare_neighbours(idx: torch.Tensor, idx_ref: torch.Tensor, keys_ref: torch.Tensor,
                       sender_mask: torch.Tensor | None = None
                       ) -> tuple[torch.Tensor, int, int]:
    """Hold ``idx`` against ``idx_ref`` (both ``[B, N, k]``) under the near-tie
    rule. Positions where both selected senders are masked (``sender_mask``
    ``[B, N, 1]``, 0 = masked) are not compared: their order is set by
    cancellation at the scale of the pushed-away coordinates and their edges
    carry weight 0. Returns ``(agree [B, N] bool, differing rows, bad rows)``;
    a differing row is bad when at some position the two senders' reference
    keys are more than one bucket step apart."""
    n = keys_ref.shape[-1]
    bits = key_bits(n)
    a, r = idx.long(), idx_ref.long()
    differ = a != r
    if sender_mask is not None:
        m = sender_mask[..., 0]
        live = (torch.gather(m[:, None, :].expand(-1, n, -1), 2, a) != 0) | \
               (torch.gather(m[:, None, :].expand(-1, n, -1), 2, r) != 0)
        differ = differ & live
    bucket_a = torch.gather(keys_ref, 2, a) >> bits
    bucket_r = torch.gather(keys_ref, 2, r) >> bits
    far = differ & ((bucket_a - bucket_r).abs() > 1)
    agree = ~differ.any(dim=-1)
    return agree, int((~agree).sum()), int(far.any(dim=-1).sum())


def _gather_rows(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``t [B, N, F]`` rows at ``idx [B, N, k]`` -> ``[B, N, k, F]``."""
    b, n, k = idx.shape
    flat = idx.long().reshape(b, n * k, 1).expand(-1, -1, t.shape[-1])
    return torch.gather(t, 1, flat).reshape(b, n, k, t.shape[-1])


def _edge_dists(xs, xf, idx):
    """``|xf[idx] - xs + 1e-12|`` on the selected edges, ``[B, N, k]``; also the
    shifted differences. In the inputs' dtype: the forwards pass float32 values."""
    diffs = _gather_rows(xf, idx) - xs[:, :, None, :] + 1e-12
    return torch.sqrt((diffs * diffs).sum(dim=-1)), diffs


def _knn_chain(u1, u2m, idx, dists, w_d, hidden_flat, alpha, dropout_p, seed):
    """Pre-activations, activations (after dropout) and dropout multipliers of
    every layer on the selected edges ``[B, N, k, H_l]``, and the gathered
    sender mask ``[B, N, k, 1]``. bf16 inputs (the bf16 mode,
    ``knn_pallas._fused_kernel_v4``): everything is float32 but each hidden
    product's operand, rounded to bf16 (as ``mp_kernels._chain_recompute``)."""
    h1 = u1.shape[-1]
    b, n, k = idx.shape
    bf16 = u1.dtype == torch.bfloat16
    if bf16:
        u1, u2m = u1.float(), u2m.float()
        w_d = None if w_d is None else w_d.float()
        hidden_flat = [t.float() for t in hidden_flat]
    g2 = _gather_rows(u2m, idx)
    z = u1[:, :, None, :] + g2[..., :h1]
    if dists is not None:
        z = z + dists[..., None] * w_d
    ids = knn_pair_ids(b, n, k, u1.device) if dropout_p > 0 else None
    pairs = _pairs(hidden_flat)
    zs, acts, mults = [], [], []
    for salt in range(len(pairs) + 1):
        if salt:
            w, bias = pairs[salt - 1]
            z = torch.matmul(_bf16_operand(acts[-1]) if bf16 else acts[-1], w) + bias
        a = _leaky(z, alpha)
        m = _dropmul(ids, z.shape[-1], dropout_p, seed, salt) if dropout_p > 0 else None
        zs.append(z)
        mults.append(m)
        acts.append(a if m is None else a * m)
    return zs, acts, mults, g2[..., h1:]


def _masked_agg(u1, u2m, idx, dists, w_d, hidden_flat, alpha, sum_agg, dropout_p, seed):
    """The masked sum over the ``k`` edges (``/ k`` for the mean), in float32 for
    bf16 inputs and then rounded to bf16 once (``knn_pallas.py:2004``)."""
    _, acts, _, smask = _knn_chain(u1, u2m, idx, dists, w_d, hidden_flat, alpha, dropout_p, seed)
    agg = (acts[-1] * smask).sum(dim=2)
    if not sum_agg:
        agg = agg / idx.shape[2]
    return agg.to(u1.dtype)


def knn_fused_layer_reference(xs, xf, u1, u2m, w_d, hidden_flat, k: int, self_loops: bool,
                              want_dists: bool, alpha: float, sum_agg: bool,
                              dropout_p: float = 0.0, seed=0, emit_idx: bool = False):
    """Plain PyTorch version of K5 (``knn_pallas._fused_kernel_v4``). Returns
    ``(agg, idx, dists)``; ``idx`` and ``dists`` (float32) are None unless
    ``emit_idx`` (and ``want_dists``)."""
    idx = knn_select_reference(xs, xf, k, self_loops)
    dists = _edge_dists(xs.float(), xf.float(), idx)[0] if want_dists else None
    agg = _masked_agg(u1, u2m, idx, dists, w_d, hidden_flat, alpha, sum_agg, dropout_p, seed)
    return agg, (idx if emit_idx else None), (dists if emit_idx else None)


def knn_edge_aggregate_bwd_reference(u1, u2m, idx, dists, w_d, hidden_flat, g, alpha: float,
                                     sum_agg: bool, dropout_p: float = 0.0, seed=0,
                                     need_wgrads: bool = True):
    """Plain PyTorch version of K6 (``knn_pallas._bwd_kernel_v3``). Returns
    ``(du1, du2, dmask, ddists, dw_d, dhidden_flat)``; ``ddists``/``dw_d`` are
    None without ``dists``; the weight gradients are zeros without
    ``need_wgrads``. bf16 inputs select the bf16 mode: the recompute rounds as
    the forward's, the backward runs in float32 (dW on the unrounded
    activations, da on the float32 values of the bf16 weights), and every
    gradient is rounded once to its primal's dtype (``ddists`` stays float32,
    the distances' dtype), as the JAX custom VJP casts them."""
    b, n, k = idx.shape
    h1 = u1.shape[-1]
    dtypes = (u1.dtype, u2m.dtype, None if w_d is None else w_d.dtype,
              [t.dtype for t in hidden_flat])
    zs, acts, mults, smask = _knn_chain(u1, u2m, idx, dists, w_d, hidden_flat, alpha, dropout_p,
                                        seed)
    if u1.dtype == torch.bfloat16:
        g = g.float()
        w_d = None if w_d is None else w_d.float()
        hidden_flat = [t.float() for t in hidden_flat]
    pairs = _pairs(hidden_flat)
    if not sum_agg:
        g = g / k
    g_rows = g[:, :, None, :]
    dsmask = (acts[-1] * g_rows).sum(dim=-1)  # [B, N, k]
    da = g_rows * smask
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
    flat = (idx.long() + torch.arange(b, device=idx.device)[:, None, None] * n).reshape(-1)
    du2 = torch.zeros(b * n, h1, dtype=dz.dtype, device=dz.device)
    du2.index_add_(0, flat, dz.reshape(-1, h1))
    dmask = torch.zeros(b * n, dtype=dz.dtype, device=dz.device)
    dmask.index_add_(0, flat, dsmask.reshape(-1))
    ddists = dw_d = None
    if dists is not None:
        ddists = (dz * w_d).sum(dim=-1)
        dw_d = (dists[..., None] * dz).sum(dim=(0, 1, 2)) if need_wgrads \
            else torch.zeros_like(w_d)
        dw_d = dw_d.to(dtypes[2])
    return (dz.sum(dim=2).to(dtypes[0]), du2.reshape(b, n, h1).to(dtypes[1]),
            dmask.reshape(b, n, 1).to(dtypes[1]), ddists, dw_d,
            tuple(t.to(dt) for t, dt in zip(dhidden, dtypes[3])))


# ---------------------------------------------------------------------------
# The forward kernels' plan (csrc/knn_stages.cuh checks it on the card)
# ---------------------------------------------------------------------------

KNN_ROW_ARRAYS = 5  # u1, u2, id, mask and the edge's distance


def search_ldn(n: int) -> int:
    """Row stride of the search's ``xf^T``: n rounded up to 4, then to an odd
    number of 4-float groups (``knn_stages.cuh: search_ldn``)."""
    ldn = -(-n // 4) * 4
    return ldn + 4 if (ldn // 4) % 2 == 0 else ldn


def search_cols(c: int) -> int:
    """Rows of the search's ``xf^T``: ``c`` rounded up to 4, 8, 16 or 32 (zero
    columns, so that the key loops have a fixed length), ``c`` itself past 32
    (``knn_stages.cuh: search_cols``)."""
    return next((w for w in (4, 8, 16, 32) if c <= w), c)


SEARCH_LIST = 21  # keys a search thread keeps sorted in registers
SEARCH_MERGE_INTS = 3 * 128 * SEARCH_LIST  # lists handed between thread groups, at most


def knn_search_floats(n: int, c: int) -> int:
    """Floats of the search's scratch: ``xf^T`` and the norms,
    ``[search_cols(c) + 1, search_ldn(n)]``, then the lists that the threads of
    a receiver hand to one another (the lists themselves live in registers)."""
    return (search_cols(c) + 1) * search_ldn(n) + SEARCH_MERGE_INTS


def _knn_rest_floats(dims, rows, ti, n, c, k, sspan, search) -> int:
    """A knn forward pass's shared memory but its weight slabs: the dense
    forward's with the distance row array, K5's search scratch inside the region
    before the slabs, and its neighbours and distances ``[sspan, k]`` after the rest."""
    return (_fwd_rest_floats(dims, rows, ti, None, KNN_ROW_ARRAYS,
                             knn_search_floats(n, c) if search else 0)
            + (2 * sspan * k if search else 0))


def knn_fwd_slab_floats(dims: Sequence[int], rows: int, ti: int, n: int, c: int, k: int,
                        sspan: int, search: bool) -> int:
    """Floats of each of the two weight slab buffers: the largest size that fits
    beside the rest, else the least."""
    rest = _knn_rest_floats(dims, rows, ti, n, c, k, sspan, search)
    return next((s for s in FWD_SLAB_FLOATS if 4 * (rest + 2 * s) <= MAX_SMEM_BYTES),
                BWD_SLAB_FLOATS)


def knn_fwd_smem_bytes(dims: Sequence[int], rows: int, ti: int, n: int, c: int, k: int,
                       sspan: int, search: bool) -> int:
    """Shared memory of a K5 (``search``) or K8 launch at a pass of ``rows`` rows
    and ``ti`` receivers, searches of at most ``sspan`` receivers."""
    return 4 * (_knn_rest_floats(dims, rows, ti, n, c, k, sspan, search)
                + 2 * knn_fwd_slab_floats(dims, rows, ti, n, c, k, sspan, search))


@dataclasses.dataclass(frozen=True)
class KnnFwdPlan:
    """One launch of K5 or K8: a pass is ``ti`` receivers x ``kc`` neighbour
    ranks in buffers of ``rows`` pair rows, a receiver taking ``rs = max(kc, 8)``
    of them; an item is a block of ``ti`` receivers of one jet (``blocks`` a jet),
    walked over the ranks in chunks of ``kc``; ``grid`` CTAs each walk a
    contiguous range of the ``items``. K5 searches the receivers of a jet that a
    CTA's range holds, at most ``sspan`` at a time (0: K8, no search). The two
    weight slab buffers hold ``slab_floats`` each."""
    ti: int
    kc: int
    rows: int
    blocks: int
    items: int
    grid: int
    sspan: int
    slab_floats: int
    smem_bytes: int

    @property
    def rs(self) -> int:
        return max(self.kc, 8)

    def item_range(self, cta: int) -> tuple[int, int]:
        return cta * self.items // self.grid, (cta + 1) * self.items // self.grid

    def item_receivers(self, item: int, n: int) -> tuple[int, range]:
        """The jet of an item and its receivers in that jet."""
        b, blk = divmod(item, self.blocks)
        return b, range(blk * self.ti, min((blk + 1) * self.ti, n))

    def pass_rows(self, item: int, s0: int, n: int, k: int) -> list[tuple[int, int, int, int, int]]:
        """The real rows of an item's pass over the ranks from ``s0``, as the
        kernel fills them: ``(row, jet, receiver, rank, K1 id mod 2**32)``."""
        b, recv = self.item_receivers(item, n)
        kc_eff = min(self.kc, k - s0)
        out = []
        for r in range(self.rows):
            ii, ss = divmod(r, self.rs)
            if ii < len(recv) and ss < kc_eff:
                i, s = recv.start + ii, s0 + ss
                out.append((r, b, i, s, ((b * n + i) * k + s) & _M32))
        return out


def knn_fwd_plan(batch: int, n: int, c: int, k: int, dims: Sequence[int], sms: int,
                 search: bool = True) -> KnnFwdPlan:
    """Plan a K5 (``search``) or K8 launch over ``batch`` jets of ``n``
    particles with ``c`` selection features (unused without the search), ``k``
    neighbours and the fe chain ``dims``, on a card with ``sms`` SMs: the pass
    that gives the busiest CTA the least arithmetic among those that fit in
    shared memory (ties: longer rank chunks, then more receivers a pass), and
    K5's search over a whole jet where its neighbours fit, else over as many
    blocks as do. Memoised per shape."""
    return _knn_fwd_plan(batch, n, c, k, tuple(dims), sms, bool(search))


@functools.lru_cache(maxsize=256)
def _knn_fwd_plan(batch: int, n: int, c: int, k: int, dims: tuple, sms: int,
                  search: bool) -> KnnFwdPlan:
    best = None
    for rows in (128, 64, 32):
        per_pass = _product_cost(dims, rows) + rows * dims[0] // BWD_THREADS  # + a_0
        for kc in range(1, min(k, rows) + 1):
            rs = max(kc, 8)
            if rs > rows:
                continue
            ti = min(rows // rs, n)
            blocks = -(-n // ti)
            spans = [n] + [m * ti for m in range(blocks - 1, 0, -1)] if search else [0]
            fits = [s for s in spans
                    if knn_fwd_smem_bytes(dims, rows, ti, n, c, k, s, search) <= MAX_SMEM_BYTES]
            if not fits:
                continue
            sspan = fits[0]
            items = batch * blocks
            grid = min(sms, items)
            key = (-(-items // grid) * -(-k // kc) * per_pass, -kc, -ti)
            if best is None or key < best[0]:
                best = (key, KnnFwdPlan(
                    ti, kc, rows, blocks, items, grid, sspan,
                    knn_fwd_slab_floats(dims, rows, ti, n, c, k, sspan, search),
                    knn_fwd_smem_bytes(dims, rows, ti, n, c, k, sspan, search)))
    if best is None:
        raise ValueError(f"layer widths {list(dims)} at n={n} k={k} c={c} do not fit the knn "
                         f"forward kernel's shared memory ({MAX_SMEM_BYTES} bytes)")
    return best[1]


def bf16_tile_plan(batch: int, n: int, c: int, k: int, dims: Sequence[int], sms: int,
                   search: bool = True):
    """Plan a K5 (``search``) or K8 launch in the bf16 mode, on the bf16 forward
    pass (``mp_kernels.tile_plan_core``): the rank chunk from K8's FP32 plan
    (:func:`knn_fwd_plan` without the search) for both, so that K8 on K5's
    ``idx`` sums as K5 does; K5's search chunks hold as many of a CTA's items
    as fit beside its scratch. Memoised per shape."""
    return _bf16_tile_plan(batch, n, c, k, tuple(dims), sms, bool(search))


@functools.lru_cache(maxsize=256)
def _bf16_tile_plan(batch: int, n: int, c: int, k: int, dims: tuple, sms: int, search: bool):
    fp32 = knn_fwd_plan(batch, n, 0, k, dims, sms, search=False)
    return tile_plan_core(batch, n, dims, sms, fp32.ti, fp32.kc, knn_k=k,
                          search_floats=knn_search_floats(n, c) if search else 0)


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------


def _check_search_shapes(name, xs, xf, k, self_loops):
    if xs.dim() != 3 or xf.shape != xs.shape:
        raise ValueError(f"{name}: xs {tuple(xs.shape)} and xf {tuple(xf.shape)} must be [B, N, C]")
    n, c = xs.shape[1:]
    if not 1 <= c <= MAX_WIDTH:
        raise ValueError(f"{name}: {c} selection features exceed the kernel cap {MAX_WIDTH}")
    if k < 1 or k + (0 if self_loops else 1) > n:
        raise ValueError(
            f"{name}: k={k} (+{0 if self_loops else 1} dropped self) exceeds the {n} "
            "available senders"
        )


def _check_knn_shapes(name, xs, xf, u1, u2m, w_d, pairs, k, self_loops, want_dists):
    _check_search_shapes(name, xs, xf, k, self_loops)
    if u1.dim() != 3 or u1.shape[:2] != xs.shape[:2]:
        raise ValueError(f"{name}: u1 {tuple(u1.shape)} must be "
                         f"[{xs.shape[0]}, {xs.shape[1]}, H1]")
    _check_u2m(name, u1, u2m, w_d, want_dists)
    return _chain_dims(name, "hidden", [u1.shape[2]], pairs)


def _check_u2m(name, u1, u2m, w_d, want_dists):
    b, n, h1 = u1.shape
    if u2m.shape != (b, n, h1 + 1):
        raise ValueError(f"{name}: u2m {tuple(u2m.shape)} must be [{b}, {n}, {h1 + 1}] "
                         "([u2 | mask])")
    if want_dists and (w_d is None or w_d.shape != (h1,)):
        raise ValueError(f"{name}: want_dists needs w_d of shape ({h1},)")


def _check_dists_dtype(name, dists):
    """The distances are float32 in both modes (``knn_pallas.py:2011``)."""
    if dists is not None and dists.dtype != torch.float32:
        raise TypeError(f"{name}: dists must be float32, got {dists.dtype}")


def knn_fused_layer(xs, xf, u1, u2m, w_d, hidden_flat, k: int, self_loops: bool,
                    want_dists: bool, alpha: float, sum_agg: bool, dropout_p: float = 0.0,
                    seed=0, emit_idx: bool = False):
    """K5: the plain version on the CPU, the CUDA kernel on a GPU. Returns
    ``(agg, idx, dists)`` like :func:`knn_fused_layer_reference`; all inputs
    float32, or all bf16 for the bf16 mode (its own kernel and count)."""
    hidden_flat = tuple(hidden_flat)
    w_d = w_d if want_dists else None
    extra = () if w_d is None else (w_d,)
    bf16 = _is_bf16(xs, xf, u1, u2m, *extra, *hidden_flat)
    name = ("knn_fused_layer_train" if emit_idx else "knn_fused_layer") + ("_bf16" if bf16 else "")
    _check_dropout(name, dropout_p, seed)
    pairs = _pairs(hidden_flat)
    dims = _check_knn_shapes(name, xs, xf, u1, u2m, w_d, pairs, k, self_loops, want_dists)
    if _on_cpu(xs, xf, u1, u2m, *extra, *hidden_flat):
        return knn_fused_layer_reference(xs, xf, u1, u2m, w_d, hidden_flat, k, self_loops,
                                         want_dists, alpha, sum_agg, dropout_p, seed, emit_idx)
    _check_cuda_args(name, {"xs": xs, "xf": xf, "u1": u1, "u2m": u2m,
                            **({} if w_d is None else {"w_d": w_d}),
                            **{f"hidden[{i}]": t for i, t in enumerate(hidden_flat)}},
                     hidden_flat[::2], u1.dtype)
    b_sz, n, c = xs.shape
    dev = xs.device
    out = torch.empty((b_sz, n, dims[-1]), dtype=u1.dtype, device=dev)
    idx = torch.empty((b_sz, n, k), dtype=torch.int32, device=dev) if emit_idx else None
    dists = torch.empty((b_sz, n, k), dtype=torch.float32, device=dev) \
        if emit_idx and want_dists else None
    plan = (bf16_tile_plan if bf16 else knn_fwd_plan)(b_sz, n, c, k, dims, _sm_count(dev))
    # the kernel's own copy of the weights, laid out for its products
    packed_floats = fwd_packed_floats_bf16(dims) if bf16 else \
        fwd_packed_floats(dims, plan.rows)
    packed = torch.empty((max(packed_floats, 1),), dtype=torch.float32, device=dev)
    lib = _build.library()
    w, bias = _chain_args(pairs)
    dim_arr = (ctypes.c_int * len(dims))(*dims)
    thr, mult = dropout_threshold_mult(dropout_p) if dropout_p > 0 else (0, 1.0)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    seed_t = seed_arg(name, seed, dev) if dropout_p > 0 else None
    seed_ptr = ptr(seed_t)
    with torch.cuda.device(dev):
        ptrs = (xs.data_ptr(), xf.data_ptr(), u1.data_ptr(), u2m.data_ptr(), ptr(w_d),
                out.data_ptr(), ptr(idx), ptr(dists), packed.data_ptr())
        rest = (b_sz, n, c, dims[0], k, int(bool(self_loops)), int(bool(want_dists)), len(pairs),
                w, bias, dim_arr, float(alpha), int(bool(sum_agg)), int(dropout_p > 0), seed_ptr,
                thr, mult)
        stream = torch.cuda.current_stream().cuda_stream
        if bf16:
            code = lib.mpgan_knn_fused_layer_bf16(*ptrs, packed_floats, *rest, plan.width,
                                                  plan.warps, int(plan.resident), plan.ti,
                                                  plan.jc, plan.sspan_items, plan.grid, stream)
        else:
            code = lib.mpgan_knn_fused_layer(*ptrs, *rest, plan.ti, plan.kc, plan.rows,
                                             plan.sspan, plan.grid, plan.slab_floats, stream)
    _build.check(code, name)
    launch_counts[name] += 1
    return out, idx, dists


def knn_edge_aggregate_bwd(u1, u2m, idx, dists, w_d, hidden_flat, g, alpha: float,
                           sum_agg: bool, dropout_p: float = 0.0, seed=0,
                           need_wgrads: bool = True):
    """K6: the plain backward on the CPU, the CUDA kernel on a GPU. Returns
    ``(du1, du2, dmask, ddists, dw_d, dhidden_flat)``; all inputs float32, or all
    bf16 but ``dists`` for the bf16 mode (its own kernel and count; the
    gradients summed in float32 and rounded once to the primals' dtypes)."""
    hidden_flat = tuple(hidden_flat)
    want_dists = dists is not None
    w_d = w_d if want_dists else None
    extra = (dists, w_d) if want_dists else ()
    bf16 = _is_bf16(u1, u2m, g, *(t for t in extra[1:] if t is not None), *hidden_flat)
    name = ("knn_edge_aggregate_bwd" if need_wgrads else "knn_edge_aggregate_bwd_no_wgrads") + \
        ("_bf16" if bf16 else "")
    _check_dropout(name, dropout_p, seed)
    _check_dists_dtype(name, dists)
    if u1.dim() != 3:
        raise ValueError(f"{name}: u1 {tuple(u1.shape)} must be [B, N, H1]")
    _check_u2m(name, u1, u2m, w_d, want_dists)
    b_sz, n, h1 = u1.shape
    if idx.dim() != 3 or idx.shape[:2] != (b_sz, n) or idx.dtype != torch.int32:
        raise ValueError(f"{name}: idx must be int32 [{b_sz}, {n}, k], got {idx.dtype} "
                         f"{tuple(idx.shape)}")
    k = idx.shape[2]
    if want_dists and dists.shape != idx.shape:
        raise ValueError(f"{name}: dists {tuple(dists.shape)} must be {tuple(idx.shape)}")
    pairs = _pairs(hidden_flat)
    dims = _chain_dims(name, "hidden", [h1], pairs)
    if g.shape != (b_sz, n, dims[-1]):
        raise ValueError(f"{name}: g {tuple(g.shape)} must be {(b_sz, n, dims[-1])}")
    if _on_cpu(u1, u2m, idx, g, *extra, *hidden_flat):
        return knn_edge_aggregate_bwd_reference(u1, u2m, idx, dists, w_d, hidden_flat, g, alpha,
                                                sum_agg, dropout_p, seed, need_wgrads)
    if alpha <= 0:
        # the kernel reads LeakyReLU's slope off the sign of the stored activation
        raise ValueError(f"{name}: the kernel needs leaky_relu_alpha > 0, got {alpha}")
    if not idx.is_contiguous():
        raise ValueError(f"{name}: idx must be contiguous")
    _check_cuda_args(name, {"u1": u1, "u2m": u2m, "g": g,
                            **({"w_d": w_d} if want_dists else {}),
                            **{f"hidden[{i}]": t for i, t in enumerate(hidden_flat)}},
                     hidden_flat[::2], u1.dtype)
    if want_dists:
        _check_cuda_args(name, {"dists": dists}, ())
    dev = u1.device
    f32 = dict(dtype=torch.float32, device=dev)
    # bf16: du1 is summed in float32 over the rank chunks, then rounded here
    du1 = torch.empty(u1.shape, **f32)
    du2 = torch.empty((b_sz, n, h1), dtype=u1.dtype, device=dev)
    dmask = torch.empty((b_sz, n, 1), dtype=u1.dtype, device=dev)
    ddists = torch.empty((b_sz, n, k), **f32) if want_dists else None
    w_total = sum(t.numel() for t in hidden_flat) + (h1 if want_dists else 0)
    # the kernel's second pass writes every weight gradient; without them they are zeros
    flat = torch.empty((w_total,), **f32) if need_wgrads else torch.zeros((w_total,), **f32)
    dhidden, dw_d = _flat_wgrads(flat, hidden_flat, h1 if want_dists else 0)
    if not want_dists:
        dw_d = None
    plan = bwd_plan(b_sz, n, k, dims, _sm_count(dev))
    # partial sums, reduced in a second pass in a fixed order: a slab per (jet, CTA
    # that touches it) for du2 and dmask, which the kernel zeroes itself (which rows
    # a CTA adds to depends on idx), and one per CTA for the weights
    sender_part = torch.empty((b_sz, plan.slots, n, (h1 + 4) // 4 * 4), **f32)
    w_part = torch.empty((plan.grid, bwd_wslab_floats(dims, h1 if want_dists else 0))
                         if need_wgrads and w_total else (1,), **f32)
    # the kernel's own copy of the weights, W and W^T laid out for its products
    packed_floats = (bwd_packed_floats_bf16 if bf16 else bwd_packed_floats)(dims, plan.rows)
    packed = torch.empty((max(packed_floats, 1),), **f32)
    lib = _build.library()
    w, bias = _chain_args(pairs)
    dim_arr = (ctypes.c_int * len(dims))(*dims)
    thr, mult = dropout_threshold_mult(dropout_p) if dropout_p > 0 else (0, 1.0)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    seed_t = seed_arg(name, seed, dev) if dropout_p > 0 else None
    seed_ptr = ptr(seed_t)
    with torch.cuda.device(dev):
        ptrs = (u1.data_ptr(), u2m.data_ptr(), idx.data_ptr(), ptr(dists), ptr(w_d), g.data_ptr(),
                du1.data_ptr(), du2.data_ptr(), dmask.data_ptr(), ptr(ddists), flat.data_ptr(),
                sender_part.data_ptr(), w_part.data_ptr(), b_sz, n, h1, k, len(pairs), w,
                packed.data_ptr())
        rest = (bias, dim_arr, float(alpha), int(bool(sum_agg)), int(dropout_p > 0), seed_ptr,
                thr, mult, int(bool(need_wgrads)), plan.ti, plan.jc, plan.rows, plan.grid,
                plan.slots, torch.cuda.current_stream().cuda_stream)
        if bf16:
            code = lib.mpgan_knn_edge_aggregate_bwd_bf16(*ptrs, packed_floats, *rest)
        else:
            code = lib.mpgan_knn_edge_aggregate_bwd(*ptrs, *rest)
    _build.check(code, name)
    launch_counts[name] += 1
    if bf16:
        du1 = du1.to(torch.bfloat16)
        dhidden = tuple(t.to(torch.bfloat16) for t in dhidden)
        dw_d = None if dw_d is None else dw_d.to(torch.bfloat16)
    return du1, du2, dmask, ddists, dw_d, dhidden


def knn_search_reference(xs, xf, k: int, self_loops: bool, want_dists: bool = False):
    """Plain PyTorch version of K7: ``(idx, dists)``, ``dists`` (float32, from
    the inputs' float32 values) None unless ``want_dists``."""
    idx = knn_select_reference(xs, xf, k, self_loops)
    return idx, (_edge_dists(xs.float(), xf.float(), idx)[0] if want_dists else None)


def knn_search(xs, xf, k: int, self_loops: bool, want_dists: bool = False):
    """K7: the plain version on the CPU, the CUDA kernel on a GPU. Returns
    ``(idx int32 [B, N, k], dists float32 [B, N, k] or None)`` for float32 or
    bf16 (the bf16 mode: its own kernel entry and count) ``xs`` and ``xf``. No
    gradient flows through this call; see :class:`KnnSearch`."""
    bf16 = _is_bf16(xs, xf)
    name = "knn_search" + ("_bf16" if bf16 else "")
    _check_search_shapes(name, xs, xf, k, self_loops)
    if _on_cpu(xs, xf):
        return knn_search_reference(xs, xf, k, self_loops, want_dists)
    _check_cuda_args(name, {"xs": xs, "xf": xf}, (), xs.dtype)
    b_sz, n, c = xs.shape
    idx = torch.empty((b_sz, n, k), dtype=torch.int32, device=xs.device)
    dists = torch.empty((b_sz, n, k), dtype=torch.float32, device=xs.device) \
        if want_dists else None
    lib = _build.library()
    launcher = lib.mpgan_knn_search_bf16 if bf16 else lib.mpgan_knn_search
    with torch.cuda.device(xs.device):
        code = launcher(
            xs.data_ptr(), xf.data_ptr(), idx.data_ptr(),
            None if dists is None else dists.data_ptr(), b_sz, n, c, k, int(bool(self_loops)),
            int(bool(want_dists)), torch.cuda.current_stream().cuda_stream,
        )
    _build.check(code, name)
    launch_counts[name] += 1
    return idx, dists


def knn_edge_aggregate_reference(u1, u2m, idx, dists, w_d, hidden_flat, alpha: float,
                                 sum_agg: bool, dropout_p: float = 0.0, seed=0):
    """Plain PyTorch version of K8: the masked aggregate of the fe chain over
    the edges ``idx`` names."""
    return _masked_agg(u1, u2m, idx, dists, w_d, hidden_flat, alpha, sum_agg, dropout_p, seed)


def knn_edge_aggregate(u1, u2m, idx, dists, w_d, hidden_flat, alpha: float, sum_agg: bool,
                       dropout_p: float = 0.0, seed=0):
    """K8: the plain version on the CPU, the CUDA kernel on a GPU. ``idx`` is
    int32 ``[B, N, k]`` with entries in ``[0, N)``; ``dists`` (float32) and
    ``w_d`` are both given or both None; the other inputs all float32, or all
    bf16 for the bf16 mode (its own kernel and count)."""
    hidden_flat = tuple(hidden_flat)
    want_dists = dists is not None
    w_d = w_d if want_dists else None
    extra = (dists, w_d) if want_dists else ()
    bf16 = _is_bf16(u1, u2m, *(t for t in extra[1:] if t is not None), *hidden_flat)
    name = "knn_edge_aggregate" + ("_bf16" if bf16 else "")
    _check_dropout(name, dropout_p, seed)
    _check_dists_dtype(name, dists)
    if u1.dim() != 3:
        raise ValueError(f"{name}: u1 {tuple(u1.shape)} must be [B, N, H1]")
    _check_u2m(name, u1, u2m, w_d, want_dists)
    b_sz, n, h1 = u1.shape
    if idx.dim() != 3 or idx.shape[:2] != (b_sz, n) or idx.dtype != torch.int32:
        raise ValueError(f"{name}: idx must be int32 [{b_sz}, {n}, k], got {idx.dtype} "
                         f"{tuple(idx.shape)}")
    if want_dists and dists.shape != idx.shape:
        raise ValueError(f"{name}: dists {tuple(dists.shape)} must be {tuple(idx.shape)}")
    pairs = _pairs(hidden_flat)
    dims = _chain_dims(name, "hidden", [h1], pairs)
    if _on_cpu(u1, u2m, idx, *extra, *hidden_flat):
        return knn_edge_aggregate_reference(u1, u2m, idx, dists, w_d, hidden_flat, alpha,
                                            sum_agg, dropout_p, seed)
    if not idx.is_contiguous():
        raise ValueError(f"{name}: idx must be contiguous")
    _check_cuda_args(name, {"u1": u1, "u2m": u2m,
                            **({"w_d": w_d} if want_dists else {}),
                            **{f"hidden[{i}]": t for i, t in enumerate(hidden_flat)}},
                     hidden_flat[::2], u1.dtype)
    if want_dists:
        _check_cuda_args(name, {"dists": dists}, ())
    out = torch.empty((b_sz, n, dims[-1]), dtype=u1.dtype, device=u1.device)
    k = idx.shape[2]
    plan = (bf16_tile_plan if bf16 else knn_fwd_plan)(b_sz, n, 0, k, dims, _sm_count(u1.device),
                                                      search=False)
    packed_floats = fwd_packed_floats_bf16(dims) if bf16 else \
        fwd_packed_floats(dims, plan.rows)
    packed = torch.empty((max(packed_floats, 1),), dtype=torch.float32, device=u1.device)
    lib = _build.library()
    w, bias = _chain_args(pairs)
    dim_arr = (ctypes.c_int * len(dims))(*dims)
    thr, mult = dropout_threshold_mult(dropout_p) if dropout_p > 0 else (0, 1.0)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    seed_t = seed_arg(name, seed, u1.device) if dropout_p > 0 else None
    seed_ptr = ptr(seed_t)
    with torch.cuda.device(u1.device):
        ptrs = (u1.data_ptr(), u2m.data_ptr(), idx.data_ptr(), ptr(dists), ptr(w_d),
                out.data_ptr(), packed.data_ptr())
        rest = (b_sz, n, h1, k, len(pairs), w, bias, dim_arr, float(alpha), int(bool(sum_agg)),
                int(dropout_p > 0), seed_ptr, thr, mult)
        stream = torch.cuda.current_stream().cuda_stream
        if bf16:
            code = lib.mpgan_knn_edge_aggregate_bf16(*ptrs, packed_floats, *rest, plan.width,
                                                     plan.warps, int(plan.resident), plan.ti,
                                                     plan.jc, plan.grid, stream)
        else:
            code = lib.mpgan_knn_edge_aggregate(*ptrs, *rest, plan.ti, plan.kc, plan.rows,
                                                plan.grid, plan.slab_floats, stream)
    _build.check(code, name)
    launch_counts[name] += 1
    return out


def _dists_backward(xs, xf, idx, dists, ddists):
    """``ddists -> (dxs, dxf)`` through ``dist = |xf[idx] - xs + 1e-12|`` with
    the selection held fixed (``knn_pallas.py:2063-2079``). In ``xs.dtype``: for
    bf16 inputs (the bf16 mode) the JAX VJP differentiates the norm in bf16,
    on its own recomputed distances, with ``ddists`` cast to bf16; the sums into
    the senders' rows are taken in float32 and rounded once."""
    norms, diffs = _edge_dists(xs, xf, idx)
    if xs.dtype != torch.float32:
        dists, ddists = norms, ddists.to(xs.dtype)
    d_diffs = (ddists / dists)[..., None] * diffs  # [B, N, k, C]
    b, n, k = idx.shape
    flat = (idx.long() + torch.arange(b, device=idx.device)[:, None, None] * n).reshape(-1)
    dxf = torch.zeros(b * n, xs.shape[-1], dtype=torch.float32, device=xs.device)
    # an accumulating index_put_ sums each row in a fixed order (index_add_ on a GPU does not)
    dxf.index_put_((flat,), d_diffs.reshape(b * n * k, -1).float(), accumulate=True)
    return -d_diffs.sum(dim=2), dxf.reshape(xf.shape).to(xs.dtype)


class KnnFusedLayer(torch.autograd.Function):
    """K5 forward, K6 backward (``knn_pallas.knn_fused_layer``'s custom VJP).

    ``KnnFusedLayer.apply(xs, xf, u1, u2m, w_d, k, self_loops, want_dists,
    alpha, sum_agg, dropout_p, seed, *hidden_flat)``; ``w_d`` is None without
    ``want_dists``. The forward asks K5 for ``idx`` (and ``dists``), the
    backward's residuals; :func:`knn_aggregate` goes around the Function where
    no gradient is needed. The backward launches K6 with the weight
    contractions only when a hidden weight, bias or ``w_d`` needs a gradient.
    ``xs`` and ``xf`` get a gradient through the distances only (the selection
    is detached); that step is plain torch, its scatter into ``dxf`` an
    accumulating ``index_put_``, which sums in a fixed order. Once
    differentiable, like :class:`.mp_kernels.EdgeAggregate`."""

    @staticmethod
    def forward(ctx, xs, xf, u1, u2m, w_d, k, self_loops, want_dists, alpha, sum_agg,
                dropout_p, seed, *hidden_flat):
        agg, idx, dists = knn_fused_layer(xs, xf, u1, u2m, w_d, hidden_flat, k, self_loops,
                                          want_dists, alpha, sum_agg, dropout_p, seed, True)
        ctx.save_for_backward(xs, xf, u1, u2m, w_d, idx, dists, *hidden_flat)
        ctx.cfg = (alpha, sum_agg, dropout_p, seed)
        return agg

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        xs, xf, u1, u2m, w_d, idx, dists, *hidden_flat = ctx.saved_tensors
        alpha, sum_agg, dropout_p, seed = ctx.cfg
        need_wgrads = ctx.needs_input_grad[4] or any(ctx.needs_input_grad[12:])
        du1, du2, dmask, ddists, dw_d, dhidden = knn_edge_aggregate_bwd(
            u1, u2m, idx, dists, w_d, hidden_flat, g.contiguous(), alpha, sum_agg, dropout_p,
            seed, need_wgrads,
        )
        dxs = dxf = None
        if dists is not None and (ctx.needs_input_grad[0] or ctx.needs_input_grad[1]):
            dxs, dxf = _dists_backward(xs, xf, idx, dists, ddists)
        if not need_wgrads:
            dw_d, dhidden = None, (None,) * len(hidden_flat)
        return (dxs, dxf, du1, torch.cat([du2, dmask], dim=-1), dw_d,
                None, None, None, None, None, None, None, *dhidden)


def knn_aggregate(xs, xf, u1, u2m, w_d, hidden_flat, k: int, self_loops: bool, want_dists: bool,
                  alpha: float, sum_agg: bool, dropout_p: float = 0.0, seed=0):
    """The knn edge stage for a layer: :class:`KnnFusedLayer` when some tensor
    needs a gradient, else K5 alone, which then writes no ``idx``/``dists``."""
    tensors = [t for t in (xs, xf, u1, u2m, w_d, *hidden_flat) if t is not None]
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return KnnFusedLayer.apply(xs, xf, u1, u2m, w_d, k, self_loops, want_dists, alpha,
                                   sum_agg, dropout_p, seed, *hidden_flat)
    return knn_fused_layer(xs, xf, u1, u2m, w_d, hidden_flat, k, self_loops, want_dists, alpha,
                           sum_agg, dropout_p, seed)[0]


class KnnSearch(torch.autograd.Function):
    """K7 with the distances' gradient (``knn_select_nm``'s custom VJP):
    ``KnnSearch.apply(xs, xf, k, self_loops) -> (idx, dists)``. ``idx`` carries
    no gradient; ``dists`` backpropagates into ``xs`` and ``xf`` through the norm
    with the selection held fixed, in plain torch."""

    @staticmethod
    def forward(ctx, xs, xf, k, self_loops):
        idx, dists = knn_search(xs, xf, k, self_loops, True)
        ctx.save_for_backward(xs, xf, idx, dists)
        ctx.mark_non_differentiable(idx)
        return idx, dists

    @staticmethod
    @once_differentiable
    def backward(ctx, _g_idx, ddists):
        xs, xf, idx, dists = ctx.saved_tensors
        dxs, dxf = _dists_backward(xs, xf, idx, dists, ddists)
        return dxs, dxf, None, None


class KnnEdgeAggregate(torch.autograd.Function):
    """K8 forward, K6 backward (the custom VJPs of ``knn_edge_aggregate``,
    ``_v2`` and ``_v3``): ``KnnEdgeAggregate.apply(u1, u2m, idx, dists, w_d,
    alpha, sum_agg, dropout_p, seed, *hidden_flat)``; ``dists`` and ``w_d`` are
    None without the distance feature. Once differentiable."""

    @staticmethod
    def forward(ctx, u1, u2m, idx, dists, w_d, alpha, sum_agg, dropout_p, seed, *hidden_flat):
        agg = knn_edge_aggregate(u1, u2m, idx, dists, w_d, hidden_flat, alpha, sum_agg,
                                 dropout_p, seed)
        ctx.save_for_backward(u1, u2m, idx, dists, w_d, *hidden_flat)
        ctx.cfg = (alpha, sum_agg, dropout_p, seed)
        return agg

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        u1, u2m, idx, dists, w_d, *hidden_flat = ctx.saved_tensors
        alpha, sum_agg, dropout_p, seed = ctx.cfg
        need_wgrads = ctx.needs_input_grad[4] or any(ctx.needs_input_grad[9:])
        du1, du2, dmask, ddists, dw_d, dhidden = knn_edge_aggregate_bwd(
            u1, u2m, idx, dists, w_d, hidden_flat, g.contiguous(), alpha, sum_agg, dropout_p,
            seed, need_wgrads,
        )
        if not need_wgrads:
            dw_d, dhidden = None, (None,) * len(hidden_flat)
        return (du1, torch.cat([du2, dmask], dim=-1), None, ddists, dw_d,
                None, None, None, None, *dhidden)


def knn_aggregate_split(xs, xf, u1, u2m, w_d, hidden_flat, k: int, self_loops: bool,
                        want_dists: bool, alpha: float, sum_agg: bool, dropout_p: float = 0.0,
                        seed=0, idx: torch.Tensor | None = None,
                        dists: torch.Tensor | None = None):
    """The knn edge stage as two kernels: K7 searches, K8 aggregates (K6 is its
    backward). With ``idx`` (and ``dists`` under ``want_dists``) given, a search
    made elsewhere feeds K8."""
    if idx is None:
        if want_dists and torch.is_grad_enabled() and (xs.requires_grad or xf.requires_grad):
            idx, dists = KnnSearch.apply(xs, xf, k, self_loops)
        else:
            idx, dists = knn_search(xs.detach(), xf.detach(), k, self_loops, want_dists)
    dists = dists if want_dists else None
    w_d = w_d if want_dists else None
    tensors = [t for t in (u1, u2m, dists, w_d, *hidden_flat) if t is not None]
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return KnnEdgeAggregate.apply(u1, u2m, idx, dists, w_d, alpha, sum_agg, dropout_p, seed,
                                      *hidden_flat)
    return knn_edge_aggregate(u1, u2m, idx, dists, w_d, hidden_flat, alpha, sum_agg, dropout_p,
                              seed)
