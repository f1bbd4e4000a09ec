"""The JAX package's random numbers: ``jax.random``'s default PRNG, threefry2x32,
as JAX 0.9 runs it (``jax_threefry_partitionable`` on), so that a key of the
port draws what the same key draws in the JAX package, bit for bit.

Written from ``jax/_src/prng.py`` and ``jax/_src/random.py``:

- :func:`threefry2x32`: 20 rounds in five groups of four, rotations
  (13, 15, 26, 6) and (17, 29, 16, 24), key schedule ``k0, k1, k0 ^ k1 ^
  0x1BD11BDA`` with the group number added to the second word;
- a key is two uint32 words; :func:`PRNGKey` of an int32 seed is ``(0, seed)``;
- child ``i`` of a key is ``threefry2x32(key, (0, i))``: ``split(key, num)[i]``
  (the fold-like split, which does not depend on ``num``) and
  ``fold_in(key, i)`` are both this;
- the 32-bit random bits of element ``e`` (row-major over the shape) are
  ``y0 ^ y1`` of ``threefry2x32(key, (0, e))``;
- ``uniform``: the bits' top 23 as the mantissa of a float in [1, 2), minus 1,
  times ``hi - lo``, plus ``lo``, at least ``lo``; float32 throughout, the
  product and the sum rounded once, as a fused multiply-add (what XLA's CPU
  backend gives: rounding them apart differs in about a sixth of the draws on
  ``[0.7, 1.2)``);
- ``normal``: ``sqrt(2) * erf_inv(u)`` with ``u`` uniform on
  ``(nextafter(-1, 0), 1)``; ``erf_inv`` is Giles' single-precision polynomial,
  which XLA lowers ``lax.erf_inv`` to (:func:`erf_inv`), on a ``log1p`` written
  out here (:func:`log1p`) so that the kernel and the plain version give the
  same bits; XLA's ``log1p`` and its fused Horner steps differ from these by
  an ulp at times, so normals agree with JAX's within a few ulps;
- ``randint``: bits of children 0 and 1, reduced modulo the span as
  ``random.py`` does (32-bit products that wrap).

The draws a caller needs are written as a plan: rows (:class:`Row`) that name a
key below a root key by its path of children, a distribution (the ones the
step and the sampler draw: the key itself, dropout key words, edge seeds,
uniforms, normals and the batch's order row) and a shape. A
:class:`Plan` is evaluated by :func:`threefry_draws`: the plain version below for
tensors on the CPU, the kernel ``csrc/threefry.cu`` for tensors on a CUDA
device (one launch for every row of the plan), anything else raises. A plan
can read a batch counter from device memory (:data:`COUNTER` in a path, and
the ``order`` row), write the root's next key in place (``advance``) and add
one to the counter (``bump``), so that a CUDA graph that holds the launch draws
anew at every replay with no work on the host.

The plain version holds uint32 values in int64 tensors (``& 0xFFFFFFFF`` after
each sum, product and shift). Keys are uint32 ``[2]`` tensors.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import struct
from typing import Sequence

import numpy as np
import torch

from . import _build
from . import linear as _linear

M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
COUNTER = -1  # a path entry: the child named by the plan's batch counter
SQRT2 = float(np.float32(np.sqrt(2.0)))
NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
EPB = 1024  # elements a CUDA block draws (256 threads, 4 each)
WIDTH = 24  # int32 words a plan row takes
MAX_PATH = 12
DISTS = ("key", "words", "edge_seed", "uniform", "normal", "order")

launch_counts = {"threefry_draws": 0}  # kernel launches (CountedGraph accounts replays)

# Cephes' logf: the polynomial in t = m - 1 (m the mantissa, [sqrt(1/2), sqrt(2)))
# and the split of log(2) into 0.693359375 - 2.12194440e-4
_LOG_POLY = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
             1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
             3.3333331174e-1)
_LOG2_HI, _LOG2_LO = 0.693359375, -2.12194440e-4
SQRT_HALF = 0.70710677
# Giles' erf_inv, single precision (XLA's ErfInv32): w < 5 and w >= 5
_ERF_INV_LT = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
               0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERF_INV_GE = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
               0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------


def _rotl(v, r: int):
    return ((v << r) | (v >> (32 - r))) & M32


def threefry2x32(k0, k1, x0, x1):
    """The threefry2x32 hash of the counts ``(x0, x1)`` under the key ``(k0, k1)``:
    ints or int64 tensors holding uint32 values, broadcast together."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0, x1 = (x0 + ks[0]) & M32, (x1 + ks[1]) & M32
    for group in range(5):
        for r in _ROT[group % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(group + 1) % 3]) & M32
        x1 = (x1 + ks[(group + 2) % 3] + group + 1) & M32
    return x0, x1


def PRNGKey(seed: int, device: torch.device | str = "cpu") -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``: ``(0, seed)`` for an int32 seed (JAX's default
    32-bit mode), the seed's two 32-bit halves for a wider one."""
    seed = int(seed)
    hi = 0 if -2**31 <= seed < 2**31 else (seed >> 32) & M32
    return key_of(hi, seed & M32, device)


def key_of(w0: int, w1: int, device: torch.device | str = "cpu") -> torch.Tensor:
    """The key with words ``w0, w1``, a uint32 ``[2]`` tensor."""
    return torch.tensor([w0 & M32, w1 & M32], dtype=torch.int64).to(torch.uint32).to(device)


def key_words(key: torch.Tensor) -> tuple[int, int]:
    w = key.reshape(2).to("cpu", torch.int64)
    return int(w[0]), int(w[1])


def _child(k: tuple[int, int], i: int) -> tuple[int, int]:
    return threefry2x32(k[0], k[1], 0, i & M32)


def _bits(k: tuple[int, int], n: int, device="cpu") -> torch.Tensor:
    """The 32-bit random bits of ``n`` elements, int64 on ``device``."""
    y0, y1 = threefry2x32(k[0], k[1], torch.zeros(n, dtype=torch.int64, device=device),
                          torch.arange(n, dtype=torch.int64, device=device))
    return y0 ^ y1


def _as_float(bits: torch.Tensor) -> torch.Tensor:
    """int64 uint32 values as the float32s with those bits."""
    return bits.to(torch.int32).view(torch.float32) if bits.numel() else \
        torch.empty(0, dtype=torch.float32, device=bits.device)


def _i32(v: torch.Tensor) -> torch.Tensor:
    """int64 uint32 values as int32 bits."""
    return torch.where(v >= 2**31, v - 2**32, v).to(torch.int32)


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` of float32 tensors rounded once, as a fused multiply-add:
    the product is exact in float64, and so is the sum where the three lie within
    a few binades of each other (the uniforms' bounds and the polynomial's terms)."""
    return (a.double() * b.double() + c.double()).float()


def _uniform(bits: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    f = _as_float((bits >> 9) | 0x3F800000) - torch.tensor(1.0)
    lo_t, hi_t = torch.tensor(lo, dtype=torch.float32), torch.tensor(hi, dtype=torch.float32)
    return torch.maximum(lo_t, _fma(f, hi_t - lo_t, lo_t))


def _f32(v: float) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32)


def log(x: torch.Tensor) -> torch.Tensor:
    """``log`` of positive normal float32s, Cephes' ``logf``: the mantissa ``m``
    (``frexp``, taken to [sqrt(1/2), sqrt(2))), ``t = m - 1`` exact, a degree-9
    polynomial in ``t`` times ``t**3`` plus ``t - t**2 / 2``, then the exponent
    times log(2) in two parts. Every product and sum rounded apart, as
    ``csrc/threefry.cu`` rounds them, so the two give the same bits."""
    m, e = torch.frexp(x)
    small = m < SQRT_HALF
    e = torch.where(small, e - 1, e).to(torch.float32)
    t = torch.where(small, (m + m) - _f32(1.0), m - _f32(1.0))
    z = t * t
    y = torch.full_like(t, _LOG_POLY[0])
    for c in _LOG_POLY[1:]:
        y = y * t + _f32(c)
    y = (y * t) * z
    y = y + _f32(_LOG2_LO) * e
    y = y + _f32(-0.5) * z
    return (t + y) + _f32(_LOG2_HI) * e


def log1p(x: torch.Tensor) -> torch.Tensor:
    """``log1p`` of float32s in (-1, 0]: ``x`` where ``1 + x`` rounds to 1, else
    ``log(1 + x) * (x / ((1 + x) - 1))`` (the correction for the rounding of
    ``1 + x``), on :func:`log`."""
    u = _f32(1.0) + x
    one = u == 1.0
    safe = torch.where(one, _f32(2.0), u)
    return torch.where(one, x, log(safe) * (x / (safe - _f32(1.0))))


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """Giles' single-precision inverse error function, as XLA lowers ``lax.erf_inv``:
    a degree-8 polynomial in ``w - 2.5`` (``w < 5``) or ``sqrt(w) - 3`` with
    ``w = -log1p(-x * x)``, times ``x``; ``+-1`` give ``+-inf``. Products and
    sums rounded apart, ``sqrt`` correctly rounded (through float64: PyTorch's
    vectorised float32 ``sqrt`` on the CPU is not always), as the kernel does."""
    x = x.float()
    w = -log1p(x * -x)
    lt = w < 5.0
    root = torch.sqrt(w.double()).float()
    w = torch.where(lt, w - _f32(2.5), root - _f32(3.0))
    coef = lambda i: torch.where(lt, _f32(_ERF_INV_LT[i]), _f32(_ERF_INV_GE[i]))  # noqa: E731
    p = coef(0)
    for i in range(1, 9):
        p = coef(i) + p * w
    return torch.where(x.abs() == 1.0, x * torch.tensor(float("inf")), p * x)


def _randint(k: tuple[int, int], n: int, lo: int, hi: int, device="cpu") -> torch.Tensor:
    """int32 ``randint`` on ``[lo, hi)`` (int32 bounds), as ``random.py``'s ``_randint``."""
    higher, lower = _bits(_child(k, 0), n, device), _bits(_child(k, 1), n, device)
    span = (hi - lo) & M32 if hi > lo else 1
    mult = (2**16 % span) ** 2 & M32
    mult %= span
    offset = (((higher % span) * mult & M32) + lower % span) & M32
    offset %= span
    return _i32((offset + lo) & M32)


def edge_seed_of(k: tuple[int, int]) -> int:
    """The dense kernels' dropout seed of key ``k`` (``ops/mp.py:376-378``):
    ``randint(fold_in(k, 1), (), 0, 2**30)`` rounded to float32, as an int."""
    k = _child(k, 1)
    lower = int(_bits(_child(k, 1), 1)[0])
    return int(np.float32(lower % 2**30))


# ---------------------------------------------------------------------------
# plans
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Row:
    """One draw of a plan: the key at ``path`` below the plan's root (children;
    :data:`COUNTER` for the child the batch counter names), the distribution
    ``dist`` and the output's ``shape``:

    - ``key``: the key itself, shape ``(2,)``;
    - ``words``: ``linear.hash_seed`` of its two words, ``(1,)`` (a dropout key slot);
    - ``edge_seed``: :func:`edge_seed_of`, ``(1,)``;
    - ``uniform`` on ``[a, b)``, ``normal`` times ``a``: any shape;
    - ``order``: ``order[counter]``, the batch's row of the plan's order, ``(B,)``.
    """

    dist: str
    shape: tuple = (1,)
    path: tuple = ()
    a: float = 0.0
    b: float = 1.0

    @property
    def elements(self) -> int:
        return 1 if self.dist == "key" else math.prod(self.shape)

    @property
    def words(self) -> int:
        return 2 if self.dist == "key" else self.elements


def _f32_bits(v: float) -> int:
    return struct.unpack("<i", struct.pack("<f", float(v)))[0]


class Plan:
    """Rows laid out one after another in an int32 output buffer of
    :attr:`words` words, and the int32 ``[rows, WIDTH]`` table the kernel reads
    (on ``device``): dist, elements, offset, path length, path, ``a``, ``b``
    (float bits) and the row's first CUDA block."""

    def __init__(self, rows: Sequence[Row], device: torch.device | str = "cpu"):
        if not rows:
            raise ValueError("a plan needs a row")
        self.rows = list(rows)
        self.offsets, table, off, block = [], [], 0, 0
        for r in self.rows:
            if r.dist not in DISTS:
                raise ValueError(f"unknown distribution {r.dist!r}")
            if len(r.path) > MAX_PATH:
                raise ValueError(f"a path of {len(r.path)} children (at most {MAX_PATH})")
            if any(not COUNTER <= p < 2**31 for p in r.path):
                raise ValueError(f"path {r.path}: children in [0, 2**31), or COUNTER")
            if r.dist == "normal" and not r.a:
                raise ValueError("a normal row's scale (a) is 0")
            row = [DISTS.index(r.dist), r.elements, off, len(r.path)]
            row += list(r.path) + [0] * (MAX_PATH - len(r.path))
            row += [_f32_bits(r.a), _f32_bits(r.b), block]
            table.append(row + [0] * (WIDTH - len(row)))
            self.offsets.append(off)
            off += r.words
            block += max(1, -(-r.elements // EPB))
        self.words, self.blocks = off, block
        self.table = torch.tensor(table, dtype=torch.int32, device=device)
        # the kernel's ticket: its last block writes the next key and the counter
        self.done = torch.zeros(1, dtype=torch.int32, device=device)

    def views(self, out: torch.Tensor) -> list[torch.Tensor]:
        """Each row's output as a view of ``out``: uint32 keys, float32 uniforms and
        normals, int32 otherwise."""
        res = []
        for r, off in zip(self.rows, self.offsets):
            v = out[off:off + r.words]
            if r.dist == "key":
                v = v.view(torch.uint32).view(r.shape)
            elif r.dist in ("uniform", "normal"):
                v = v.view(torch.float32).view(r.shape)
            else:
                v = v.view(r.shape)
            res.append(v)
        return res

    def run(self, key: torch.Tensor, out: torch.Tensor | None = None,
            counter: torch.Tensor | None = None, order: torch.Tensor | None = None,
            advance: int = 0, bump: bool = False) -> torch.Tensor:
        """Draw every row into ``out`` (int32 ``[words]``, made when None) from
        ``key``; see :func:`threefry_draws`. Returns ``out``."""
        if out is None:
            out = torch.empty(self.words, dtype=torch.int32, device=key.device)
        threefry_draws(key, self, out, counter, order, advance, bump)
        return out


@functools.lru_cache(maxsize=1024)
def _plan(rows: tuple, device: str) -> Plan:
    return Plan(rows, device)


def draw(key: torch.Tensor, rows: Sequence[Row], advance: int = 0) -> list[torch.Tensor]:
    """The rows' draws from ``key`` on its device, in one launch on a GPU. The
    plan of a set of rows is kept, so drawing them again copies no table to the
    device (a pageable copy would drain the device's queue)."""
    plan = _plan(tuple(rows), str(key.device))
    return plan.views(plan.run(key, advance=advance))


def _check(key, plan, out, counter, order, advance) -> None:
    if key.dtype != torch.uint32 or key.numel() != 2 or not key.is_contiguous():
        raise ValueError("threefry_draws: the key must be a contiguous uint32 [2] tensor")
    if out.dtype != torch.int32 or out.numel() != plan.words or not out.is_contiguous():
        raise ValueError(f"threefry_draws: out must be a contiguous int32 [{plan.words}] tensor")
    needs_counter = any(COUNTER in r.path or r.dist == "order" for r in plan.rows)
    if counter is not None and (counter.dtype != torch.int32 or counter.numel() != 1):
        raise ValueError("threefry_draws: the counter must be an int32 [1] tensor")
    if needs_counter and counter is None:
        raise ValueError("threefry_draws: the plan reads the batch counter; none given")
    if any(r.dist == "order" for r in plan.rows):
        widths = {r.elements for r in plan.rows if r.dist == "order"}
        if order is None or order.dtype != torch.int32 or order.dim() != 2 \
                or {order.shape[1]} != widths or not order.is_contiguous():
            raise ValueError(f"threefry_draws: order must be a contiguous int32 "
                             f"[batches, {widths}] tensor")
    if not 0 <= advance <= MAX_PATH:
        raise ValueError(f"threefry_draws: advance {advance} outside [0, {MAX_PATH}]")
    tensors = [t for t in (key, out, counter, order, plan.table) if t is not None]
    if len({t.device for t in tensors}) != 1:
        raise ValueError("threefry_draws: key, plan, out, counter and order on one device")


def threefry_draws(key: torch.Tensor, plan: Plan, out: torch.Tensor,
                   counter: torch.Tensor | None = None, order: torch.Tensor | None = None,
                   advance: int = 0, bump: bool = False) -> None:
    """Evaluate ``plan`` from the root ``key`` into ``out``: the plain version for
    tensors on the CPU, the kernel for tensors on a CUDA device. Then write the
    root's ``advance``-th first child (child 0 of child 0 ..., the key a step's
    split keeps) over ``key`` and, with ``bump``, add one to ``counter``."""
    _check(key, plan, out, counter, order, advance)
    if key.device.type == "cpu":
        threefry_draws_reference(key, plan, out, counter, order, advance, bump)
        return
    if key.device.type != "cuda":
        raise ValueError(f"threefry_draws: tensors on {key.device}, expected cpu or cuda")
    lib = _build.library()
    with torch.cuda.device(key.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.mpgan_threefry_draws(
            key.data_ptr(), plan.table.data_ptr(), len(plan.rows), WIDTH, out.data_ptr(),
            None if counter is None else counter.data_ptr(),
            None if order is None else order.data_ptr(), advance, int(bool(bump)),
            plan.done.data_ptr(), plan.blocks, EPB, stream)
    _build.check(code, "threefry_draws")
    launch_counts["threefry_draws"] += 1


def threefry_draws_reference(key: torch.Tensor, plan: Plan, out: torch.Tensor,
                             counter: torch.Tensor | None = None,
                             order: torch.Tensor | None = None, advance: int = 0,
                             bump: bool = False) -> None:
    """The plain version of :func:`threefry_draws`: PyTorch on ``out``'s device
    (the path's keys on the host)."""
    root, dev = key_words(key), out.device
    c = int(counter.reshape(-1)[0]) if counter is not None else 0
    for r, off in zip(plan.rows, plan.offsets):
        k = root
        for p in r.path:
            k = _child(k, c if p == COUNTER else p)
        n = r.elements
        if r.dist == "key":
            val = torch.tensor(k, dtype=torch.int64)
        elif r.dist == "words":
            val = torch.tensor([_linear.hash_seed(k)], dtype=torch.int64)
        elif r.dist == "edge_seed":
            val = torch.tensor([edge_seed_of(k)], dtype=torch.int64)
        elif r.dist == "uniform":
            val = _uniform(_bits(k, n, dev), r.a, r.b)
        elif r.dist == "normal":
            u = _uniform(_bits(k, n, dev), NORMAL_LO, 1.0)
            val = torch.tensor(SQRT2, dtype=torch.float32) * erf_inv(u) * \
                torch.tensor(r.a, dtype=torch.float32)
        else:  # order
            val = order.reshape(-1, n)[c].to(dev, torch.int64)
        seg = out[off:off + r.words]
        if val.dtype == torch.float32:
            seg.copy_(val.reshape(-1).view(torch.int32))
        else:
            seg.copy_(_i32(val.reshape(-1) & M32))
    if advance:
        k = root
        for _ in range(advance):
            k = _child(k, 0)
        key.copy_(key_of(*k, key.device).reshape(key.shape))
    if bump:
        counter.add_(1)


# ---------------------------------------------------------------------------
# jax.random's functions on keys
# ---------------------------------------------------------------------------
#
# Keys, bits and ints are computed on the host (no path of the port draws them
# on the device); uniforms and normals are one-row plans, drawn on the key's
# device.


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)``: uint32 ``[num, 2]``."""
    k = key_words(key)
    return torch.stack([key_of(*_child(k, i)) for i in range(num)]).to(key.device)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in(key, data)`` for ``0 <= data < 2**31``."""
    return key_of(*_child(key_words(key), int(data)), key.device)


def random_bits(key: torch.Tensor, shape: tuple) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` (uint32) as int32 bits."""
    bits = _bits(key_words(key), math.prod(shape))
    return _i32(bits).reshape(tuple(shape)).to(key.device)


def uniform(key: torch.Tensor, shape: tuple, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    return draw(key, [Row("uniform", tuple(shape), (), minval, maxval)])[0]


def normal(key: torch.Tensor, shape: tuple, scale: float = 1.0) -> torch.Tensor:
    """``jax.random.normal(key, shape) * scale`` (float32)."""
    return draw(key, [Row("normal", tuple(shape), (), scale)])[0]


def randint(key: torch.Tensor, shape: tuple, minval: int, maxval: int) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` with int32 bounds, int32."""
    ints = _randint(key_words(key), math.prod(shape), int(minval), int(maxval))
    return ints.reshape(tuple(shape)).to(key.device)
