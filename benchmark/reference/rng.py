"""The random draws of a step and of a generated batch, worked out again.

A frozen plain copy of what the model's configuration fixes about randomness:
``jax.random``'s threefry2x32 (keys, children, bits, uniforms and normals, the
normal through Giles' single-precision ``erf_inv`` on a Cephes ``log``, each
product and sum rounded on its own), the key words' dropout seed, the dense
layers' in-kernel edge seed, and the two dropout hashes (the node MLPs' row and
column hash, and the edge chain's hash keyed on the edge id, the column and the
layer). Everything is int64 tensors holding uint32 values, masked after each
sum, product and shift; nothing here imports the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch

M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
SQRT2 = float(np.float32(np.sqrt(2.0)))
NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_LOG_POLY = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
             1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
             3.3333331174e-1)
_LOG2_HI, _LOG2_LO = 0.693359375, -2.12194440e-4
_SQRT_HALF = 0.70710677
_ERF_INV_LT = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
               0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERF_INV_GE = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
               0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def _rotl(v, r):
    return ((v << r) | (v >> (32 - r))) & M32


def threefry2x32(k0, k1, x0, x1):
    """threefry2x32 of the counts ``(x0, x1)`` under the key ``(k0, k1)``."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0, x1 = (x0 + ks[0]) & M32, (x1 + ks[1]) & M32
    for group in range(5):
        for r in _ROT[group % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(group + 1) % 3]) & M32
        x1 = (x1 + ks[(group + 2) % 3] + group + 1) & M32
    return x0, x1


def root_key(seed: int) -> tuple[int, int]:
    """``PRNGKey(seed)``: ``(0, seed)`` for a 32-bit seed, else its two halves."""
    seed = int(seed)
    hi = 0 if -2**31 <= seed < 2**31 else (seed >> 32) & M32
    return hi, seed & M32


def child(key: tuple[int, int], i: int) -> tuple[int, int]:
    """Child ``i`` of a key: ``split(key, n)[i]`` and ``fold_in(key, i)``."""
    return threefry2x32(key[0], key[1], 0, int(i) & M32)


def at(key: tuple[int, int], path) -> tuple[int, int]:
    for i in path:
        key = child(key, i)
    return key


def bits(key: tuple[int, int], n: int, device="cpu") -> torch.Tensor:
    y0, y1 = threefry2x32(key[0], key[1], torch.zeros(n, dtype=torch.int64, device=device),
                          torch.arange(n, dtype=torch.int64, device=device))
    return y0 ^ y1


def _f(v: float) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32)


def _fma(a, b, c):
    return (a.double() * b.double() + c.double()).float()


def uniform(key, shape, lo: float, hi: float, device="cpu") -> torch.Tensor:
    """``uniform(key, shape, float32, lo, hi)``: the bits' top 23 as a mantissa
    in [1, 2), minus 1, times ``hi - lo`` plus ``lo`` rounded once, at least ``lo``."""
    b = bits(key, math.prod(shape), device)
    f = ((b >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - _f(1.0).to(device)
    lo_t, hi_t = _f(lo).to(device), _f(hi).to(device)
    return torch.maximum(lo_t, _fma(f, hi_t - lo_t, lo_t)).reshape(shape)


def _log(x):
    m, e = torch.frexp(x)
    small = m < _SQRT_HALF
    e = torch.where(small, e - 1, e).to(torch.float32)
    one = _f(1.0).to(x.device)
    t = torch.where(small, (m + m) - one, m - one)
    z = t * t
    y = torch.full_like(t, _LOG_POLY[0])
    for c in _LOG_POLY[1:]:
        y = y * t + _f(c).to(x.device)
    y = (y * t) * z
    y = y + _f(_LOG2_LO).to(x.device) * e
    y = y + _f(-0.5).to(x.device) * z
    return (t + y) + _f(_LOG2_HI).to(x.device) * e


def _log1p(x):
    one = _f(1.0).to(x.device)
    u = one + x
    is_one = u == 1.0
    safe = torch.where(is_one, _f(2.0).to(x.device), u)
    return torch.where(is_one, x, _log(safe) * (x / (safe - one)))


def _erf_inv(x):
    w = -_log1p(x * -x)
    lt = w < 5.0
    root = torch.sqrt(w.double()).float()
    w = torch.where(lt, w - _f(2.5).to(x.device), root - _f(3.0).to(x.device))
    lt_c = torch.tensor(_ERF_INV_LT, dtype=torch.float32, device=x.device)
    ge_c = torch.tensor(_ERF_INV_GE, dtype=torch.float32, device=x.device)
    p = torch.where(lt, lt_c[0], ge_c[0])
    for i in range(1, 9):
        p = torch.where(lt, lt_c[i], ge_c[i]) + p * w
    return torch.where(x.abs() == 1.0, x * torch.tensor(float("inf"), device=x.device), p * x)


def normal(key, shape, scale: float = 1.0, device="cpu") -> torch.Tensor:
    """``normal(key, shape) * scale`` in float32."""
    u = uniform(key, shape, NORMAL_LO, 1.0, device)
    return _f(SQRT2).to(device) * _erf_inv(u) * _f(scale).to(device)


def _wrap32(v: int) -> int:
    return v & M32


def hash_seed(key: tuple[int, int]) -> int:
    """The node MLPs' dropout seed of a key: ``w0 * 0xC2B2AE3D + w1 * 0x27D4EB2F``."""
    return _wrap32(key[0] * 0xC2B2AE3D + key[1] * 0x27D4EB2F)


def edge_seed(key: tuple[int, int]) -> int:
    """The edge chain's dropout seed of a key: ``randint(fold_in(key, 1), (), 0,
    2**30)`` (the low draw of its child 1, modulo 2**30) rounded to float32."""
    k = child(key, 1)
    lower = int(bits(child(k, 1), 1)[0])
    return int(np.float32(lower % 2**30))


def keep_multiplier(h: torch.Tensor, p: float) -> torch.Tensor:
    """The hash finisher on uint32 values ``h`` and the keep test against
    ``min(int(p * 2**32), 2**32 - 1)``: ``1 / (1 - p)`` (float32) or 0."""
    h = h ^ (h >> 16)
    h = (h * 0x85EBCA6B) & M32
    h = h ^ (h >> 15)
    threshold = min(int(p * 2**32), 2**32 - 1)
    mult = float(np.float32(1.0 / (1.0 - p)))
    return (h >= threshold).to(torch.float32) * mult


def node_dropout(x: torch.Tensor, p: float, key: tuple[int, int]) -> torch.Tensor:
    """Dropout of a node MLP's layer output ``x`` under ``key``: element (row,
    column) of the rows-by-columns view keyed ``row * 0x9E3779B1 + seed + column
    * 0x85EBCA77``."""
    cols = x.shape[-1]
    rows = x.numel() // cols
    r = torch.arange(rows, dtype=torch.int64, device=x.device)[:, None] * 0x9E3779B1
    c = torch.arange(cols, dtype=torch.int64, device=x.device)[None, :] * 0x85EBCA77
    h = (r + hash_seed(key) + c) & M32
    return x * keep_multiplier(h, p).reshape(x.shape)


def edge_dropout_multiplier(ids: torch.Tensor, cols: int, p: float, seed: int,
                            layer: int) -> torch.Tensor:
    """The edge chain's dropout multiplier for edge ids ``ids`` (``[..., 1]``
    int64) and columns ``0..cols-1`` after layer ``layer`` of the chain (0: the
    first): keyed ``id * 0x9E3779B1 + seed * 0xC2B2AE3D + layer * 0x27D4EB2F +
    column * 0x85EBCA77``."""
    c = torch.arange(cols, dtype=torch.int64, device=ids.device) * 0x85EBCA77
    k = (seed * 0xC2B2AE3D + layer * 0x27D4EB2F) & M32
    h = ((ids & M32) * 0x9E3779B1 + k + c) & M32
    return keep_multiplier(h, p)


def dense_edge_ids(b: int, n: int, device) -> torch.Tensor:
    """``[B, N, N, 1]`` ids ``b*n*ns + i*ns + j`` of the dense layer's edges
    (``ns`` the sender count rounded up to 8)."""
    ns = (n + 7) // 8 * 8
    ar = lambda m: torch.arange(m, dtype=torch.int64, device=device)  # noqa: E731
    return (ar(b)[:, None, None] * (n * ns) + ar(n)[None, :, None] * ns
            + ar(n)[None, None, :])[..., None]


def knn_edge_ids(b: int, n: int, k: int, device) -> torch.Tensor:
    """``[B, N, k, 1]`` ids ``b*n*k + i*k + s`` of the knn layer's edges (``s``
    the neighbour's rank)."""
    ar = lambda m: torch.arange(m, dtype=torch.int64, device=device)  # noqa: E731
    return (ar(b)[:, None, None] * (n * k) + ar(n)[None, :, None] * k
            + ar(k)[None, None, :])[..., None]
