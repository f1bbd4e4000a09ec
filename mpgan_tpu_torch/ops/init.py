"""Initial weights from a threefry key, as the JAX package's ``*_init``
functions draw them.

A module's constructor takes ``key``: a threefry key (uint32 ``[2]``, as
:func:`.prng.PRNGKey` makes it), or None for ``PRNGKey(0)`` (the key the JAX
``gen`` builds its loading template from, so a caller that loads weights over
a new module need not name one). The module built from key ``K`` holds the
JAX module's init from ``K``: the same split tree (child ``i`` of ``split(k,
n)`` is ``fold_in(k, i)``), the same draws in the same shapes, the same bounds
(float64 expressions rounded to float32 once). A ``torch.Generator`` is
refused with ``TypeError``.

Inside a constructor the key is a :class:`.keys.Keys`: the root key on the
module's device and the path of children below it, so splitting only
lengthens a tuple on the host and reads nothing from the device. Each draw is
one ``threefry_draws`` row with that path (:mod:`.prng`): the kernel on a
CUDA key, its plain version on the CPU; the parameter is the draw.
"""

from __future__ import annotations

import torch

from . import keys as _keys
from . import prng


def root(key, device: torch.device | str | None = None) -> "_keys.Keys":
    """``key`` as a :class:`.keys.Keys` whose root lies on ``device`` (the
    key's own device when None)."""
    if isinstance(key, torch.Generator):
        raise TypeError("model initialisers take a threefry key (ops.prng.PRNGKey), "
                        "not a torch.Generator")
    if isinstance(key, _keys.Keys):
        if device is None or key.root.device == torch.device(device):
            return key
        return _keys.Keys(key.root.to(device), key.path)
    if key is None:
        key = prng.PRNGKey(0)
    if not isinstance(key, torch.Tensor) or key.dtype != torch.uint32 or key.numel() != 2:
        raise TypeError(f"a threefry key is a uint32 [2] tensor, got {key!r}")
    return _keys.Keys(key.reshape(2).to(device if device is not None else key.device)
                      .contiguous())


def uniform(k: "_keys.Keys", shape, minval: float, maxval: float) -> torch.Tensor:
    """``jax.random.uniform(k, shape, float32, minval, maxval)``."""
    return prng.draw(k.root, [prng.Row("uniform", tuple(shape), k.path, minval, maxval)])[0]


def normal(k: "_keys.Keys", shape, scale: float = 1.0) -> torch.Tensor:
    """``jax.random.normal(k, shape) * scale`` (float32)."""
    return prng.draw(k.root, [prng.Row("normal", tuple(shape), k.path, scale)])[0]
