"""Where train-mode dropout gets its keys.

The JAX package threads ``jax.random`` keys: an MLP splits its key into one
per layer and hashes the two key words into the dropout mask
(``linear.hash_dropout``); the dense kernel path draws an integer seed for the
in-kernel hash (``ops/mp.py:376-378``). The port's modules take a *keys*
object with the same three operations instead of a JAX key:

- ``split(num)``: ``num`` child key objects, in the order JAX splits them;
- ``words()``: the two uint32 key words ``hash_dropout`` hashes;
- ``edge_seed()``: the in-kernel dropout seed, an integer in ``[0, 2**30)``.

:class:`GeneratorKeys` draws every word and seed from one CPU
``torch.Generator`` (no device sync), in the order the modules ask for them.
A test can hand the modules an object that replays JAX's key splits instead,
so both packages draw the same masks.

:class:`KeySlots` serves the same requests from device memory, as the JAX
step's keys are device arrays, so that a step captured in a CUDA graph draws
fresh masks at every replay: ``words()`` and ``edge_seed()`` return one-element
int32 views of one buffer, which the host fills before each run of the step.
"""

from __future__ import annotations

import contextlib
from typing import Any, Mapping

import torch

from .linear import hash_seed


class GeneratorKeys:
    """Keys drawn in execution order from one CPU ``torch.Generator``."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    def split(self, num: int) -> list["GeneratorKeys"]:
        return [self] * num

    def words(self) -> tuple[int, int]:
        w = torch.randint(0, 2**32, (2,), generator=self.generator, dtype=torch.int64)
        return int(w[0]), int(w[1])

    def edge_seed(self) -> int:
        return int(torch.randint(0, 2**30, (1,), generator=self.generator, dtype=torch.int64))


Request = tuple[str, str, tuple]  # (kind: "words" | "edge_seed", root, split path)


class KeySlots:
    """A step's key requests served from one-element int32 views of
    :attr:`buffer`, for a step that is run again on the same buffers (a CUDA
    graph's replay).

    A step asks for the same keys in every run, so they are recorded once:
    inside :meth:`recording`, each request of the roots' keys (:meth:`root`)
    is logged with its kind and its split path, and its value is drawn at once
    from a keys source and copied to the device, so the recorded step is an
    ordinary step. :meth:`fill` then draws the logged requests' values, in the
    logged order, from any keys source (:class:`GeneratorKeys`, or a test's
    JAX-replay keys) into a host tensor that the caller copies into
    :attr:`buffer`; inside :meth:`serving`, request ``i`` is ``buffer[i:i+1]``
    and must be the ``i``-th logged one. A source is one keys object for every
    root, or a mapping from root names to keys objects.

    A ``words()`` slot holds the two words' ``linear.hash_seed``, the one int
    ``hash_dropout`` adds; an ``edge_seed()`` slot holds the seed, checked to
    lie in ``[0, 2**31)`` when it is drawn."""

    def __init__(self, device: torch.device | str):
        self.device = torch.device(device)
        self.log: list[Request] = []
        self.buffer: torch.Tensor | None = None  # int32 [len(log)], set by the owner
        self._source: Any = None
        self._next: int | None = None

    def root(self, name: str) -> "SlotKey":
        return SlotKey(self, name, ())

    @contextlib.contextmanager
    def recording(self, source: Any):
        """Log the block's requests anew, each drawn at once from ``source``."""
        self.log, self._source = [], source
        try:
            yield
        finally:
            self._source = None

    @contextlib.contextmanager
    def serving(self):
        """Serve the block's requests from :attr:`buffer`."""
        if self.buffer is None or self.buffer.numel() != len(self.log):
            raise RuntimeError("key slots: no buffer for the recorded requests")
        self._next = 0
        try:
            yield
            if self._next != len(self.log):
                raise RuntimeError(f"key slots: the step made {self._next} key requests, "
                                   f"the recorded step {len(self.log)}")
        finally:
            self._next = None

    def fill(self, source: Any, out: torch.Tensor) -> None:
        """Draw the logged requests' values from ``source``, in the logged order,
        into ``out`` (int32 ``[len(log)]``, on the host)."""
        memo: dict = {}
        values = [_value(kind, _resolve(source, root, path, memo))
                  for kind, root, path in self.log]
        out.copy_(torch.tensor(values, dtype=torch.int32))

    def _request(self, kind: str, root: str, path: tuple) -> torch.Tensor:
        if self._source is not None:
            self.log.append((kind, root, path))
            value = torch.tensor([_value(kind, _resolve(self._source, root, path, {}))],
                                 dtype=torch.int32)
            if self.device.type == "cuda":
                return value.pin_memory().to(self.device, non_blocking=True)
            return value.to(self.device)
        if self._next is None:
            raise RuntimeError("key slots: a request outside recording() and serving()")
        i = self._next
        if i >= len(self.log) or self.log[i] != (kind, root, path):
            raise RuntimeError(f"key slots: request {i} {(kind, root, path)} is not the "
                               "recorded step's")
        self._next += 1
        return self.buffer[i:i + 1]


class SlotKey:
    """A keys object of :class:`KeySlots`: ``root`` and the split path to it."""

    def __init__(self, slots: KeySlots, root: str, path: tuple):
        self.slots, self.root, self.path = slots, root, path

    def split(self, num: int) -> list["SlotKey"]:
        return [SlotKey(self.slots, self.root, self.path + ((num, i),)) for i in range(num)]

    def words(self) -> torch.Tensor:
        return self.slots._request("words", self.root, self.path)

    def edge_seed(self) -> torch.Tensor:
        return self.slots._request("edge_seed", self.root, self.path)


def _resolve(source: Any, root: str, path: tuple, memo: dict) -> Any:
    """The keys object at ``path`` under ``root`` of ``source``."""
    key = source[root] if isinstance(source, Mapping) else source
    for depth in range(len(path)):
        sub = (root, path[:depth + 1])
        if sub not in memo:
            num, i = path[depth]
            memo[sub] = key.split(num)[i]
        key = memo[sub]
    return key


def _value(kind: str, key: Any) -> int:
    if kind == "words":
        return hash_seed(key.words())
    seed = int(key.edge_seed())
    if not 0 <= seed < 2**31:
        raise ValueError(f"dropout seed {seed} outside [0, 2**31)")
    return seed
