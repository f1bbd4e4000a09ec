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
"""

from __future__ import annotations

import torch


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
