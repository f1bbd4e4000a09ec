"""Where train-mode dropout gets its keys.

The JAX package threads ``jax.random`` keys: an MLP splits its key into one
per layer and hashes the two key words into the dropout mask
(``linear.hash_dropout``); the dense kernel path draws an integer seed for the
in-kernel hash (``ops/mp.py:376-378``). The port's modules take a *keys*
object with the same three operations instead of a JAX key:

- ``split(num)``: ``num`` child key objects, in the order JAX splits them;
- ``words()``: ``linear.hash_seed`` of the two key words, the one int
  ``hash_dropout`` adds, as a one-element int32 tensor;
- ``edge_seed()``: the in-kernel dropout seed, ``randint(fold_in(key, 1), (),
  0, 2**30)`` rounded to float32, as a one-element int32 tensor.

:class:`Keys` is a threefry key (:mod:`.prng`): a root key tensor and the path
of children below it. Splitting only lengthens the path; ``words()`` and
``edge_seed()`` draw from the key at the path (one ``threefry_draws`` launch on
a GPU), so a module draws the JAX module's masks for the same key.

:class:`KeySlots` serves the same requests from device memory, so that a step
captured in a CUDA graph draws fresh masks at every replay: ``words()`` and
``edge_seed()`` return one-element int32 views of one buffer, which the step's
plan (:class:`.prng.Plan`, one row a request, :meth:`KeySlots.rows`) fills on
the device before each run of the step. :class:`KeyLog` does the same for an
eager step: the requests of a part's last run are drawn with the part's next
draws, in the same launch.
"""

from __future__ import annotations

import contextlib
from typing import Mapping, Sequence

import torch

from . import prng


class Keys:
    """The threefry key at ``path`` (children) below the key ``root`` (uint32 ``[2]``)."""

    def __init__(self, root: torch.Tensor, path: tuple = ()):
        self.root, self.path = root, tuple(path)

    def split(self, num: int) -> list["Keys"]:
        return [Keys(self.root, self.path + (i,)) for i in range(num)]

    def fold_in(self, data: int) -> "Keys":
        """``fold_in(key, data)``: child ``data``, as ``split(key, n)[data]``."""
        return Keys(self.root, self.path + (int(data),))

    def words(self) -> torch.Tensor:
        return prng.draw(self.root, [prng.Row("words", (1,), self.path)])[0]

    def edge_seed(self) -> torch.Tensor:
        return prng.draw(self.root, [prng.Row("edge_seed", (1,), self.path)])[0]

    def key(self) -> torch.Tensor:
        """The key itself, uint32 ``[2]``."""
        return self.root.clone() if not self.path else \
            prng.draw(self.root, [prng.Row("key", (2,), self.path)])[0]


Request = tuple[str, str, tuple]  # (kind: "words" | "edge_seed", root, path of children)


class KeySlots:
    """A step's key requests served from one-element int32 views of
    :attr:`buffer`, for a step that is run again on the same buffers (a CUDA
    graph's replay).

    A step asks for the same keys in every run, so they are recorded once:
    inside :meth:`recording`, each request of the roots' keys (:meth:`root`)
    is logged with its kind and its path, and is served at once by a
    :class:`Keys` of the source (a mapping from root names), so the recorded
    step is an ordinary step. :meth:`rows` gives the logged requests as plan
    rows; inside :meth:`serving`, request ``i`` is ``buffer[i:i+1]`` and must be
    the ``i``-th logged one."""

    def __init__(self):
        self.log: list[Request] = []
        self.buffer: torch.Tensor | None = None  # int32 [len(log)], set by the owner
        self._source: Mapping[str, Keys] | None = None
        self._next: int | None = None

    def root(self, name: str) -> "SlotKey":
        return SlotKey(self, name, ())

    @contextlib.contextmanager
    def recording(self, source: Mapping[str, Keys]):
        """Log the block's requests anew, each served at once by ``source``."""
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

    def rows(self, prefixes: Mapping[str, tuple]) -> list[prng.Row]:
        """The logged requests as plan rows, each root's path below the plan's
        key given by ``prefixes``."""
        return [prng.Row(kind, (1,), tuple(prefixes[root]) + path)
                for kind, root, path in self.log]

    def _request(self, kind: str, root: str, path: tuple) -> torch.Tensor:
        if self._source is not None:
            self.log.append((kind, root, path))
            key = Keys(self._source[root].root, self._source[root].path + path)
            return key.words() if kind == "words" else key.edge_seed()
        if self._next is None:
            raise RuntimeError("key slots: a request outside recording() and serving()")
        i = self._next
        if i >= len(self.log) or self.log[i] != (kind, root, path):
            raise RuntimeError(f"key slots: request {i} {(kind, root, path)} is not the "
                               "recorded step's")
        self._next += 1
        return self.buffer[i:i + 1]


class SlotKey:
    """A keys object of :class:`KeySlots`: ``root`` and the path of children to it."""

    def __init__(self, slots: KeySlots, root: str, path: tuple):
        self.slots, self.root, self.path = slots, root, path

    def split(self, num: int) -> list["SlotKey"]:
        return [SlotKey(self.slots, self.root, self.path + (i,)) for i in range(num)]

    def words(self) -> torch.Tensor:
        return self.slots._request("words", self.root, self.path)

    def edge_seed(self) -> torch.Tensor:
        return self.slots._request("edge_seed", self.root, self.path)


class KeyLog(KeySlots):
    """An eager step part's key requests, drawn in the launch of the part's draws.

    A part asks for the same keys at every step, so the requests of its last
    run (:attr:`log`, renewed by :meth:`renew`) become rows of the next run's
    plan (:meth:`rows`), and :meth:`begin` hands over their draws. A request is
    served from those draws while the run repeats the log request for request;
    from the first that does not, each is drawn alone by a :class:`Keys` of the
    source, as :class:`Keys` draws it, so the values do not depend on the log."""

    def __init__(self):
        super().__init__()
        self._seen: list[Request] | None = None
        self._values: Sequence[torch.Tensor] = ()
        self._matching = False

    def renew(self) -> None:
        """Take the last run's requests as the log (before the next run's rows)."""
        if self._seen is not None:
            self.log, self._seen = self._seen, None

    def begin(self, source: Mapping[str, Keys], values: Sequence[torch.Tensor]) -> None:
        """Serve a new run: ``values`` are the draws of :meth:`rows`, in order."""
        self._source, self._values = source, values
        self._seen, self._matching = [], True

    def _request(self, kind: str, root: str, path: tuple) -> torch.Tensor:
        if self._seen is None:
            raise RuntimeError("key log: a request before begin()")
        i = len(self._seen)
        self._seen.append((kind, root, path))
        self._matching = self._matching and i < len(self.log) and self.log[i] == (kind, root,
                                                                                   path)
        if self._matching:
            return self._values[i]
        key = Keys(self._source[root].root, self._source[root].path + path)
        return key.words() if kind == "words" else key.edge_seed()
