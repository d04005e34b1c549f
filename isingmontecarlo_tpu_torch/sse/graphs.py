"""CUDA graphs of the SSE timestep's stages (:func:`sse.ising.sweep`).

On the card a timestep's host time goes to launches: at the 32x32 shape
about 300 small kernels, against 3.3-3.4 ms of device work. ``sweep`` runs
each stage that holds no host read through a :class:`Stager`, which
captures the stage's launches once as a ``torch.cuda.CUDAGraph`` and
replays it from then on. The stages are ``diagonal``, ``segment_graph``,
``compact`` (or ``label_init``), ``flips`` (or ``flips_noop``) and
``free_spins``. The host reads between them (the ``fits`` read, the hook
rounds' flag reads) and the draws stay eager, so the stream of uniforms is
the eager one's.

- **Keys.** A stage's graph is keyed by the stage's name, the sweep's sizes
  that the stage depends on (M, and the label and edge caps) and the
  signature of its arguments: each tensor's shape, dtype and device, and
  every other argument's value (the model by identity, the flags, the
  label sizes). A key is captured on its second consecutive use by its
  stage, so the one-off shapes of a growing cutoff run eagerly. M and the
  caps only grow, so a capture drops the stage's graphs whose sizes its
  own exceed.
- **Memory.** The graphs of one stage share one memory pool, so that a
  recapture reuses what the graphs it replaces held. Two graphs of a
  stage never run in one sweep, and what a graph writes is read in the
  sweep that replays it, so one graph's scratch may hold another's
  outputs.
- **Inputs.** A capture clones its tensor arguments, except those that are
  static tensors of another graph of the same model (the previous stage's
  outputs): it reads those in place. A replay copies into each static
  input the argument that is not already that tensor.
- **Outputs** are the graph's static tensors, which the next replay
  overwrites: :meth:`Stager.detach` clones those that ``sweep`` hands back.
- A CPU tensor runs eagerly. A capture that raises a ``RuntimeError`` (an
  operation that a capture does not allow) warns, and leaves its key to run
  eagerly from then on.

Counters (:func:`profiling.count`), one a stage run: ``sse.graph.replays``,
``sse.graph.captures`` and ``sse.graph.eager``; besides,
``sse.graph.failed`` counts the captures that raised. A replay adds the
captured kernels' launches to the wrappers' ``launches``
(:func:`ops.launch_counts`), as if they had been launched one by one.
"""

from __future__ import annotations

import warnings
import weakref
from typing import Any, Callable, NamedTuple

import torch

from isingmontecarlo_tpu_torch import ops as _kernels
from isingmontecarlo_tpu_torch import profiling


def _leaves(x) -> list[torch.Tensor]:
    """The tensors of a nest of tuples, in order."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, tuple):
        return [t for y in x for t in _leaves(y)]
    return []


def _rebuild(x, fn: Callable[[torch.Tensor], torch.Tensor]):
    """``x`` with each tensor ``t`` of the nest replaced by ``fn(t)``."""
    if isinstance(x, torch.Tensor):
        return fn(x)
    if isinstance(x, tuple):
        items = [_rebuild(y, fn) for y in x]
        return type(x)(*items) if hasattr(x, "_fields") else tuple(items)
    return x


def signature(x):
    """What a graph captured for the arguments ``x`` depends on: each
    tensor's shape, dtype and device, each module's identity, and every
    other value as it is."""
    if isinstance(x, torch.Tensor):
        return (tuple(x.shape), x.dtype, x.device)
    if isinstance(x, tuple):
        return (type(x), tuple(signature(y) for y in x))
    if isinstance(x, torch.nn.Module):
        return (type(x), id(x))
    return x


def _outgrown(old: tuple, new: tuple) -> bool:
    """Whether sizes ``new`` exceed ``old``: no smaller anywhere, larger
    somewhere (a size that is None, no cap, only equals None)."""
    return old != new and all(
        o == n or (o is not None and n is not None and o <= n) for o, n in zip(old, new))


class _Entry(NamedTuple):
    graph: Any  # torch.cuda.CUDAGraph
    inputs: list  # the static inputs, in the order of the arguments' tensors
    outputs: Any  # what the stage returned at capture, static tensors inside
    launches: tuple  # (wrapper, launches of its kernel a replay)


def capturable(device: torch.device) -> bool:
    return device.type == "cuda"


_STREAMS: dict = {}


def capture(fn: Callable, args: tuple, device: torch.device, pool=None):
    """``(graph, outputs)``: ``fn(*args)`` captured on a side stream of
    ``device``, its memory from ``pool`` (another graph's ``pool()``) where
    given. Nothing runs until the graph is replayed."""
    side = _STREAMS.get(device)
    if side is None:
        side = _STREAMS[device] = torch.cuda.Stream(device)
    cur = torch.cuda.current_stream(device)
    graph = torch.cuda.CUDAGraph()
    side.wait_stream(cur)
    with torch.cuda.device(device), torch.cuda.stream(side):
        if pool is None:
            graph.capture_begin()
        else:
            graph.capture_begin(pool=pool)
        try:
            outputs = fn(*args)
        finally:
            graph.capture_end()
    cur.wait_stream(side)
    return graph, outputs


def _same(static: torch.Tensor, t: torch.Tensor) -> bool:
    return static is t or (static.data_ptr() == t.data_ptr()
                           and static.stride() == t.stride())


class GraphCache:
    """The captured stage graphs of one model: by key, an entry, or None
    where the capture raised; each stage's last key and memory pool; and
    the static tensors of the live entries, by ``id``."""

    def __init__(self):
        self.entries: dict[tuple, _Entry | None] = {}
        self.last: dict[str, tuple] = {}
        self.pools: dict[str, Any] = {}
        self.statics: dict[int, torch.Tensor] = {}

    def owns(self, t: torch.Tensor) -> bool:
        return id(t) in self.statics

    def run(self, key: tuple, fn: Callable, args: tuple, device: torch.device):
        name = key[0]
        consecutive = self.last.get(name) == key
        self.last[name] = key
        if key in self.entries:
            entry = self.entries[key]
            if entry is not None:
                profiling.count("sse.graph.replays")
                return self._replay(entry, args)
        elif consecutive:
            entry = self._capture(key, fn, args, device)
            if entry is not None:
                profiling.count("sse.graph.captures")
                entry.graph.replay()
                return entry.outputs
        profiling.count("sse.graph.eager")
        return fn(*args)

    def _replay(self, entry: _Entry, args: tuple):
        for static, t in zip(entry.inputs, _leaves(args)):
            if not _same(static, t):
                static.copy_(t)
        entry.graph.replay()
        for wrapper, n in entry.launches:
            wrapper.launches += n
        return entry.outputs

    def _capture(self, key: tuple, fn: Callable, args: tuple, device: torch.device):
        statics = _rebuild(args, lambda t: t if self.owns(t) else t.clone())
        before = [k.launches for k in _kernels.KERNELS]
        try:
            graph, outputs = capture(fn, statics, device, self.pools.get(key[0]))
        except RuntimeError as exc:
            for k, n in zip(_kernels.KERNELS, before):
                k.launches = n
            profiling.count("sse.graph.failed")
            warnings.warn(f"the CUDA graph capture of the stage {key[0]!r} failed; the "
                          f"stage runs eagerly at these shapes: {exc}", RuntimeWarning)
            self.entries[key] = None
            return None
        launches = tuple((k, k.launches - n) for k, n in zip(_kernels.KERNELS, before)
                         if k.launches != n)
        self.pools.setdefault(key[0], graph.pool())
        entry = _Entry(graph, _leaves(statics), outputs, launches)
        # After the capture, so that the stage's pool always has a live
        # graph: an outgrown graph's memory goes back to the pool.
        for k in [k for k in self.entries if k[0] == key[0] and _outgrown(k[1], key[1])]:
            del self.entries[k]
        self.entries[key] = entry
        self._index()
        return entry

    def _index(self) -> None:
        self.statics = {id(t): t for e in self.entries.values() if e is not None
                        for t in e.inputs + _leaves(e.outputs)}


_CACHES: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()


def cache_of(model: torch.nn.Module) -> GraphCache:
    """The graph cache of ``model``, dropped with it."""
    cache = _CACHES.get(model)
    if cache is None:
        cache = _CACHES[model] = GraphCache()
    return cache


class Stager:
    """Runs one sweep's stages: ``stager(name, fn, *args)`` returns
    ``fn(*args)``, through the graphs of ``cache`` where there is one,
    eagerly otherwise. ``size`` is the sweep's ``(M, label_cap,
    edge_cap)``."""

    __slots__ = ("cache", "size", "device")

    def __init__(self, cache: GraphCache | None, size: tuple, device: torch.device):
        self.cache, self.size, self.device = cache, size, device

    def resized(self, size: tuple) -> "Stager":
        """The stager of the stages that depend on ``size`` alone."""
        return Stager(self.cache, size, self.device)

    def __call__(self, name: str, fn: Callable, *args):
        if self.cache is None:
            profiling.count("sse.graph.eager")
            return fn(*args)
        return self.cache.run((name, self.size, signature(args)), fn, args, self.device)

    def detach(self, x):
        """``x`` with each static tensor of the cache cloned: what a caller
        may hold across later replays."""
        if self.cache is None:
            return x
        return _rebuild(x, lambda t: t.clone() if self.cache.owns(t) else t)


def stager(model: torch.nn.Module, device: torch.device, size: tuple) -> Stager:
    """The stage runner of a sweep of ``model`` on ``device``, of sizes
    ``(M, label_cap, edge_cap)``."""
    return Stager(cache_of(model) if capturable(device) else None, size, device)


def run_eager(name: str, fn: Callable, *args):
    """The stage runner of the callers outside ``sweep``: ``fn(*args)``,
    uncounted."""
    return fn(*args)
