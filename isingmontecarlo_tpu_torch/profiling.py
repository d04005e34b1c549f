"""Tracing and timing helpers (port of ``isingmontecarlo_tpu/profiling.py``),
and the program's own spans and counters.

Usage::

    from isingmontecarlo_tpu_torch import profiling

    with profiling.trace("traces"):       # a Chrome trace, for Perfetto
        with profiling.annotate("timesteps"):
            g.timesteps(100, beta)

    ms = profiling.time_fn(lambda: g.timestep(beta))

**Spans.** The SSE timestep and its driver mark their stages with
:func:`span` (``sse.sweep`` and its children ``sse.diagonal``, ``sse.rvb``,
``sse.cluster`` > ``sse.segment_graph`` / ``sse.labels`` / ``sse.flips``,
``sse.free_spins``; ``sse.grow``; ``pt.swap``, ``pt.samples``;
``dist.all_gather.<tag>``, ``dist.all_reduce.<tag>``). A span is recorded
only while a ``torch.profiler`` session runs (any session: :func:`trace`,
or the caller's own), on the clock that the profiler stamps its events with
(Unix-epoch nanoseconds, ``time.time_ns``), so a span and the operations and
runtime calls inside it line up. Otherwise :func:`span` hands back one
shared null context. Spans are kept in memory (``RECORDER.spans``,
:func:`last_steps`) until :func:`reset_spans`, which a caller that runs
its own sessions calls between them (:func:`trace` calls it as it starts);
they add no device work, no host read and no synchronize, and no event to
the profiler's own record.

**Counters.** :func:`count` adds to a named counter, always (one dict
update a call); while spans are recorded, each count is also tagged with
the timestep it fell in. The program counts each host read of its main
path under ``host_reads.<site>`` (``labels``, ``fits``, ``grow``,
``flags``, ``parity_swaps``, ``tempering_step``), each collective under
``dist.<tag>.calls`` and ``dist.<tag>.bytes``, and each run of a stage of
the SSE timestep under ``sse.graph.replays``, ``sse.graph.captures`` or
``sse.graph.eager`` (``sse/graphs.py``), and each heat-bath diagonal
update under ``sse.diagonal.heatbath`` (``sweep``, on the host, whether the
stage replays or runs eagerly).

**Device time by stage.** A span holds the host's runtime calls that
launch the stage's work (``cudaLaunchKernel``, ``cudaGraphLaunch``, the
copies), so the device operations a span caused are those whose
correlation id (``correlation_id()`` of the profiler's events) is that of
a runtime call inside it: under graphs a stage's span times only the
host's waits, and this attribution gives its time on the card. The
benchmark attributes a traced slice's device time to ``sse.diagonal`` and
``sse.cluster`` so (``benchmark/engines/sse_graph_heatbath.py``).
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from pathlib import Path
from typing import Callable, NamedTuple

import torch
from torch.autograd import profiler as _autograd_profiler
from torch.profiler import ProfilerActivity, profile, record_function

# The span that opens a timestep: each one begun advances the step count
# that every span and count recorded after it is tagged with.
STEP_SPAN = "sse.sweep"


class Span(NamedTuple):
    name: str
    parent: str | None  # the enclosing span's name
    start_ns: int  # Unix-epoch nanoseconds, the profiler's clock
    end_ns: int
    step: int  # sse.sweep spans begun so far


class Recording(NamedTuple):
    """The spans and counts of a run of timesteps (:func:`last_steps`)."""

    spans: list[Span]
    counts: dict[str, int]

    def span_ms(self, name: str) -> float | None:
        """The summed milliseconds of the spans ``name``; None where there
        are none."""
        ns = [s.end_ns - s.start_ns for s in self.spans if s.name == name]
        return sum(ns) / 1e6 if ns else None


class Recorder:
    """The spans recorded so far, the open ones, the step count, and the
    counters (totals, and per ``(name, step)`` while recording)."""

    def __init__(self):
        self.spans: list[Span] = []
        self.open: list[str] = []
        self.steps = 0
        self.counts: dict[str, int] = {}
        self.step_counts: dict[tuple[str, int], int] = {}


RECORDER = Recorder()
_NULL = contextlib.nullcontext()


class _Recorded:
    __slots__ = ("name", "parent", "step", "start")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        rec = RECORDER
        if self.name == STEP_SPAN:
            rec.steps += 1
        self.parent = rec.open[-1] if rec.open else None
        self.step = rec.steps
        rec.open.append(self.name)
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        rec = RECORDER
        rec.open.pop()
        rec.spans.append(Span(self.name, self.parent, self.start, end, self.step))
        return False


def span(name: str):
    """A context manager that records the span ``name`` while a
    ``torch.profiler`` session runs; else the shared null context."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NULL
    return _Recorded(name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` (and, while spans are recorded, to
    its count in the current timestep)."""
    rec = RECORDER
    rec.counts[name] = rec.counts.get(name, 0) + n
    if _autograd_profiler._is_profiler_enabled:
        key = (name, rec.steps)
        rec.step_counts[key] = rec.step_counts.get(key, 0) + n


def counters() -> dict[str, int]:
    """Every counter's total since :func:`reset_counters`."""
    return dict(RECORDER.counts)


def reset_counters(prefix: str = "") -> None:
    """Zero the counters whose names start with ``prefix`` (all of them by
    default), their counts by step included."""
    rec = RECORDER
    for name in [n for n in rec.counts if n.startswith(prefix)]:
        del rec.counts[name]
    for key in [k for k in rec.step_counts if k[0].startswith(prefix)]:
        del rec.step_counts[key]


def reset_spans() -> None:
    """Drop the recorded spans, the step count and the counts tagged by step."""
    RECORDER.spans.clear()
    RECORDER.steps = 0
    RECORDER.step_counts.clear()


def last_steps(n: int) -> Recording | None:
    """The spans and counts of the last ``n`` recorded timesteps (tagged
    with steps past the count less ``n``): a traced slice's own, after
    sessions before it. None where fewer than ``n`` (or no) timesteps were
    recorded."""
    rec = RECORDER
    if n <= 0 or rec.steps < n:
        return None
    lo = rec.steps - n
    counts: dict[str, int] = {}
    for (name, step), c in rec.step_counts.items():
        if step > lo:
            counts[name] = counts.get(name, 0) + c
    return Recording([s for s in rec.spans if s.step > lo], counts)


def _write_spans(path: Path, recorded: list[Span]) -> None:
    """Append ``recorded`` to the Chrome trace at ``path`` as complete
    events on the profiler's time base (``baseTimeNanoseconds``)."""
    doc = json.loads(path.read_text())
    base = doc.get("baseTimeNanoseconds", 0)
    pid, tid = os.getpid(), threading.get_native_id()
    doc["traceEvents"].extend(
        {"ph": "X", "cat": "program_span", "name": s.name, "pid": pid, "tid": tid,
         "ts": (s.start_ns - base) / 1e3, "dur": (s.end_ns - s.start_ns) / 1e3,
         "args": {"parent": s.parent, "step": s.step}}
        for s in recorded)
    path.write_text(json.dumps(doc))


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block with ``torch.profiler`` (the host, and the card
    where CUDA is available) and write a Chrome trace
    ``trace.<pid>.json`` into ``log_dir``, with the program's spans of the
    block in it. Yields the profile, whose ``events()`` and
    ``key_averages()`` are read after the block. Starts from
    :func:`reset_spans`: the recorder then holds the block's spans alone."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    reset_spans()
    with profile(activities=activities) as prof:
        yield prof
    path = out / f"trace.{os.getpid()}.json"
    prof.export_chrome_trace(str(path))
    _write_spans(path, RECORDER.spans)


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def time_fn(fn: Callable[[], object], iters: int = 3, warmup: int = 1) -> float:
    """Best milliseconds of ``fn()`` over ``iters`` calls after ``warmup``
    calls: the host clock around a call, with the card synchronised before
    and after it where CUDA is in use (PyTorch returns before the card has
    finished)."""
    for _ in range(warmup):
        fn()
    best = float("inf")
    for _ in range(iters):
        _sync()
        t0 = time.perf_counter()
        fn()
        _sync()
        best = min(best, time.perf_counter() - t0)
    return best * 1e3


def annotate(name: str) -> record_function:
    """A named span in the profile and the trace."""
    return record_function(name)
