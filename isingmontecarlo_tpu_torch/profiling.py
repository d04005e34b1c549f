"""Tracing and timing helpers (port of ``isingmontecarlo_tpu/profiling.py``).

Usage::

    from isingmontecarlo_tpu_torch import profiling

    with profiling.trace("traces"):       # a Chrome trace, for Perfetto
        with profiling.annotate("timesteps"):
            g.timesteps(100, beta)

    ms = profiling.time_fn(lambda: g.timestep(beta))
"""

from __future__ import annotations

import contextlib
import os
import time
from pathlib import Path
from typing import Callable

import torch
from torch.profiler import ProfilerActivity, profile, record_function


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block with ``torch.profiler`` (the host, and the card
    where CUDA is available) and write a Chrome trace
    ``trace.<pid>.json`` into ``log_dir``. Yields the profile, whose
    ``events()`` and ``key_averages()`` are read after the block."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(out / f"trace.{os.getpid()}.json"))


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
