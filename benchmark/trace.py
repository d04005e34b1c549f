"""The traced slice: a bounded run of chunks under ``torch.profiler`` (host
and card), reduced to a small summary that the per-layer readers and the
result's ``breakdown`` read. No Chrome trace is written."""

from __future__ import annotations

import bisect
import contextlib
import time
from collections import defaultdict

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from benchmark import metrics

# The harness's spans around the calls into the program's layers.
SPAN = "bench."
# Longer names (PyTorch's kernels' template arguments) are cut to this.
NAME_CHARS = 100


def span(layer: str) -> record_function:
    return record_function(SPAN + layer)


def is_collective(name: str) -> bool:
    """A collective's kernel (NCCL): on the card it spins while it waits for
    the slowest rank, so it counts as no work of this rank's."""
    return "nccl" in name.lower()


def untraced_step_s(times: list, before: int, steps: int) -> float:
    """The wall seconds a timestep of the window's first ``before`` chunks
    (``times`` a chunk's each, ``steps`` timesteps a chunk): those that ran
    before the first profiler session. Once a session has run, the host's
    launches stay slower for the rest of the process (chunks of
    ``two_d_32_k1`` took a median 117 ms after it against 95 ms in an
    untraced run, NVIDIA H100 80GB HBM3), so the chunks after the slice
    are no untraced measure."""
    return sum(times[:before]) / (before * steps)


class Slice:
    """Profiles the chunks between :meth:`start` and :meth:`stop`, after a
    discarded session (a process's first profiler session runs slow)."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.prof = None
        self.wall_s = 0.0

    def _activities(self):
        # On the card, CUDA activity alone: kernels, copies and the runtime's
        # calls. Recording every host operation as well doubles a
        # timestep's host time and with it the idle share.
        return [ProfilerActivity.CUDA] if self.cuda else [ProfilerActivity.CPU]

    def _sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    @contextlib.contextmanager
    def discarded(self):
        with profile(activities=self._activities()):
            yield
            self._sync()

    def start(self):
        self._sync()
        self.prof = profile(activities=self._activities())
        self.prof.__enter__()
        self._t0 = time.perf_counter()

    def stop(self):
        self._sync()
        self.wall_s = time.perf_counter() - self._t0
        self.prof.__exit__(None, None, None)

    def summary(self, timesteps: int, shapes: dict, step_s: float) -> dict:
        """Device events by name, the union of their intervals (``busy_s``)
        and of those of all but the collectives (``work_s``), the slice's
        wall (``window_s``), the wall a timestep outside the slice
        (``step_s``), the largest device operations and the idle gaps by the
        host event (on the card, a runtime call) that ran across them."""
        dev, host = [], []
        for e in self.prof.profiler.kineto_results.events():
            start, end = e.start_ns() / 1e9, e.end_ns() / 1e9
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                # The harness's spans also mark the card's timeline; they
                # are no device work.
                if not e.name().startswith(SPAN):
                    dev.append((e.name(), start, end))
            elif e.device_type() == torch.autograd.DeviceType.CPU:
                host.append((start, end, e.name()[:NAME_CHARS]))
        by_name: dict = defaultdict(lambda: [0, 0.0])
        for name, s, e in dev:
            by_name[name][0] += 1
            by_name[name][1] += e - s
        intervals = [(s, e) for _, s, e in dev]
        busy = metrics.merged_length(intervals)
        work = metrics.merged_length((s, e) for name, s, e in dev if not is_collective(name))
        top_ops = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
        return {"timesteps": timesteps, "window_s": self.wall_s, "busy_s": busy,
                "work_s": work, "step_s": step_s,
                "events": {k: list(v) for k, v in by_name.items()}, "shapes": shapes,
                "device_ops": [[k[:NAME_CHARS], v[1]] for k, v in top_ops],
                "idle_gaps": _gaps_by_host_op(metrics.gaps(intervals), host)}


def _gaps_by_host_op(gaps, host, scan: int = 400) -> list:
    """The idle gaps' seconds summed by what the host was running at each
    gap's middle: the innermost ``aten`` operation and the innermost host
    event there (a runtime call, say), or ``python`` where no recorded host
    event covers it (the interpreter between calls into CUDA). The ten
    largest sums."""
    host.sort()
    starts = [h[0] for h in host]
    out: dict = defaultdict(float)
    for s, e in gaps:
        mid = 0.5 * (s + e)
        i = bisect.bisect_right(starts, mid)
        inner = aten = None
        for j in range(i - 1, max(i - 1 - scan, -1), -1):
            hs, he, name = host[j]
            if he >= mid and not name.startswith(SPAN):
                inner = inner or name
                if name.startswith("aten::"):
                    aten = name
                    break
        if inner is None:
            label = "python"
        elif aten is None or aten == inner:
            label = inner
        else:
            label = f"{aten} > {inner}"
        out[label] += e - s
    return [[k, v] for k, v in sorted(out.items(), key=lambda kv: -kv[1])[:10]]
