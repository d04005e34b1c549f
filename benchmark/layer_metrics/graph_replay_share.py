"""The SSE timestep's stage runs that replayed a captured CUDA graph, in
percent: the program's ``sse.graph.replays`` count over the sum of
``sse.graph.replays``, ``sse.graph.captures`` and ``sse.graph.eager`` (one
count a stage run, ``sse/graphs.py``) in the traced slice's timesteps.
Moves ``replica_sweeps_per_s``: a replay launches a stage's kernels in one
call of the host. None where the program counts no stage run (a program
without the graphs)."""

from benchmark.layer_metrics._recorder import slice_recording

RUNS = ("sse.graph.replays", "sse.graph.captures", "sse.graph.eager")


def read(trace: dict) -> float | None:
    rec = slice_recording(trace)
    if rec is None:
        return None
    runs = sum(rec.counts.get(name, 0) for name in RUNS)
    return 100.0 * rec.counts.get(RUNS[0], 0) / runs if runs else None
