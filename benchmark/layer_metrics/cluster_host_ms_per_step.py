"""The cluster update a timestep: the host wall time of the program's
``sse.cluster`` spans (``sse/ising.py`` ``sweep``: the segment graph, the
labels and the flips), in ms over the traced slice's timesteps. A host time
under the profiler, waits on host reads included. Moves
``replica_sweeps_per_s``."""

from benchmark.layer_metrics._recorder import span_ms_per_step


def read(trace: dict) -> float | None:
    return span_ms_per_step(trace, "sse.cluster")
