"""Cutoff growth a timestep: the host wall time of the program's ``sse.grow``
spans (``QmcIsingGraph._maybe_grow``, one a chunk, its host read waiting for
the chunk's queued work), in ms over the traced slice's timesteps. A host
time under the profiler, waits on host reads included. Moves
``replica_sweeps_per_s``."""

from benchmark.layer_metrics._recorder import span_ms_per_step


def read(trace: dict) -> float | None:
    return span_ms_per_step(trace, "sse.grow")
