"""The cluster update's time on the card a timestep: the device operations
whose runtime call the program's ``sse.cluster`` span holds (``sse/ising.py``
``sweep``: the segment graph, the labels and the flips), in ms over all the
traced slice's timesteps, thinned ones included. Moves
``replica_sweeps_per_s``."""

from benchmark.layer_metrics._stage_device import device_ms_per_step


def read(trace: dict) -> float | None:
    return device_ms_per_step(trace, "sse.cluster")
