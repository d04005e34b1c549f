"""The diagonal update's time on the card a timestep: the device operations
(graph replays' kernels, the draws, copies) whose runtime call the
program's ``sse.diagonal`` span holds (``sse/ising.py`` ``sweep``: the
draws and ``diagonal_update`` with K2 and K3 or K3-hb), in ms over the
traced slice's timesteps. Moves ``replica_sweeps_per_s``."""

from benchmark.layer_metrics._stage_device import device_ms_per_step


def read(trace: dict) -> float | None:
    return device_ms_per_step(trace, "sse.diagonal")
