"""Hook-and-compress rounds a timestep: the program's ``host_reads.labels``
counter (one flag read to the host a round, ``sse/cluster.py``
``hook_compress_labels``) over the traced slice's timesteps. Moves
``replica_sweeps_per_s``: each round is a launch pair and a stall of the
host until the card drains its queue."""

from benchmark.layer_metrics._recorder import slice_recording


def read(trace: dict) -> float | None:
    rec = slice_recording(trace)
    if rec is None:
        return None
    return rec.counts.get("host_reads.labels", 0) / trace["timesteps"]
