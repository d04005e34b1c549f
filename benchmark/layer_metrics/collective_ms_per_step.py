"""Milliseconds of collective kernels (NCCL) on the card a timestep, on
rank 0 of a sharded run: the swap's gathers, the samples' gather and the
growth's reductions (the harness's own stop flag is not sent in the traced
slice)."""

from benchmark.trace import is_collective


def read(trace: dict) -> float | None:
    secs = [s for name, (_, s) in trace["events"].items() if is_collective(name)]
    if not secs:
        return None
    return 1e3 * sum(secs) / trace["timesteps"]
