"""The card's idle share of a timestep, in percent: one less the union of
the traced slice's device events' intervals (kernels, copies, memsets; not
the collectives' kernels, which spin while they wait for the slowest rank
and have their own metric) a timestep, over the wall a timestep of the
window's chunks that ran without the profiler. The profiler slows the
host's launches, not the card's work, so the slice's own wall would read
the card idler than it is."""


def read(trace: dict) -> float | None:
    if not trace["events"] or trace["step_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["work_s"] / trace["timesteps"] / trace["step_s"])
