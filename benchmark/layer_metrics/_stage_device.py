"""What the readers of the device time by stage share: the milliseconds a
timestep of the traced slice's device operations launched from inside the
program's span ``name`` (the summary's ``stage_device_s``, which
``engines/sse_graph_heatbath.py`` attributes by the profiler's correlation
ids). None where the trace holds no events or no such attribution (a
program without the spans)."""


def device_ms_per_step(trace: dict, name: str) -> float | None:
    stages = trace.get("stage_device_s")
    if not trace["events"] or not stages or name not in stages:
        return None
    return 1e3 * stages[name] / trace["timesteps"]
