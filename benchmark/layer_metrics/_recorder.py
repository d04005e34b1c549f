"""What the readers of the program's recorder share: the spans and counts
of the traced slice's timesteps (``profiling.last_steps``), and a span's
host milliseconds a timestep. None where the trace holds no events or the
program records no such timestep or span (a program without the recorder)."""


def slice_recording(trace: dict):
    from isingmontecarlo_tpu_torch import profiling

    last = getattr(profiling, "last_steps", None)
    return last(trace["timesteps"]) if trace["events"] and last else None


def span_ms_per_step(trace: dict, name: str) -> float | None:
    rec = slice_recording(trace)
    ms = rec.span_ms(name) if rec else None
    return None if ms is None else ms / trace["timesteps"]
