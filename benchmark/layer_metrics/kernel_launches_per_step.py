"""Kernel launches a timestep: the device kernels of the traced slice (the
port's and PyTorch's; copies and memsets not counted) over its timesteps.
Moves ``replica_sweeps_per_s``: the host spends a few microseconds on each."""


def read(trace: dict) -> float | None:
    events = trace["events"]
    if not events:
        return None
    kernels = sum(n for name, (n, _) in events.items()
                  if not name.startswith(("Memcpy", "Memset")))
    return kernels / trace["timesteps"]
