"""Host reads a timestep: the device-to-host copies of the traced slice
(each ``int()``, ``.item()``, ``.tolist()`` or ``.cpu()`` of a card tensor
makes one) over its timesteps. Moves ``replica_sweeps_per_s``: each read
stalls the host until the card drains its queue."""


def read(trace: dict) -> float | None:
    events = trace["events"]
    if not events:
        return None
    reads = sum(n for name, (n, _) in events.items() if "DtoH" in name)
    return reads / trace["timesteps"]
