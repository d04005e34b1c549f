"""K3's share of its roofline (``ops/diag_carry.py``, the Metropolis carry
kernel): the bytes its call needs at the slice's shapes (``M`` the cutoff,
``R`` the replicas) over the card's HBM bandwidth, divided by its mean
device time a call."""

from benchmark import metrics


def read(trace: dict) -> float | None:
    calls = [(n, s) for name, (n, s) in trace["events"].items()
             if "carry_kernel" in name and "Metropolis" in name]
    count = sum(n for n, _ in calls)
    if not count:
        return None
    sh = trace["shapes"]
    seconds = sum(s for _, s in calls) / count
    return metrics.roofline_share(metrics.carry_decisions_bytes(sh["M"], sh["R"]), seconds)
