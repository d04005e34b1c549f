"""K3-hb's share of its roofline (``ops/diag_carry.py``, the heat-bath carry
kernel): the bytes its call needs at the slice's shapes (``M`` the cutoff,
``R`` the replicas) over the card's HBM bandwidth, divided by its mean
device time a call."""

from benchmark import metrics
from benchmark.layer_metrics._carry_heatbath_bytes import carry_heatbath_bytes


def read(trace: dict) -> float | None:
    calls = [(n, s) for name, (n, s) in trace["events"].items()
             if "carry_kernel" in name and "HeatBath" in name]
    count = sum(n for n, _ in calls)
    if not count:
        return None
    sh = trace["shapes"]
    seconds = sum(s for _, s in calls) / count
    return metrics.roofline_share(carry_heatbath_bytes(sh["M"], sh["R"]), seconds)
