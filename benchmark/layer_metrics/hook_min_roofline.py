"""K4's ``hook_min`` share of its roofline (``ops/take_kernel.py``): the
bytes of a call on the slice's label problem (``label_rows`` x ``R`` labels,
``edge_rows`` x ``R`` edges) over the card's HBM bandwidth, divided by the
kernel's mean device time a call."""

from benchmark import metrics


def read(trace: dict) -> float | None:
    calls = [(n, s) for name, (n, s) in trace["events"].items() if "hook_min_kernel" in name]
    count = sum(n for n, _ in calls)
    if not count:
        return None
    sh = trace["shapes"]
    seconds = sum(s for _, s in calls) / count
    nbytes = metrics.hook_min_bytes(sh["label_rows"], sh["edge_rows"], sh["R"])
    return metrics.roofline_share(nbytes, seconds)
