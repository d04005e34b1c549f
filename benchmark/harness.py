"""Finds a cell and its files by name, runs its engine, and prints the result.

A cell (``BENCHMARK.json``'s ``workloads``) names a configuration, whose
file is ``configs[].file``, and a traffic mix, whose file is
``benchmark/traffic/<traffic>.json``; the traffic file names the engine
that drives the window (``benchmark/engines/<engine>.py``). The end-to-end
metrics a cell reports are those whose ``workloads`` name it (all, where a
metric has no such key); its per-layer metrics are those whose
``workloads`` name it, or, without that key, those that move one of its
end-to-end metrics. Each per-layer metric is read from the traced slice by
``benchmark/layer_metrics/<name>.py`` (dots as underscores).

A cell of one card runs its engine's ``run`` in this process. A cell of
several runs its engine's ``rank`` on one spawned process a card, started
before this process imports torch (this module imports none), and reduces
their results with the engine's ``outcome``."""

from __future__ import annotations

import importlib
import json
import sys
from pathlib import Path
from typing import NamedTuple

from benchmark import forbidden, ranks

ROOT = Path(__file__).resolve().parents[1]


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list


def load_spec(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def load_cell(name: str, spec: dict | None = None, root: Path = ROOT) -> Cell:
    spec = spec or load_spec(root)
    try:
        w = next(w for w in spec["workloads"] if w["name"] == name)
    except StopIteration:
        raise ValueError(f"no workload {name!r} in BENCHMARK.json") from None
    c = next(c for c in spec["configs"] if c["name"] == w["config"])
    config = json.loads((root / c["file"]).read_text())
    traffic = json.loads((root / "benchmark" / "traffic" / f"{w['traffic']}.json").read_text())
    e2e = [m for m in spec["end_to_end"] if name in m.get("workloads", [name])]
    moved = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"]
             if (name in m["workloads"] if "workloads" in m else m["moves"] in moved)]
    return Cell(name, w["chips"], config, traffic, e2e, layer)


def reader(metric: str):
    """The ``read(trace)`` of a per-layer metric."""
    return importlib.import_module(f"benchmark.layer_metrics.{metric.replace('.', '_')}").read


def engine(cell: Cell):
    return importlib.import_module(f"benchmark.engines.{cell.traffic['engine']}")


def result(cell: Cell, out: dict, traced: bool, device: dict) -> dict:
    """The result line's object; ``checks`` comes last."""
    if traced:
        tr = out["trace"]
        values = {m["name"]: (reader(m["name"])(tr), m["unit"]) for m in cell.per_layer}
        device = {**device, "busy_s": out.get("busy_s", tr["busy_s"]),
                  "window_s": tr["window_s"]}
    else:
        values = {m["name"]: (out["metrics"][m["name"]], m["unit"]) for m in cell.end_to_end}
    from benchmark import check

    checks = {k: {"value": v, "limit": check.LIMIT} for k, v in out["checks"].items()}
    correct = out["failed"] == 0 and out["attempted"] > 0 and all(
        c["value"] <= c["limit"] for c in checks.values())
    line = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"],
            "metrics": {k: {"value": v, "unit": u} for k, (v, u) in values.items()
                        if v is not None},
            "device": device}
    if traced:
        line["breakdown"] = {"device_ops": out["trace"]["device_ops"],
                             "idle_gaps": out["trace"]["idle_gaps"]}
    line["checks"] = checks
    return line


def main(workload: str, seed: int, seconds: float, traced: bool, t0: float,
         t0_epoch: float) -> int:
    cell = load_cell(workload)
    job = (ranks.start(f"benchmark.engines.{cell.traffic['engine']}:rank", cell.chips, "nccl",
                       cell, seed, seconds, traced, "cuda") if cell.chips > 1 else None)
    try:
        import torch

        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            print(f"{workload} needs {cell.chips} CUDA card(s); this host has "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 3
        torch.set_num_threads(2)
        eng = engine(cell)
        if job is None:
            out = eng.run(cell, seed, seconds, traced, "cuda", t0)
        else:
            # Ranks in processes of their own time set-up from the parent's
            # start by the wall clock; one process by its monotonic clock.
            ranks.mark("parent_ready")
            out = eng.outcome(cell, ranks.join(job, eng.RANK_TIMEOUT_S), traced, t0_epoch)
    finally:
        if job is not None:
            ranks.stop(job)
    found = sorted(set(forbidden.loaded()) | set(out.get("forbidden", [])))
    if found:
        print(f"modules loaded that the benchmark forbids: {found}", file=sys.stderr)
        return 4
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell.chips,
              "memory_peak_bytes": out["memory_peak_bytes"]}
    line = result(cell, out, traced, device)
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
