"""Driver of one ``QmcIsingGraph`` with the heat-bath diagonal update and a
thinned cluster update (``"engine": "sse_graph_heatbath"``): as
:mod:`benchmark.engines.sse_graph`, closed chunks of ``multi_sweep``
timesteps back to back, each followed by ``_maybe_grow``, with the graph's
heat-bath arguments (``_diag_args()``) and ``cluster_every`` passed on, and
each checked chunk held to :mod:`benchmark.reference.sse_heatbath`.

Traffic keys: ``update`` (``"heatbath"``; the configuration's ``diagonal``
must say so too), ``cluster_every``, ``chunk``, ``warmup_timesteps``,
``checked_chunks`` and ``profile``, as ``sse_graph``'s.

Traced, the summary also holds ``stage_device_s``: the slice's device time
by the program's span (``sse.diagonal``, ``sse.cluster``, else ``other``)
that holds the runtime call which launched it (a kernel, a graph, a copy),
matched by the profiler's correlation ids; under graphs a span's host time
is mostly waiting, and this is its time on the card. Beside it,
``heatbath_updates``: the program's ``sse.diagonal.heatbath`` count in the
slice's timesteps."""

from __future__ import annotations

import bisect
import contextlib
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

from benchmark import check, draws, lattices, metrics
from benchmark import trace as tr
from benchmark.reference import sse as ref
from benchmark.reference import sse_heatbath as ref_hb
from isingmontecarlo_tpu_torch.sse.ising import QmcIsingGraph, multi_sweep

# The program's spans whose device time the slice reports.
STAGES = ("sse.diagonal", "sse.cluster")


def prepare(cell, seed: int, device) -> SimpleNamespace:
    """The cell's graph with heat-bath, built from the seed on ``device``
    and warmed up, on the benchmark's draws."""
    cfg, tf = cell.config, cell.traffic
    dev = torch.device(device)
    if cfg.get("diagonal") != "heatbath" or tf["update"] != "heatbath":
        raise ValueError(f"{cell.name}: this engine and its reference run the heat-bath "
                         "diagonal update only")
    edges = lattices.build(cfg["lattice"])
    N = max(max(a, b) for (a, b), _ in edges) + 1
    R = cfg["replicas"]
    s_spins, s_draws, s_pick = draws.sub_seeds(seed, 3)
    spins = draws.uniform(draws.generator(s_spins, dev), (R, N)) < 0.5
    gen = draws.generator(s_draws, dev)
    d = draws.SeededDraws(gen)
    g = QmcIsingGraph(edges, cfg["transverse"], cfg["longitudinal"], cutoff=cfg["cutoff_hint"],
                      replicas=R, state=spins, device=dev)
    g.draws = d
    g.set_enable_heatbath(True)
    g.set_cluster_every(tf["cluster_every"])
    g.timesteps(tf["warmup_timesteps"], cfg["beta"], chunk=tf["chunk"])
    return SimpleNamespace(g=g, d=d, gen=gen, dev=dev, N=N, R=R, beta=cfg["beta"],
                           chunk=tf["chunk"], k=tf["cluster_every"], s_pick=s_pick,
                           model=ref.tfim(edges, cfg["transverse"], cfg["longitudinal"]),
                           sync=torch.cuda.synchronize if dev.type == "cuda" else (lambda: None))


def chunk(x: SimpleNamespace):
    """One chunk of the window: ``multi_sweep`` with heat-bath, then
    ``_maybe_grow``."""
    g = x.g
    with tr.span("multi_sweep"):
        g.sse, ns, _, _ = multi_sweep(g.sse, x.beta, g.model, x.chunk, lambda: x.d,
                                      cluster_caps=g._cluster_caps, cluster_every=x.k,
                                      **g._diag_args())
    with tr.span("maybe_grow"):
        g._maybe_grow()
    return ns


def reference_chunk(start: dict, x: SimpleNamespace, precision: str = "float32") -> dict:
    """The reference's end of a chunk from the program's state at its start
    (a host snapshot with the generator's state)."""
    return ref_hb.chunk(start, x.model, x.beta, x.chunk, x.k,
                        check._restored(start["gen"], x.dev), x.dev, precision)


def start_snapshot(x: SimpleNamespace) -> dict:
    return check.snapshot(x.g.sse, caps=x.g._cluster_caps, gen=x.gen.get_state())


def control(cell, seeds: list, device) -> list[dict]:
    """The comparison's readings on one chunk after the warm-up, for each
    seed: of the program (``program``), and of the reference computed in
    bfloat16 in the program's place (``control``)."""
    out = []
    for seed in seeds:
        x = prepare(cell, seed, device)
        g = x.g
        start = check.to_host(start_snapshot(x))
        ns = chunk(x)
        end = check.to_host(check.snapshot(g.sse, caps=g._cluster_caps, ns=ns))
        want = reference_chunk(start, x)
        ctrl = reference_chunk(start, x, precision="bfloat16")
        out.append({"program": check.compare(want, end), "control": check.compare(want, ctrl)})
    return out


def stage_device_s(device: list, runtime: dict, spans: list) -> dict:
    """Device seconds by stage: ``device`` holds ``(correlation id,
    seconds)`` of each device operation, ``runtime`` the host start (ns) of
    each runtime call by correlation id, ``spans`` ``(start_ns, end_ns,
    name)`` of the stages' spans, which do not overlap. An operation goes to
    the span that holds its runtime call's start, ``other`` where none does,
    ``unmatched`` where no runtime call has its correlation id."""
    spans = sorted(spans)
    starts = [s for s, _, _ in spans]
    out = dict.fromkeys((*STAGES, "other", "unmatched"), 0.0)
    for corr, seconds in device:
        t = runtime.get(corr)
        if t is None:
            out["unmatched"] += seconds
            continue
        i = bisect.bisect_right(starts, t) - 1
        out[spans[i][2] if i >= 0 and t <= spans[i][1] else "other"] += seconds
    return out


class StageSlice(tr.Slice):
    """:class:`benchmark.trace.Slice` whose summary adds the device time by
    the program's stage (``stage_device_s``) and the slice's heat-bath
    diagonal updates (``heatbath_updates``): None where the program records
    no such span or counter."""

    def summary(self, timesteps: int, shapes: dict, step_s: float) -> dict:
        out = super().summary(timesteps, shapes, step_s)
        from isingmontecarlo_tpu_torch import profiling

        last = getattr(profiling, "last_steps", None)
        rec = last(timesteps) if last else None
        spans = [(s.start_ns, s.end_ns, s.name) for s in rec.spans
                 if s.name in STAGES] if rec else []
        device, runtime = [], {}
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                if not e.name().startswith(tr.SPAN):
                    device.append((e.correlation_id(), (e.end_ns() - e.start_ns()) / 1e9))
            elif e.correlation_id():
                runtime[e.correlation_id()] = e.start_ns()
        out["stage_device_s"] = stage_device_s(device, runtime, spans) if spans else None
        out["heatbath_updates"] = rec.counts.get("sse.diagonal.heatbath") if rec else None
        return out


def run(cell, seed: int, seconds: float, traced: bool, device, t0: float) -> dict:
    x = prepare(cell, seed, device)
    g, sync, R, N, tf = x.g, x.sync, x.R, x.N, cell.traffic
    sync()

    pick = np.random.default_rng(x.s_pick)
    checked = sorted({int(pick.integers(lo, hi)) for lo, hi in tf["checked_chunks"]})
    prof = tf["profile"]
    sliced = StageSlice(x.dev) if traced else None
    last_needed = max(checked + ([prof["first"] + prof["chunks"]] if traced else []))
    starts, ends, times, series = {}, {}, [], []
    shapes = None
    i, t_first = 0, None
    while True:
        if i in checked:
            starts[i] = start_snapshot(x)
        if traced and i == prof["first"]:
            sliced.start()
        discard = sliced.discarded() if traced and i == prof["discard"] else contextlib.nullcontext()
        with discard:
            c0 = time.perf_counter()
            ns = chunk(x)
            sync()
            c1 = time.perf_counter()
        if traced and i == prof["first"] + prof["chunks"] - 1:
            sliced.stop()
            C, E = ref.label_shape(g.cutoff, N, g._cluster_caps)
            shapes = {"M": g.cutoff, "R": R, "label_rows": C, "edge_rows": E}
        t_first = c0 if t_first is None else t_first
        times.append(c1 - c0)
        series.append(ns)
        if i in checked:
            ends[i] = check.snapshot(g.sse, caps=g._cluster_caps, ns=ns)
        i += 1
        if c1 - t_first >= seconds and i > last_needed:
            break
    window = c1 - t_first
    peak = torch.cuda.max_memory_allocated(x.dev) if x.dev.type == "cuda" else 0
    ns_series = torch.cat(series).cpu().numpy().astype(np.float64)
    tau = metrics.integrated_autocorrelation_time(ns_series)
    ess = ns_series.shape[0] * R / tau
    print(f"{cell.name}: {i} chunks of {x.chunk} in {window:.3f} s; chunk ms median "
          f"{1e3 * metrics.percentile(times, 50):.3f}, p95 {1e3 * metrics.percentile(times, 95):.3f} "
          f"over {len(times)} chunks; cutoff {g.cutoff}, caps {g._cluster_caps}; "
          f"op-count tau_int {tau:.3f} over {ns_series.shape[0]} timesteps, energy ESS/s "
          f"{ess / window:.1f}; peak {peak} bytes", file=sys.stderr)

    del series
    totals = {"state_mismatch": 0, "ns_mismatch": 0, "growth_mismatch": 0}
    failed = 0
    r0 = time.perf_counter()
    for c in checked:
        want = reference_chunk(check.to_host(starts[c]), x)
        got = check.compare(want, check.to_host(ends[c]))
        failed += any(got.values())
        for key, v in got.items():
            totals[f"{key}_mismatch"] += v
    print(f"{cell.name}: reference replayed chunks {checked} in "
          f"{time.perf_counter() - r0:.1f} s", file=sys.stderr)
    summary = None
    if traced:
        summary = sliced.summary(prof["chunks"] * x.chunk, shapes,
                                 tr.untraced_step_s(times, prof["discard"], x.chunk))
        print(f"{cell.name}: traced slice's device s by stage {summary['stage_device_s']}, "
              f"busy {summary['busy_s']:.4f} s; heat-bath updates {summary['heatbath_updates']} "
              f"of {summary['timesteps']} timesteps", file=sys.stderr)
    return {
        "metrics": {"replica_sweeps_per_s": R * x.chunk * i / window,
                    "setup_s": t_first - t0},
        "checks": totals, "attempted": i, "failed": failed, "memory_peak_bytes": peak,
        "trace": summary,
    }
