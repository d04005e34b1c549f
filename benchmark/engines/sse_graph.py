"""Driver of one ``QmcIsingGraph`` (``"engine": "sse_graph"``): a copy of the
loop of ``QmcIsingGraph.timesteps_measure`` (``sse/ising.py``), closed:
chunks of ``multi_sweep`` timesteps back to back, each followed by
``_maybe_grow``, with each chunk's per-timestep op counts kept on the card
and read once after the window. The method itself is not called (it keeps
no per-timestep series), so a change to it alone does not reach the window.

Traffic keys: ``update`` (``"metropolis"``), ``cluster_every``, ``chunk``
(timesteps a chunk), ``warmup_timesteps`` (through ``timesteps``, which
grows the cutoff first), ``checked_chunks`` (one ``[lo, hi)`` range a
checked chunk, its index drawn from the seed) and ``profile`` (the traced
run's discarded chunk and its slice of chunks; the chunks before the
discarded one, which no profiler has slowed, time the untraced timestep)."""

from __future__ import annotations

import contextlib
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

from benchmark import check, draws, lattices, metrics
from benchmark import trace as tr
from benchmark.reference import sse as ref
from isingmontecarlo_tpu_torch.sse.ising import QmcIsingGraph, multi_sweep


def prepare(cell, seed: int, device) -> SimpleNamespace:
    """The cell's graph, built from the seed on ``device`` and warmed up, on
    the benchmark's draws; what the window and the control start from."""
    cfg, tf = cell.config, cell.traffic
    dev = torch.device(device)
    if tf["update"] != "metropolis":
        raise ValueError(f"{cell.name}: the reference covers the Metropolis update only")
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
    g.set_cluster_every(tf["cluster_every"])
    g.timesteps(tf["warmup_timesteps"], cfg["beta"], chunk=tf["chunk"])
    return SimpleNamespace(g=g, d=d, gen=gen, dev=dev, N=N, R=R, beta=cfg["beta"],
                           chunk=tf["chunk"], k=tf["cluster_every"], s_pick=s_pick,
                           model=ref.tfim(edges, cfg["transverse"], cfg["longitudinal"]),
                           sync=torch.cuda.synchronize if dev.type == "cuda" else (lambda: None))


def chunk(x: SimpleNamespace):
    """One chunk of the window: ``multi_sweep``, then ``_maybe_grow``."""
    g = x.g
    with tr.span("multi_sweep"):
        g.sse, ns, _, _ = multi_sweep(g.sse, x.beta, g.model, x.chunk, lambda: x.d,
                                      cluster_caps=g._cluster_caps, cluster_every=x.k)
    with tr.span("maybe_grow"):
        g._maybe_grow()
    return ns


def control(cell, seeds: list, device) -> list[dict]:
    """The comparison's readings on one chunk after the warm-up, for each
    seed: of the program (``program``), and of the reference computed in
    bfloat16 in the program's place (``control``)."""
    out = []
    for seed in seeds:
        x = prepare(cell, seed, device)
        g = x.g
        start = check.to_host(check.snapshot(g.sse, caps=g._cluster_caps, gen=x.gen.get_state()))
        ns = chunk(x)
        end = check.to_host(check.snapshot(g.sse, caps=g._cluster_caps, ns=ns))
        want = check.graph_chunk(start, x.model, x.beta, x.chunk, x.dev)
        ctrl = check.graph_chunk(start, x.model, x.beta, x.chunk, x.dev, precision="bfloat16")
        out.append({"program": check.compare(want, end), "control": check.compare(want, ctrl)})
    return out


def run(cell, seed: int, seconds: float, traced: bool, device, t0: float) -> dict:
    x = prepare(cell, seed, device)
    g, sync, R, N, tf = x.g, x.sync, x.R, x.N, cell.traffic
    sync()

    pick = np.random.default_rng(x.s_pick)
    checked = sorted({int(pick.integers(lo, hi)) for lo, hi in tf["checked_chunks"]})
    prof = tf["profile"]
    sliced = tr.Slice(x.dev) if traced else None
    last_needed = max(checked + ([prof["first"] + prof["chunks"]] if traced else []))
    starts, ends, times, series = {}, {}, [], []
    shapes = None
    i, t_first = 0, None
    while True:
        if i in checked:
            starts[i] = check.snapshot(g.sse, caps=g._cluster_caps, gen=x.gen.get_state())
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
          f"op-count tau_int {tau:.3f} over {ns_series.shape[0]} timesteps", file=sys.stderr)

    del series
    totals = {"state_mismatch": 0, "ns_mismatch": 0, "growth_mismatch": 0}
    failed = 0
    r0 = time.perf_counter()
    for c in checked:
        want = check.graph_chunk(check.to_host(starts[c]), x.model, x.beta, x.chunk, x.dev)
        got = check.compare(want, check.to_host(ends[c]))
        failed += any(got.values())
        for key, v in got.items():
            totals[f"{key}_mismatch"] += v
    print(f"{cell.name}: reference replayed chunks {checked} in "
          f"{time.perf_counter() - r0:.1f} s", file=sys.stderr)
    return {
        "metrics": {"replica_sweeps_per_s": R * x.chunk * i / window,
                    "energy_ess_per_s": ess / window,
                    "chunk_ms_p95": 1e3 * metrics.percentile(times, 95),
                    "setup_s": t_first - t0},
        "checks": totals, "attempted": i, "failed": failed, "memory_peak_bytes": peak,
        "trace": sliced.summary(prof["chunks"] * x.chunk, shapes,
                                tr.untraced_step_s(times, prof["discard"], x.chunk))
        if traced else None,
    }
