"""Driver of a beta ladder sharded over the cell's cards
(``"engine": "tempering_sharded"``): every rank builds the same
``TemperingContainer``, keeps its block through ``shard_over``, and calls
``timesteps_sample`` back to back; after each call the ranks agree whether
the window is over with one small all-reduce of the harness's own (not
sent inside the traced slice, whose chunks are fixed). The harness starts
:func:`rank` on one process a card before it imports torch itself, so that
the parent's imports and the ranks' run side by side, and reduces the ranks'
results with :func:`outcome`.

Traffic keys: ``steps_per_call``, ``swap_freq``, ``sampling_freq`` and
``chunk`` (``timesteps_sample``'s arguments), ``warmup_timesteps``,
``checked_chunks`` and ``profile`` (as for ``sse_graph``). The ladder is
``np.linspace(*betas["linspace"])`` with ``replicas_per_beta`` replicas a
rung, in the program's replica order."""

from __future__ import annotations

import contextlib
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch
import torch.distributed as dist

from benchmark import check, draws, forbidden, lattices, metrics, ranks
from benchmark import trace as tr
from benchmark.reference import sse as ref

# Longest a run's ranks may take, set-up, window and reference included.
RANK_TIMEOUT_S = 330.0


def setup_rank(rank: int, world: int, cell, seed: int, dev_type: str) -> dict:
    """A rank's set-up alone, up to where its window would start
    (``benchmark/setup_probe.py``); returns its stages' marks."""
    x = _prepare(rank, world, cell, seed, dev_type)
    dist.barrier(device_ids=[x.dev.index] if x.dev.type == "cuda" else None)
    ranks.mark("barrier")
    return ranks.marks()


def outcome(cell, outs: list, traced: bool, t0_epoch: float) -> dict:
    """The run's outcome from every rank's: the window common to the ranks,
    rank 0's call times and trace, the checks summed over the ranks."""
    r0 = outs[0]
    window = max(o["window"][1] for o in outs) - min(o["window"][0] for o in outs)
    R = r0["replicas"]
    times = r0["times"]
    print(f"{cell.name}: {r0['chunks']} calls of {r0['steps']} timesteps in {window:.3f} s on "
          f"{cell.chips} ranks; rank 0's call ms median {1e3 * metrics.percentile(times, 50):.3f}, "
          f"p95 {1e3 * metrics.percentile(times, 95):.3f} over {len(times)} calls; cutoff "
          f"{r0['cutoff']}, caps {r0['caps']}; swaps accepted in the window {r0['swaps']} of "
          f"{r0['chunks'] * r0['steps'] * (R // 2)} pairs offered", file=sys.stderr)
    print(f"{cell.name}: set-up stages, s from the start: parent "
          f"{ranks.stage_report(t0_epoch, [ranks.marks()])}; ranks "
          f"{ranks.stage_report(t0_epoch, [o['marks'] for o in outs])}", file=sys.stderr)
    checks = {}
    for o in outs:
        for k, v in o["checks"].items():
            checks[k] = checks.get(k, 0) + v
    failed = int(np.any([o["chunk_failed"] for o in outs], axis=0).sum())
    out = {
        "metrics": {"replica_sweeps_per_s": R * r0["steps"] * r0["chunks"] / window,
                    "chunk_ms_p95": 1e3 * metrics.percentile(times, 95),
                    "setup_s": min(o["window"][0] for o in outs) - t0_epoch},
        "checks": checks, "attempted": r0["chunks"], "failed": failed,
        "memory_peak_bytes": max(o["peak"] for o in outs),
        "forbidden": sorted({m for o in outs for m in o["forbidden"]}),
        "trace": r0["trace"],
    }
    if traced:
        out["busy_s"] = sum(o["trace"]["busy_s"] for o in outs) / len(outs)
    return out


def _exchange(dev):
    def gather(a: np.ndarray) -> np.ndarray:
        t = torch.as_tensor(np.ascontiguousarray(a), device=dev)
        parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
        dist.all_gather(parts, t)
        return torch.cat(parts).cpu().numpy()

    return gather


def _prepare(rank: int, world: int, cell, seed: int, dev_type: str) -> SimpleNamespace:
    """A rank's block of the cell's ladder, built from the seed and warmed
    up, on the benchmark's draws."""
    from isingmontecarlo_tpu_torch.parallel import TemperingContainer

    torch.set_num_threads(2)
    dev = torch.device("cuda", rank) if dev_type == "cuda" else torch.device("cpu")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        torch.cuda.init()
    ranks.mark("device")
    cfg, tf = cell.config, cell.traffic
    if tf["update"] != "metropolis" or tf["swap_freq"] != 1:
        raise ValueError(f"{cell.name}: the reference covers Metropolis ladders that swap "
                         "after every timestep")
    edges = lattices.build(cfg["lattice"])
    N = max(max(a, b) for (a, b), _ in edges) + 1
    betas = np.linspace(*cfg["betas"]["linspace"])
    s_spins, s_swap, s_pick, *s_sweep = draws.sub_seeds(seed, 3 + world)
    R = len(betas) * cfg["replicas_per_beta"]
    tc = TemperingContainer(edges, cfg["transverse"], cfg["longitudinal"], betas=betas,
                            replicas_per_beta=cfg["replicas_per_beta"], device=dev)
    g = tc.graph
    g.set_state(draws.uniform(draws.generator(s_spins, dev), (R, N)) < 0.5)
    g.set_cutoff(cfg["cutoff_hint"])
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
    sync()
    ranks.mark("built")
    tc.shard_over()
    gen, swap_gen = draws.generator(s_sweep[rank], dev), draws.generator(s_swap, dev)
    d = draws.SeededDraws(gen, swap_gen)
    # The benchmark's streams in place of the container's own: the rank's
    # sweeps, and the swaps every rank draws alike.
    g.draws = d
    tc._shard = tc._shard._replace(draws=d)
    tc.timesteps_sample(tf["warmup_timesteps"], tf["swap_freq"], tf["warmup_timesteps"],
                        chunk=tf["chunk"])
    sync()
    ranks.mark("warm")
    steps = tf["warmup_timesteps"]
    # Until the cutoff has settled, timesteps_sample runs single timesteps
    # and grows after each; the window's calls run whole chunks.
    while g._growth_pending:
        tc.timesteps_sample(tf["chunk"], tf["swap_freq"], tf["chunk"], chunk=tf["chunk"])
        steps += tf["chunk"]
    sync()
    ranks.mark("settled")
    return SimpleNamespace(
        tc=tc, g=g, gen=gen, swap_gen=swap_gen, dev=dev, N=N, R=R, R_l=R // world,
        lo=rank * (R // world), steps=steps, s_pick=s_pick,
        call=dict(t=tf["steps_per_call"], swap_freq=tf["swap_freq"],
                  sampling_freq=tf["sampling_freq"], chunk=tf["chunk"]),
        model=ref.tfim(edges, cfg["transverse"], cfg["longitudinal"]), sync=sync)


def _start(x: SimpleNamespace) -> dict:
    """The snapshot of a rank's block as a chunk begins; the swap parity is
    the count of timesteps so far (one swap after each), mod 2."""
    return check.snapshot(x.g.sse, caps=x.g._cluster_caps, gen=x.gen.get_state(),
                          swap_gen=x.swap_gen.get_state(), betas=x.tc.betas.clone(),
                          parity=x.steps % 2, swaps=x.tc.total_swaps)


def _call(x: SimpleNamespace, start_swaps: int | None) -> dict | None:
    """One call of the window; the end snapshot of the rank's block where
    ``start_swaps`` (the swap count the chunk began at) is given."""
    with tr.span("timesteps_sample"):
        states, bets = x.tc.timesteps_sample(**x.call)
    x.steps += x.call["t"]
    if start_swaps is None:
        return None
    blk = slice(x.lo, x.lo + x.R_l)
    return check.snapshot(x.g.sse, caps=x.g._cluster_caps, betas=x.tc.betas.clone(),
                          sample_state=states[-1][blk].clone(),
                          sample_betas=bets[-1][blk].clone(),
                          swaps=x.tc.total_swaps - start_swaps)


def _control_rank(rank: int, world: int, cell, seeds: list, dev_type: str) -> list:
    out = []
    for seed in seeds:
        x = _prepare(rank, world, cell, seed, dev_type)
        start = _start(x)
        end = check.to_host(_call(x, start["swaps"]))
        start = check.to_host(start)
        exchange = _exchange(x.dev)
        want = check.ladder_chunk(start, x.model, x.call["t"], x.lo, exchange, x.dev)
        ctrl = check.ladder_chunk(start, x.model, x.call["t"], x.lo, exchange, x.dev,
                                  precision="bfloat16")
        out.append({"program": check.compare(want, end), "control": check.compare(want, ctrl)})
    return out


def control(cell, seeds: list, device) -> list[dict]:
    """The comparison's readings on one call after the warm-up, for each
    seed, summed over the ranks: of the program (``program``), and of the
    reference computed in bfloat16 in the program's place (``control``)."""
    outs = ranks.spawn(_control_rank, cell.chips, "nccl" if device == "cuda" else "gloo", cell,
                       list(seeds), device, timeout=RANK_TIMEOUT_S * len(seeds))
    return [{side: {k: sum(o[i][side][k] for o in outs) for k in outs[0][i][side]}
             for side in ("program", "control")} for i in range(len(seeds))]


def rank(rank: int, world: int, cell, seed: int, seconds: float, traced: bool,
         dev_type: str) -> dict:
    """One rank of a run: set-up, the window, the check of its chunks."""
    x = _prepare(rank, world, cell, seed, dev_type)
    tc, g, dev, tf = x.tc, x.g, x.dev, cell.traffic
    pick = np.random.default_rng(x.s_pick)
    checked = sorted({int(pick.integers(a, b)) for a, b in tf["checked_chunks"]})
    prof = tf["profile"]
    in_slice = range(prof["discard"], prof["first"] + prof["chunks"]) if traced else range(0)
    sliced = tr.Slice(dev) if traced else None
    last_needed = max(checked + ([prof["first"] + prof["chunks"]] if traced else []))
    starts, ends, times = {}, {}, []
    shapes = None
    stop = torch.zeros(1, dtype=torch.int32, device=dev)
    x.sync()
    dist.barrier(device_ids=[dev.index] if dev.type == "cuda" else None)
    ranks.mark("barrier")
    i, t_first, e_first = 0, None, None
    swaps0 = tc.total_swaps
    while True:
        if i in checked:
            starts[i] = _start(x)
        if traced and i == prof["first"]:
            sliced.start()
        discard = sliced.discarded() if traced and i == prof["discard"] else contextlib.nullcontext()
        with discard:
            c0, e0 = time.perf_counter(), time.time()
            end = _call(x, starts[i]["swaps"] if i in checked else None)
            x.sync()
            c1 = time.perf_counter()
        if traced and i == prof["first"] + prof["chunks"] - 1:
            sliced.stop()
            C, E = ref.label_shape(g.cutoff, x.N, g._cluster_caps)
            shapes = {"M": g.cutoff, "R": x.R_l, "label_rows": C, "edge_rows": E}
        if end is not None:
            ends[i] = end
        if t_first is None:
            t_first, e_first = c0, e0
        times.append(c1 - c0)
        i += 1
        if i - 1 not in in_slice:
            stop.fill_(int(c1 - t_first >= seconds and i > last_needed))
            dist.all_reduce(stop, op=dist.ReduceOp.MAX)
            if stop.item():
                break
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    window_swaps = tc.total_swaps - swaps0

    exchange = _exchange(dev)
    totals = {k: 0 for k in ("state", "labels", "sample", "swaps", "growth")}
    chunk_failed = []
    for c in checked:
        want = check.ladder_chunk(check.to_host(starts[c]), x.model, x.call["t"], x.lo, exchange,
                                  dev)
        got = check.compare(want, check.to_host(ends[c]))
        chunk_failed.append(any(got.values()))
        for k, v in got.items():
            totals[k] += v
    return {"window": (e_first, e_first + (c1 - t_first)), "times": times, "chunks": i,
            "steps": x.call["t"], "replicas": x.R, "cutoff": g.cutoff, "caps": g._cluster_caps,
            "swaps": window_swaps, "peak": peak,
            "checks": {f"{k}_mismatch": v for k, v in totals.items()},
            "chunk_failed": chunk_failed, "forbidden": forbidden.loaded(),
            "marks": ranks.marks(),
            "trace": sliced.summary(prof["chunks"] * x.call["t"], shapes,
                                    tr.untraced_step_s(times, prof["discard"], x.call["t"]))
            if traced else None}
