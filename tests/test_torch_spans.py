"""The port's spans and counters (``isingmontecarlo_tpu_torch.profiling``)
at the SSE timestep's stages, the benchmark's readers of them, and the
per-timestep op-count series of ``QmcIsingGraph.timesteps_measure``.

CPU tests on the 4x4 benchmark lattice, with label caps below its label
space so that the cluster labels take the compacted branch and both the
``fits`` and the flag reads occur, and one card test (marker ``cuda``) on the 32x32 lattice of the benchmark's
``two_d_32_k1`` cell. This file imports no JAX; on a host without it run
the card test with ``python -m pytest --noconftest tests/test_torch_spans.py
-m cuda``."""

from __future__ import annotations

import importlib
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from isingmontecarlo_tpu_torch import lattice, profiling
from isingmontecarlo_tpu_torch.sse import ising
from isingmontecarlo_tpu_torch.sse.ising import QmcIsingGraph, multi_sweep

torch.set_num_threads(1)

BETA = 1.0
# (label_cap, edge_cap) under the 4x4 graph's label space S = M + N + 1 =
# 145 and above its segment and edge counts (at most 45 and 65 here).
CAPS = (64, 96)
CHILDREN = {"sse.diagonal": "sse.sweep", "sse.cluster": "sse.sweep",
            "sse.free_spins": "sse.sweep", "sse.segment_graph": "sse.cluster",
            "sse.labels": "sse.cluster", "sse.flips": "sse.cluster",
            "sse.sweep": None, "sse.grow": None}
READERS = ["label_rounds_per_step", "labels_host_ms_per_step", "cluster_host_ms_per_step",
           "diagonal_host_ms_per_step", "grow_host_ms_per_step"]


@pytest.fixture
def recorder():
    profiling.reset_spans()
    profiling.reset_counters()
    yield profiling.RECORDER
    profiling.reset_spans()
    profiling.reset_counters()


def warm_graph(L: int = 4, replicas: int = 4, seed: int = 5, device: str = "cpu",
               beta: float = BETA, warmup: int = 8, cutoff: int | None = None
               ) -> QmcIsingGraph:
    g = QmcIsingGraph(lattice.bench_two_d_periodic(L), 1.0, cutoff=cutoff, replicas=replicas,
                      seed=seed, device=device)
    g.timesteps(warmup, beta, chunk=8)
    return g


def chunk(g: QmcIsingGraph, steps: int, beta: float = BETA, caps=CAPS):
    """The benchmark's chunk: ``multi_sweep`` and ``_maybe_grow``."""
    g.sse, ns, _, _ = multi_sweep(g.sse, beta, g.model, steps, lambda: g.draws,
                                  cluster_caps=caps or g._cluster_caps)
    g._maybe_grow()
    return ns


def inside(t0: int, t1: int, s: profiling.Span) -> bool:
    return s.start_ns <= t0 and t1 <= s.end_ns


def test_no_session_records_no_span_and_counts_reads(recorder):
    g = warm_graph()
    profiling.reset_counters()
    chunk(g, 2)
    assert not torch.autograd.profiler._is_profiler_enabled
    assert profiling.span("sse.sweep") is profiling.span("anything")
    assert recorder.spans == [] and recorder.steps == 0 and not recorder.step_counts
    assert profiling.last_steps(1) is None
    counts = profiling.counters()
    assert counts["host_reads.fits"] == 2 and counts["host_reads.grow"] == 1
    assert counts["host_reads.labels"] >= 2


def test_a_session_records_the_span_tree_by_step(recorder):
    g = warm_graph()
    profiling.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]):
        assert torch.autograd.profiler._is_profiler_enabled
        chunk(g, 3)
    spans = recorder.spans
    assert {s.name for s in spans} == set(CHILDREN)
    for s in spans:
        assert s.parent == CHILDREN[s.name] and s.start_ns <= s.end_ns
    sweeps = [s for s in spans if s.name == "sse.sweep"]
    assert [s.step for s in sweeps] == [1, 2, 3] and recorder.steps == 3
    for s in spans:
        if s.parent is not None:
            # Each child lies inside the sweep of its own step.
            assert inside(s.start_ns, s.end_ns, sweeps[s.step - 1])
    assert sum(s.name == "sse.flips" for s in spans) == 3
    assert [s.step for s in spans if s.name == "sse.grow"] == [3]
    # The counts of the recorded steps are the run's counts.
    assert profiling.last_steps(3).counts == profiling.counters()
    assert profiling.last_steps(4) is None
    last = profiling.last_steps(1)
    assert {s.step for s in last.spans} == {3}
    assert last.counts["host_reads.fits"] == 1 and last.counts["host_reads.grow"] == 1


def test_spans_share_the_profilers_clock(recorder, monkeypatch):
    g = warm_graph()
    diag = ising.diagonal_update

    def marked(*args, **kwargs):
        with record_function("test.diagonal_update"):
            return diag(*args, **kwargs)

    monkeypatch.setattr(ising, "diagonal_update", marked)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        chunk(g, 3)
    events = [(e.name(), e.start_ns(), e.end_ns())
              for e in prof.profiler.kineto_results.events()]
    marks = [(t0, t1) for name, t0, t1 in events if name == "test.diagonal_update"]
    spans = [s for s in recorder.spans if s.name == "sse.diagonal"]
    assert len(marks) == len(spans) == 3
    for (m0, m1), s in zip(sorted(marks), sorted(spans, key=lambda s: s.start_ns)):
        ops = [(t0, t1) for name, t0, t1 in events
               if name.startswith("aten::") and m0 <= t0 and t1 <= m1]
        assert ops
        for t0, t1 in ops:
            assert inside(t0, t1, s)


def test_label_reads_lie_inside_the_labels_spans(recorder):
    g = warm_graph()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        chunk(g, 3)
    labels = [s for s in recorder.spans if s.name == "sse.labels"]
    reads = [(e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
             if e.name() == "aten::_local_scalar_dense"]
    inner = [r for r in reads if any(inside(*r, s) for s in labels)]
    counts = profiling.last_steps(3).counts
    # sse.labels holds the fits read and the flag read of each round.
    assert counts["host_reads.fits"] == 3
    assert len(inner) == counts["host_reads.labels"] + counts["host_reads.fits"]
    # The growth's read is a .tolist(), no aten operation on the CPU.
    assert len(reads) == len(inner) and counts["host_reads.grow"] == 1


def test_readers_read_the_recorder(recorder):
    readers = {n: importlib.import_module(f"benchmark.layer_metrics.{n}").read
               for n in READERS}
    empty = {"timesteps": 4, "events": {}}
    for read in readers.values():
        assert read(empty) is None
    trace = {"timesteps": 4, "events": {"Memcpy DtoH (Device -> Pageable)": [8, 1e-5]}}
    for read in readers.values():
        assert read(trace) is None  # nothing recorded
    ms = 1_000_000
    # A discarded step 1, then the slice's steps 2-5 (the last 4).
    for step in range(1, 6):
        t = 10 * ms * step
        recorder.spans += [profiling.Span("sse.sweep", None, t, t + 5 * ms, step),
                           profiling.Span("sse.diagonal", "sse.sweep", t, t + ms, step),
                           profiling.Span("sse.cluster", "sse.sweep", t + ms, t + 4 * ms, step),
                           profiling.Span("sse.labels", "sse.cluster", t + ms, t + 3 * ms,
                                          step)]
        recorder.step_counts[("host_reads.labels", step)] = 6 if step > 1 else 100
    recorder.steps = 5
    recorder.spans.append(profiling.Span("sse.grow", None, 60 * ms, 62 * ms, 5))
    got = {n: read(trace) for n, read in readers.items()}
    assert got == {"label_rounds_per_step": 6.0, "labels_host_ms_per_step": 2.0,
                   "cluster_host_ms_per_step": 3.0, "diagonal_host_ms_per_step": 1.0,
                   "grow_host_ms_per_step": 0.5}
    assert all(read(empty) is None for read in readers.values())


def test_trace_writes_the_spans_into_the_chrome_trace(recorder, tmp_path):
    import json

    g = warm_graph()
    with profile(activities=[ProfilerActivity.CPU]):
        chunk(g, 2)
    with profiling.trace(str(tmp_path)):
        chunk(g, 1)
    # The recorder holds the trace's block alone.
    assert recorder.steps == 1 and {s.step for s in recorder.spans} == {1}
    doc = json.loads(next(tmp_path.glob("trace.*.json")).read_text())
    spans = {e["name"]: e for e in doc["traceEvents"] if e.get("cat") == "program_span"}
    assert set(spans) == set(CHILDREN)
    # On the trace's time base: the sweep holds the operations it ran.
    sweep = spans["sse.sweep"]
    ops = [e for e in doc["traceEvents"]
           if e.get("cat") == "cpu_op" and e["name"] == "aten::cumsum"]
    assert ops and all(sweep["ts"] <= e["ts"] and e["ts"] + e["dur"] <= sweep["ts"] + sweep["dur"]
                       for e in ops)


def test_collective_traffic_is_the_dist_counters(recorder):
    from isingmontecarlo_tpu_torch.parallel import _dist

    _dist.reset_traffic()
    profiling.count("host_reads.labels", 2)
    _dist._count("swap", torch.zeros(2, dtype=torch.int32), 16)
    _dist._count("swap", torch.zeros(2), 16)
    _dist._count("grow", torch.zeros(1, dtype=torch.int32), 8)
    assert profiling.counters() == {"host_reads.labels": 2, "dist.swap.calls": 2,
                                    "dist.swap.bytes": 32, "dist.grow.calls": 1,
                                    "dist.grow.bytes": 8}
    assert _dist.traffic() == {
        "swap": {"calls": 2, "bytes": 32, "shapes": [((2,), "float32"), ((2,), "int32")]},
        "grow": {"calls": 1, "bytes": 8, "shapes": [((1,), "int32")]}}
    _dist.reset_traffic()
    assert _dist.traffic() == {} and profiling.counters() == {"host_reads.labels": 2}


def test_timesteps_measure_hands_back_the_op_count_series():
    # A cutoff past the op counts: the growth phase ends in the warm-up.
    a, b = (warm_graph(seed=9, cutoff=160) for _ in range(2))
    assert not a._growth_pending
    series = []
    a.timesteps_measure(20, BETA, None, lambda acc, s: acc, chunk=8, op_counts=series)
    assert [s.shape for s in series] == [(8, 4), (8, 4), (4, 4)]
    want = torch.cat([chunk(b, n, caps=None) for n in (8, 8, 4)])
    assert torch.equal(torch.cat(series), want)
    assert torch.equal(a.sse.ops.bond, b.sse.ops.bond)


@pytest.mark.cuda
def test_one_clock_on_the_card(recorder):
    """One 16-timestep chunk of the 32x32 benchmark graph under CUDA
    activity alone, as the benchmark's traced slice: every host read (a
    device-to-host ``cudaMemcpyAsync``) lies inside an ``sse.*`` span,
    those inside ``sse.labels`` are its counted reads, and the sweeps and
    the growth cover the chunk's wall."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    g = QmcIsingGraph(lattice.bench_two_d_periodic(32), 1.0, cutoff=6944, replicas=256,
                      seed=3, device="cuda")
    g.timesteps(64, 1.0, chunk=16)
    chunk(g, 16, caps=None)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]):
        pass  # the process's first session runs slow, as the benchmark's discarded one
    profiling.reset_spans()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.time_ns()
        chunk(g, 16, caps=None)
        torch.cuda.synchronize()
        t1 = time.time_ns()
    events = list(prof.profiler.kineto_results.events())
    dtoh = {e.correlation_id() for e in events
            if e.device_type() == torch.autograd.DeviceType.CUDA and "DtoH" in e.name()}
    reads = [(e.start_ns(), e.end_ns()) for e in events
             if e.device_type() == torch.autograd.DeviceType.CPU
             and e.name() == "cudaMemcpyAsync" and e.correlation_id() in dtoh]
    spans = recorder.spans
    counts = profiling.last_steps(16).counts
    assert len(reads) == len(dtoh) > 16
    assert all(any(inside(*r, s) for s in spans if s.name.startswith("sse.")) for r in reads)
    labels = [s for s in spans if s.name == "sse.labels"]
    assert (sum(any(inside(*r, s) for s in labels) for r in reads)
            == counts["host_reads.labels"] + counts.get("host_reads.fits", 0))
    assert len(reads) == sum(v for k, v in counts.items() if k.startswith("host_reads."))
    covered = sum(s.end_ns - s.start_ns for s in spans if s.name in ("sse.sweep", "sse.grow"))
    assert covered >= 0.9 * (t1 - t0)
