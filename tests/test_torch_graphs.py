"""CUDA graphs of the SSE timestep's stages (``isingmontecarlo_tpu_torch/
sse/graphs.py``): ``sweep`` held bitwise equal to the eager stage
functions composed in its order on the same draws, through growth of the
cutoff and of the label caps, a cap overflow, ``cluster_every=2``,
heat-bath with bond scales and per-replica betas, and sign patterns; a
returned state that later timesteps leave as it was; and the rules of the
graph cache (keys, capture on the second consecutive use, eviction of
outgrown keys, the counters).

CPU tests on the 4x4 benchmark lattice run the cache's logic with
``graphs.capture`` replaced by :class:`ReplayedCall`, which stands in for a
CUDA graph: the capture runs the stage once, and each replay runs it again
on the same static inputs and writes the results into the capture's
outputs. One card test (marker ``cuda``) runs the same chains through real
graphs on the 32x32 lattice of the benchmark's ``two_d_32_k1`` cell at
R=64. This file imports no JAX; on a host without it run the card test with
``python -m pytest --noconftest tests/test_torch_graphs.py -m cuda``."""

from __future__ import annotations

import warnings

import pytest
import torch

from isingmontecarlo_tpu_torch import lattice, ops as kernels, profiling
from isingmontecarlo_tpu_torch.sse import cluster, graphs, ising
from isingmontecarlo_tpu_torch.sse import opstring as sops
from isingmontecarlo_tpu_torch.sse.diagonal import diagonal_update, make_heatbath_tables
from isingmontecarlo_tpu_torch.sse.ising import (
    GeneratorDraws, QmcIsingGraph, SseState, resample_free_spins,
)

torch.set_num_threads(1)

BETA = 1.0
# Under the 4x4 graph's label space S = M + N + 1 (M = 128 after the
# warm-up) and above its segment and edge counts, so that the labels take
# the compacted branch; then grown caps; then caps that every replica
# overflows.
CAPS = (64, 96)
CAPS_GROWN = (80, 112)
CAPS_OVERFLOW = (16, 16)
STAGES = ("diagonal", "segment_graph", "compact", "flips", "free_spins")


class ReplayedCall:
    """A CUDA graph's stand-in on the CPU: the capture runs ``fn`` once on
    the static inputs; a replay runs it again and writes what it returns
    into the capture's outputs, as a graph's replay writes its static
    outputs."""

    def __init__(self, fn, args):
        self.fn, self.args = fn, args
        self.outputs = fn(*args)

    def pool(self):
        return None

    def replay(self):
        for out, new in zip(graphs._leaves(self.outputs), graphs._leaves(self.fn(*self.args))):
            if out is not new:
                out.copy_(new)


def replayed_capture(fn, args, device, pool=None):
    call = ReplayedCall(fn, args)
    return call, call.outputs


@pytest.fixture
def counters():
    profiling.reset_counters()
    yield
    profiling.reset_counters()


@pytest.fixture
def stand_in(monkeypatch, counters):
    """Graphs on the CPU: every device takes the cache, whose captures are
    :class:`ReplayedCall`s."""
    monkeypatch.setattr(graphs, "capturable", lambda device: True)
    monkeypatch.setattr(graphs, "capture", replayed_capture)


def graph_counts() -> dict:
    return {k.removeprefix("sse.graph."): v for k, v in profiling.counters().items()
            if k.startswith("sse.graph.")}


def eager_sweep(sse, beta, model, draws, cluster_caps=None, do_cluster=True, hb=None,
                heatbath=False, bond_scale=None, bond_xor=None):
    """The timestep's stage functions composed eagerly in ``sweep``'s order."""
    ops, state = sse
    M, R = ops.bond.shape
    ops = diagonal_update(ops, state, beta, draws.diagonal((3, M, R)), model, hb=hb,
                          heatbath=heatbath, bond_scale=bond_scale, bond_xor=bond_xor)
    if not do_cluster:
        return SseState(ops, state)
    lc, ec = cluster_caps if cluster_caps is not None else (M + model.nvars + 1, None)
    sg = cluster.segment_graph(ops, model)
    has_op = (sg.head_f < ops.max_legs * M).T
    ops, state = cluster.cluster_update_impl(ops, state, draws.cluster, model, 0.5, lc, ec,
                                             sg, bond_xor)
    return resample_free_spins(SseState(ops, state), draws.free_spins((R, model.nvars)),
                               model, has_op=has_op)


def assert_same(a: SseState, b: SseState):
    for x, y in zip((*a.ops, a.state), (*b.ops, b.state)):
        assert torch.equal(x, y)


def snapshot(sse: SseState) -> SseState:
    return SseState(sops.OpString(*(t.clone() for t in sse.ops)), sse.state.clone())


def warm(L: int, R: int, device, seed: int = 5, warmup: int = 8) -> QmcIsingGraph:
    g = QmcIsingGraph(lattice.bench_two_d_periodic(L), 1.0, replicas=R, seed=seed,
                      device=device)
    g.timesteps(warmup, BETA, chunk=8)
    graphs._CACHES.pop(g.model, None)
    profiling.reset_counters()
    return g


def run_chain(g: QmcIsingGraph, plan: list[dict], seed: int, **kw) -> list[dict]:
    """``sweep`` and :func:`eager_sweep` side by side from ``g``'s state, on
    two generators of ``seed``, one timestep an item of ``plan`` (``caps``,
    ``do_cluster``, and ``grow``: a cutoff to grow both strings to first),
    equal after every timestep (op string, state, op counts), from an empty
    graph cache. A state returned by a replay is held to the end and must
    not change. Returns each timestep's ``sse.graph.*`` counts."""
    graphs._CACHES.pop(g.model, None)
    dev = g.device
    dg = GeneratorDraws(torch.Generator(device=dev).manual_seed(seed))
    de = GeneratorDraws(torch.Generator(device=dev).manual_seed(seed))
    beta = kw.pop("beta", BETA)
    a = b = g.sse
    held = None
    per_step = []
    for step in plan:
        if step.get("grow"):
            a = SseState(sops.grow(a.ops, step["grow"]), a.state)
            b = SseState(sops.grow(b.ops, step["grow"]), b.state)
        before = graph_counts()
        a, _ = ising.sweep(a, beta, g.model, dg, cluster_caps=step["caps"],
                           do_cluster=step.get("do_cluster", True), **kw)
        b = eager_sweep(b, beta, g.model, de, step["caps"], step.get("do_cluster", True), **kw)
        after = graph_counts()
        per_step.append({k: v - before.get(k, 0) for k, v in after.items()
                         if v != before.get(k, 0)})
        assert_same(a, b)
        assert torch.equal(sops.op_count(a.ops), sops.op_count(b.ops))
        if held is None and per_step[-1].get("replays"):
            held, kept = a, snapshot(a)
    assert held is not None and held is not a
    assert_same(held, kept)
    return per_step


def steady(n: int, stages: int, cached: int = 0) -> list[dict]:
    """A key's counts over ``n`` timesteps: eager, captured, then replayed;
    ``cached`` more stages replay from the start."""
    def runs(kind):
        return {kind: stages, "replays": cached} if cached else {kind: stages}
    return [runs("eager"), runs("captures")] + [{"replays": stages + cached}] * (n - 2)


def main_plan(M: int, caps, caps_grown, caps_overflow, grow_by: int) -> tuple[list, list]:
    """The main chain's timesteps and the counts they should give: a steady
    key, a cutoff growth, a caps growth (the diagonal and free-spins graphs,
    which do not depend on the caps, replay), three overflows (the no-op
    flips: no ``compact`` stage), back to the grown caps (still cached),
    then ``cluster_every=2``."""
    plan = ([{"caps": caps}] * 3 + [{"caps": caps, "grow": M + grow_by}] + [{"caps": caps}] * 2
            + [{"caps": caps_grown}] * 3 + [{"caps": caps_overflow}] * 3
            + [{"caps": caps_grown}] * 2
            + [{"caps": caps_grown, "do_cluster": i % 2 == 1} for i in range(4)])
    want = (steady(3, 5) + steady(3, 5) + steady(3, 3, cached=2) + steady(3, 2, cached=2)
            + [{"replays": 5}] * 2 + [{"replays": 1}, {"replays": 5}] * 2)
    return plan, want


def hb_args(g: QmcIsingGraph, seed: int) -> dict:
    gen = torch.Generator(device=g.device).manual_seed(seed)
    R, NB = g.replicas, g.model.nbonds
    scale = 0.5 + torch.rand((R, NB), generator=gen, device=g.device)
    return dict(beta=torch.linspace(0.8, 1.4, R, device=g.device), bond_scale=scale,
                hb=make_heatbath_tables(g.model, scale), heatbath=True)


def xor_args(g: QmcIsingGraph) -> dict:
    x = torch.zeros((g.replicas, g.model.nbonds), dtype=torch.int32, device=g.device)
    x[1::2, : g.model.nbonds // 4] = 1
    return dict(bond_xor=x)


# -- CPU: the cache's rules -----------------------------------------------------------


def test_cpu_tensors_never_capture(counters):
    g = warm(4, 4, "cpu")
    g.sse, _, _, _ = ising.multi_sweep(g.sse, BETA, g.model, 4, lambda: g.draws,
                                       cluster_caps=CAPS)
    g.sse, _, _, _ = ising.multi_sweep(g.sse, BETA, g.model, 2, lambda: g.draws,
                                       cluster_caps=CAPS, cluster_every=2)
    assert graph_counts() == {"eager": 4 * 5 + 5 + 1}
    assert g.model not in graphs._CACHES


def stage_keys(g: QmcIsingGraph, sse=None, beta=BETA, **kw) -> dict:
    """Each stage's key in one sweep of ``g`` from a fresh cache."""
    graphs._CACHES.pop(g.model, None)
    ising.sweep(sse or g.sse, beta, g.model, GeneratorDraws(torch.Generator().manual_seed(1)),
                **kw)
    return dict(graphs.cache_of(g.model).last)


def test_the_key_changes_exactly_with_the_sweeps_shape_and_options(stand_in):
    g = warm(4, 4, "cpu")
    M = g.cutoff
    base = stage_keys(g, cluster_caps=CAPS)
    assert set(base) == set(STAGES)

    def changed(**kw) -> set:
        keys = stage_keys(g, **{"cluster_caps": CAPS, **kw})
        return {s for s in set(base) | set(keys) if base.get(s) != keys.get(s)}

    ops, state = g.sse
    fewer = SseState(sops.OpString(*(t[..., :3].contiguous() for t in ops)), state[:3])
    hb = make_heatbath_tables(g.model)
    scale = torch.ones((4, g.model.nbonds))
    everything = set(STAGES)
    caps_free = {"diagonal", "free_spins"}
    # Shapes: every stage; the caps: the stages that depend on them.
    assert changed(sse=SseState(sops.grow(ops, M + 16), state)) == everything
    assert changed(sse=fewer) == everything
    assert changed(cluster_caps=CAPS_GROWN) == everything - caps_free
    # do_cluster: the cluster stages do not run; the diagonal's key stays.
    assert changed(do_cluster=False) == everything - {"diagonal"}
    assert stage_keys(g, cluster_caps=CAPS, do_cluster=False) == {"diagonal": base["diagonal"]}
    # The diagonal update's options: that stage alone; sign patterns also
    # the flips.
    assert changed(hb=hb) == {"diagonal"}
    assert changed(hb=hb, heatbath=True) == {"diagonal"}
    assert changed(bond_scale=scale) == {"diagonal"}
    assert changed(beta=torch.full((4,), BETA)) == {"diagonal"}
    assert changed(bond_xor=torch.zeros((4, g.model.nbonds), dtype=torch.int32)) == {
        "diagonal", "flips"}
    # Values alone change nothing.
    assert changed(beta=torch.tensor(BETA)) == set()
    assert changed(beta=BETA + 1e-3) == set()
    assert changed(sse=SseState(ops, ~state)) == set()
    assert changed(cluster_caps=CAPS_OVERFLOW) == everything - caps_free | {"flips_noop"}


def test_a_key_is_captured_on_its_second_use_and_evicted_when_outgrown(stand_in):
    g = warm(4, 4, "cpu")
    cache = graphs.cache_of(g.model)

    def step(caps=CAPS):
        before = graph_counts()
        g.sse, _ = ising.sweep(g.sse, BETA, g.model, g.draws, cluster_caps=caps)
        return {k: v - before.get(k, 0) for k, v in graph_counts().items()
                if v != before.get(k, 0)}

    def sizes():
        return {k[1] for k in cache.entries}

    assert [step() for _ in range(3)] == steady(3, 5)
    M = g.cutoff
    assert sizes() == {(M, None, None), (M, *CAPS)}
    g.set_cutoff(M + 16)
    assert step() == {"eager": 5} and sizes() == {(M, None, None), (M, *CAPS)}
    # Each capture drops the graphs of its stage that it outgrows.
    assert step() == {"captures": 5} and sizes() == {(M + 16, None, None), (M + 16, *CAPS)}
    assert step() == {"replays": 5}
    assert step(CAPS_GROWN) == {"eager": 3, "replays": 2}
    assert step(CAPS_GROWN) == {"captures": 3, "replays": 2}
    assert sizes() == {(M + 16, None, None), (M + 16, *CAPS_GROWN)}
    assert step(CAPS_GROWN) == {"replays": 5}
    # cluster_every=2: the diagonal graph replays on every timestep, the
    # cluster stages' on every other.
    before = graph_counts()
    g.sse, _, _, _ = ising.multi_sweep(g.sse, BETA, g.model, 4, lambda: g.draws,
                                       cluster_caps=CAPS_GROWN, cluster_every=2)
    after = graph_counts()
    assert {k: after[k] - before[k] for k in after} == {"eager": 0, "captures": 0,
                                                        "replays": 2 * 1 + 2 * 5}
    assert len(cache.entries) == 5


def test_a_capture_that_raises_runs_its_key_eagerly(stand_in, monkeypatch):
    def refuse(fn, args, device, pool=None):
        raise RuntimeError("operation not permitted when stream is capturing")

    g = warm(4, 4, "cpu")
    monkeypatch.setattr(graphs, "capture", refuse)
    b = snapshot(g.sse)
    plan = [{"caps": CAPS}] * 3
    warned = []
    dg = GeneratorDraws(torch.Generator().manual_seed(3))
    de = GeneratorDraws(torch.Generator().manual_seed(3))
    for step in plan:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            g.sse, _ = ising.sweep(g.sse, BETA, g.model, dg, cluster_caps=step["caps"])
        b = eager_sweep(b, BETA, g.model, de, step["caps"])
        assert_same(g.sse, b)
        warned += [str(w.message) for w in caught]
    assert graph_counts() == {"eager": 15, "failed": 5}
    assert len(warned) == 5 and all("runs eagerly" in w for w in warned)
    assert set(graphs.cache_of(g.model).entries.values()) == {None}


# -- CPU: the stand-in graphs against the eager stages --------------------------------


def test_stand_in_graphs_equal_the_eager_stages(stand_in):
    g = warm(4, 4, "cpu")
    assert g.cutoff == 128
    plan, want = main_plan(g.cutoff, CAPS, CAPS_GROWN, CAPS_OVERFLOW, 16)
    assert run_chain(g, plan, seed=11) == want


@pytest.mark.parametrize("options", ["heatbath", "bond_xor"])
def test_stand_in_graphs_equal_the_eager_stages_with_options(stand_in, options):
    g = warm(4, 4, "cpu")
    kw = hb_args(g, 2) if options == "heatbath" else xor_args(g)
    assert run_chain(g, [{"caps": CAPS}] * 4, seed=12, **kw) == steady(4, 5)


def test_replays_count_the_captured_kernels(stand_in, monkeypatch):
    """A replay adds its kernels' launches to the wrappers' counts, as if
    each kernel had been launched. The stand-in runs the plain versions,
    which count nothing, so its capture of the diagonal stage counts one
    K3 launch by hand."""

    def counting(fn, args, device, pool=None):
        kernels.carry_decisions.launches += fn is diagonal_update
        return replayed_capture(fn, args, device)

    monkeypatch.setattr(graphs, "capture", counting)
    g = warm(4, 4, "cpu")
    kernels.reset_launch_counts()
    for _ in range(4):
        g.sse, _ = ising.sweep(g.sse, BETA, g.model, g.draws, cluster_caps=CAPS)
    # None eagerly, one in the capture, then one a replay.
    assert kernels.carry_decisions.launches == 3


# -- the card ------------------------------------------------------------------------


@pytest.mark.cuda
def test_graphs_equal_the_eager_stages_on_the_card(counters):
    """The 32x32 benchmark lattice at R=64, warmed to its steady cutoff:
    the main chain (growth of the cutoff and of the caps, overflow,
    ``cluster_every=2``), then heat-bath with bond scales and per-replica
    betas, then sign patterns, each through real CUDA graphs and equal to
    the eager stages after every timestep; each key captured once and
    replayed after."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    g = warm(32, 64, "cuda", seed=3, warmup=48)
    lc, ec = g._cluster_caps
    plan, want = main_plan(g.cutoff, (lc, ec), (lc + 16, ec + 16), (256, 256), 64)
    assert run_chain(g, plan, seed=21) == want
    kernels.reset_launch_counts()
    assert run_chain(g, [{"caps": (lc, ec)}] * 8, seed=22, **hb_args(g, 4)) == steady(8, 5)
    counts = kernels.launch_counts()
    # Eight in the eager stages, eight through the graphs (one eager, one
    # in the capture, six replays).
    assert counts["carry_decisions_heatbath"] == 16 and counts["carry_decisions"] == 0
    assert run_chain(g, [{"caps": (lc, ec)}] * 8, seed=23, **xor_args(g)) == steady(8, 5)
