"""CPU tests of the comparison that decides ``correct``, at a size a test
run holds: a sound run of each cell's engine is correct; its control (the
reference in bfloat16 in the program's place) fails the comparison; and a
run whose timed path is broken underneath comes out not correct, once for
each fault the cell can have. The sharded ladder runs on four ``gloo``
ranks. On the card, ``benchmark/control.py`` runs the control at the
cells' own sizes.

    python -m pytest benchmark/ -q
"""

from __future__ import annotations

import time

import pytest
import torch

from benchmark import harness, ranks
from benchmark.engines import sse_graph, tempering_sharded
from isingmontecarlo_tpu_torch.parallel import _dist, tempering
from isingmontecarlo_tpu_torch.sse import ising

DEVICE = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}


def small_graph_cell() -> harness.Cell:
    cell = harness.load_cell("two_d_32_k1")
    cfg = {**cell.config, "lattice": {"kind": "bench_two_d_periodic", "L": 8}, "replicas": 8,
           "cutoff_hint": 448}
    tf = {**cell.traffic, "chunk": 4, "warmup_timesteps": 8, "checked_chunks": [[0, 2], [2, 4]],
          "profile": {"discard": 1, "first": 2, "chunks": 2}}
    return cell._replace(config=cfg, traffic=tf)


def small_ladder_cell() -> harness.Cell:
    cell = harness.load_cell("two_d_32_ladder_4card")
    cfg = {**cell.config, "lattice": {"kind": "bench_two_d_periodic", "L": 4},
           "betas": {"linspace": [0.5, 1.5, 16]}, "replicas_per_beta": 1, "cutoff_hint": 64}
    tf = {**cell.traffic, "warmup_timesteps": 8, "checked_chunks": [[0, 2], [2, 4]],
          "profile": {"discard": 1, "first": 2, "chunks": 2}}
    return cell._replace(config=cfg, traffic=tf)


def broken_sweep(fault: str):
    """``sse.ising.sweep`` with one fault planted: the state returned
    unchanged; half of the replicas left as they were; one spin of the
    answer flipped where it is produced."""
    sweep = ising.sweep

    def run(sse, *args, **kwargs):
        new, succ = sweep(sse, *args, **kwargs)
        if fault == "unchanged":
            return sse, succ
        if fault == "half":
            h = sse.state.shape[0] // 2
            ops = new.ops._replace(bond=torch.cat([new.ops.bond[:, :h], sse.ops.bond[:, h:]], 1))
            return new._replace(ops=ops, state=torch.cat([new.state[:h], sse.state[h:]])), succ
        state = new.state.clone()
        state[0, 0] ^= True
        return new._replace(state=state), succ

    return run


def test_sound_run_is_correct():
    cell = small_graph_cell()
    out = sse_graph.run(cell, 2**31 + 5, 0.2, False, "cpu", time.perf_counter())
    line = harness.result(cell, out, False, DEVICE)
    assert line["correct"] is True and out["attempted"] >= 4
    assert set(line["checks"]) == {"state_mismatch", "ns_mismatch", "growth_mismatch"}


def test_control_fails_the_comparison():
    for got in sse_graph.control(small_graph_cell(), [17, 18], "cpu"):
        assert not any(got["program"].values())
        assert sum(got["control"].values()) > 0


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_broken_timed_path_is_not_correct(fault, monkeypatch):
    monkeypatch.setattr(ising, "sweep", broken_sweep(fault))
    cell = small_graph_cell()
    out = sse_graph.run(cell, 2**31 + 5, 0.2, False, "cpu", time.perf_counter())
    line = harness.result(cell, out, False, DEVICE)
    assert line["correct"] is False and out["failed"] > 0


def _local_swap_gather(x, group=None, dim=0, tag="swap"):
    """The swap's gathers left out: a rank's own block stands for every
    rank's."""
    if tag != "swap":
        return gather(x, group, dim, tag)
    return torch.cat([x] * torch.distributed.get_world_size(group), dim)


gather = _dist.all_gather


def faulty_rank(rank, world, fault, *args):
    if fault == "exchange":
        _dist.all_gather = _local_swap_gather
    elif fault is not None:
        tempering.sweep = broken_sweep(fault)
    return tempering_sharded.rank(rank, world, *args)


def ladder_line(fault):
    cell = small_ladder_cell()
    t0 = time.time()
    outs = ranks.spawn(faulty_rank, 4, "gloo", fault, cell, 2**33 + 9, 0.2, False, "cpu",
                       timeout=300)
    out = tempering_sharded.outcome(cell, outs, False, t0)
    return harness.result(cell, out, False, {**DEVICE, "count": 4})


def test_sound_ladder_run_is_correct():
    line = ladder_line(None)
    assert line["correct"] is True
    assert set(line["checks"]) == {"state_mismatch", "labels_mismatch", "sample_mismatch",
                                   "swaps_mismatch", "growth_mismatch"}


def test_ladder_set_up_alone_runs_on_ranks_named_by_string():
    marks = ranks.spawn("benchmark.engines.tempering_sharded:setup_rank", 4, "gloo",
                        small_ladder_cell(), 2**33 + 11, "cpu", timeout=300)
    assert len(marks) == 4
    for m in marks:
        assert {"rank_started", "group", "device", "built", "warm", "settled", "barrier"} <= set(m)
        assert m["rank_started"][0] <= m["group"][0] <= m["barrier"][0]


def test_ladder_control_fails_the_comparison():
    for got in tempering_sharded.control(small_ladder_cell(), [17, 18], "cpu"):
        assert not any(got["program"].values())
        assert sum(got["control"].values()) > 0


@pytest.mark.parametrize("fault", ["unchanged", "half", "exchange", "altered"])
def test_broken_ladder_is_not_correct(fault):
    assert ladder_line(fault)["correct"] is False
