"""CPU tests of the heat-bath cell (``two_d_heatbath_32_r4096_k6``), at a
size a test run holds: a sound run is correct; the control (the heat-bath
reference in bfloat16 in the program's place) fails the comparison; a run
that is Metropolis in heat-bath's place, clusters every timestep in place of
every ``k``-th, or leaves one replica as it was comes out not correct; the
cell loads by name with its per-layer metrics; and the device time by stage
goes to the span that launched it.

    python -m pytest benchmark/ -q
"""

from __future__ import annotations

import time

import pytest
import torch

from benchmark import harness
from benchmark.engines import sse_graph_heatbath as engine
from isingmontecarlo_tpu_torch.sse import ising

CELL = "two_d_heatbath_32_r4096_k6"
DEVICE = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
NEW_METRICS = {"carry_heatbath_roofline", "diagonal_device_ms_per_step",
               "cluster_device_ms_per_step", "heatbath_share"}


def small_cell() -> harness.Cell:
    cell = harness.load_cell(CELL)
    cfg = {**cell.config, "lattice": {"kind": "bench_two_d_periodic", "L": 8}, "replicas": 8,
           "cutoff_hint": 448}
    tf = {**cell.traffic, "warmup_timesteps": 12, "checked_chunks": [[0, 2], [2, 4]],
          "profile": {"discard": 1, "first": 2, "chunks": 2}}
    return cell._replace(config=cfg, traffic=tf)


def faulty_sweep(fault: str):
    """``sse.ising.sweep`` with one fault planted: the Metropolis update in
    heat-bath's place; the cluster update on every timestep; replica 0 left
    as it was."""
    sweep = ising.sweep

    def run(sse, *args, **kwargs):
        if fault == "metropolis":
            kwargs.update(hb=None, heatbath=False)
        elif fault == "cluster_every_step":
            kwargs.update(do_cluster=True)
        new, succ = sweep(sse, *args, **kwargs)
        if fault == "one_replica":
            ops = new.ops._replace(**{f: torch.cat([getattr(sse.ops, f)[..., :1],
                                                    getattr(new.ops, f)[..., 1:]], -1)
                                      for f in ("bond", "inputs", "outputs")})
            new = new._replace(ops=ops, state=torch.cat([sse.state[:1], new.state[1:]]))
        return new, succ

    return run


def line_of(cell, traced=False) -> tuple[dict, dict]:
    out = engine.run(cell, 2**33 + 21, 0.2, traced, "cpu", time.perf_counter())
    return out, harness.result(cell, out, traced, DEVICE)


def test_sound_run_is_correct():
    out, line = line_of(small_cell())
    assert line["correct"] is True and out["attempted"] >= 3
    assert set(line["checks"]) == {"state_mismatch", "ns_mismatch", "growth_mismatch"}
    assert set(line["metrics"]) == {"replica_sweeps_per_s", "setup_s"}


def test_traced_run_on_the_cpu_is_correct_and_reports_what_it_can():
    out, line = line_of(small_cell(), traced=True)
    assert line["correct"] is True
    # No device events on the CPU: the device readers find nothing.
    assert out["trace"]["heatbath_updates"] == 2 * 6
    assert out["trace"]["stage_device_s"] is not None
    assert not NEW_METRICS & set(line["metrics"])


def test_control_fails_the_comparison():
    for got in engine.control(small_cell(), [17, 18], "cpu"):
        assert not any(got["program"].values())
        assert sum(got["control"].values()) > 0


@pytest.mark.parametrize("fault", ["metropolis", "cluster_every_step", "one_replica"])
def test_a_faulty_run_is_not_correct(fault, monkeypatch):
    monkeypatch.setattr(ising, "sweep", faulty_sweep(fault))
    out, line = line_of(small_cell())
    assert line["correct"] is False and out["failed"] > 0


def test_the_engine_refuses_a_metropolis_cell():
    cell = small_cell()
    with pytest.raises(ValueError):
        engine.prepare(cell._replace(config={**cell.config, "diagonal": "metropolis"}), 1, "cpu")
    with pytest.raises(ValueError):
        engine.prepare(cell._replace(traffic={**cell.traffic, "update": "metropolis"}), 1, "cpu")


def test_the_cell_loads_by_name_with_its_metrics():
    cell = harness.load_cell(CELL)
    assert cell.chips == 1 and cell.config["replicas"] == 4096
    assert cell.config["diagonal"] == "heatbath" and cell.traffic["update"] == "heatbath"
    assert (cell.traffic["cluster_every"], cell.traffic["chunk"]) == (6, 6)
    assert harness.engine(cell) is engine
    assert {m["name"] for m in cell.end_to_end} == {"replica_sweeps_per_s", "setup_s"}
    assert {m["name"] for m in cell.per_layer} == NEW_METRICS | {"kernel_launches_per_step",
                                                                 "device_idle_share"}


def empty_trace() -> dict:
    return {"timesteps": 24, "window_s": 1.0, "busy_s": 0.0, "work_s": 0.0, "step_s": 0.1,
            "events": {}, "shapes": {"M": 7000, "R": 256, "label_rows": 50, "edge_rows": 60},
            "device_ops": [], "idle_gaps": []}


def test_new_readers_return_none_on_an_empty_trace():
    for name in NEW_METRICS:
        assert harness.reader(name)(empty_trace()) is None
        # A summary with the program's attribution but no events.
        tr = {**empty_trace(), "stage_device_s": {"sse.diagonal": 1.0, "sse.cluster": 1.0},
              "heatbath_updates": 24}
        assert harness.reader(name)(tr) is None


def test_new_readers_on_a_trace():
    from benchmark import metrics
    from benchmark.layer_metrics._carry_heatbath_bytes import carry_heatbath_bytes

    tr = {**empty_trace(), "heatbath_updates": 24,
          "stage_device_s": {"sse.diagonal": 0.24, "sse.cluster": 0.048, "other": 0.001,
                             "unmatched": 0.0},
          "events": {"void carry_ring::carry_kernel<(anonymous)::HeatBath>(x)": [24, 2.4e-3],
                     "void carry_ring::carry_kernel<(anonymous)::Metropolis>(x)": [2, 1.0]}}
    read = {n: harness.reader(n)(tr) for n in NEW_METRICS}
    assert read["heatbath_share"] == 100.0
    assert read["diagonal_device_ms_per_step"] == pytest.approx(10.0)
    assert read["cluster_device_ms_per_step"] == pytest.approx(2.0)
    assert read["carry_heatbath_roofline"] == pytest.approx(
        metrics.roofline_share(carry_heatbath_bytes(7000, 256), 1e-4))
    assert carry_heatbath_bytes(7000, 256) / 1e6 == pytest.approx(16.13, abs=0.01)


def test_device_time_goes_to_the_span_that_launched_it():
    spans = [(100, 200, "sse.diagonal"), (300, 400, "sse.cluster")]
    runtime = {1: 150, 2: 310, 3: 250, 4: 400, 5: 50}
    device = [(1, 1.0), (2, 2.0), (3, 4.0), (4, 8.0), (5, 16.0), (6, 32.0), (1, 0.5)]
    assert engine.stage_device_s(device, runtime, spans) == {
        "sse.diagonal": 1.5, "sse.cluster": 10.0, "other": 20.0, "unmatched": 32.0}
