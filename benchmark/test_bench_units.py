"""CPU tests of the benchmark's pure parts: its metric arithmetic, finding
a cell, a configuration and a layer metric by name, the result line, and the
rule that nothing under ``benchmark/`` imports JAX or the JAX package.

    python -m pytest benchmark/ -q
"""

from __future__ import annotations

import ast
import json
import re
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import forbidden, harness, metrics

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "benchmark"


def ar1(phi: float, T: int, R: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = np.zeros((T, R))
    eps = rng.standard_normal((T, R))
    for t in range(1, T):
        x[t] = phi * x[t - 1] + eps[t]
    return x


@pytest.mark.parametrize("phi", [0.0, 0.5, 0.8])
def test_ess_of_a_series_with_known_tau(phi):
    # An AR(1) series has tau_int = (1 + phi) / (1 - phi).
    x = ar1(phi, 20000, 8, seed=1)
    tau = (1 + phi) / (1 - phi)
    assert metrics.integrated_autocorrelation_time(x) == pytest.approx(tau, rel=0.08)
    assert metrics.effective_sample_size(x) == pytest.approx(x.size / tau, rel=0.08)


def test_ess_sums_over_replicas():
    x = ar1(0.5, 4000, 1, seed=2)
    assert metrics.effective_sample_size(np.tile(x, (1, 4))) == pytest.approx(
        4 * metrics.effective_sample_size(x[:, 0]))


@pytest.mark.parametrize("q", [50, 95, 99])
def test_percentile_and_count(q):
    v = np.random.default_rng(3).exponential(size=211)
    assert metrics.percentile(list(v), q) == pytest.approx(float(np.percentile(v, q)))
    assert metrics.percentile([4.0], q) == 4.0


def test_interval_union_and_gaps():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6), (6.0, 6.5)]
    assert metrics.merged_length(iv) == pytest.approx(3.5)
    assert metrics.gaps(iv) == [(2.0, 3.0), (4.0, 6.0)]
    assert metrics.merged_length([]) == 0.0


def test_byte_counts_match_the_kernel_table():
    # PERF.md's kernel table: K3 28.67 MB at M=7000, R=256; hook_min 30.72 MB
    # at C=8000, E=7000, R=256.
    assert metrics.carry_decisions_bytes(7000, 256) / 1e6 == pytest.approx(28.67, abs=0.01)
    assert metrics.hook_min_bytes(8000, 7000, 256) / 1e6 == pytest.approx(30.72, abs=0.01)
    # 0.0086 ms bound over K3's 0.0965 ms: about 9%.
    share = metrics.roofline_share(metrics.carry_decisions_bytes(7000, 256), 0.0965e-3)
    assert share == pytest.approx(8.87, abs=0.05)


def test_cells_configs_and_layer_metrics_load_by_name():
    spec = harness.load_spec()
    for w in spec["workloads"]:
        cell = harness.load_cell(w["name"], spec)
        assert cell.chips == w["chips"]
        assert "engine" in cell.traffic
        eng = harness.engine(cell)
        # One card: the engine's run in this process; several: its rank on
        # each card's process, reduced by its outcome.
        assert (callable(eng.rank) and callable(eng.outcome)) if cell.chips > 1 else eng.run
        names = {m["name"] for m in cell.end_to_end}
        assert {"setup_s", "replica_sweeps_per_s"} <= names
        assert cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in names
            assert callable(harness.reader(m["name"]))
    k1 = harness.load_cell("two_d_32_k1", spec)
    assert k1.config["replicas"] == 256
    assert {"energy_ess_per_s", "chunk_ms_p95"} <= {m["name"] for m in k1.end_to_end}
    ladder = harness.load_cell("two_d_32_ladder_4card", spec)
    assert {m["name"] for m in ladder.end_to_end} == {"replica_sweeps_per_s", "setup_s"}
    assert "collective_ms_per_step" in {m["name"] for m in ladder.per_layer}
    with pytest.raises(ValueError):
        harness.load_cell("no_such_cell", spec)


def test_a_cell_added_as_new_files_loads(tmp_path):
    # A later change adds a configuration, a traffic mix and a layer metric
    # as files, and entries in BENCHMARK.json, editing no file there is.
    shutil.copytree(BENCH / "configs", tmp_path / "benchmark" / "configs")
    shutil.copytree(BENCH / "traffic", tmp_path / "benchmark" / "traffic")
    cfg = json.loads((BENCH / "configs" / "two_d_32.json").read_text())
    cfg.update(name="two_d_32_r4096", replicas=4096)
    (tmp_path / "benchmark" / "configs" / "two_d_32_r4096.json").write_text(json.dumps(cfg))
    tf = json.loads((BENCH / "traffic" / "chunks16_closed.json").read_text())
    tf.update(cluster_every=6, chunk=6)
    (tmp_path / "benchmark" / "traffic" / "chunks6_closed.json").write_text(json.dumps(tf))
    spec = harness.load_spec()
    spec["configs"].append({"name": "two_d_32_r4096", "source": "x",
                            "file": "benchmark/configs/two_d_32_r4096.json", "reduced": [],
                            "why": "x"})
    spec["workloads"].append({"name": "two_d_32_r4096_k6", "config": "two_d_32_r4096",
                              "traffic": "chunks6_closed", "chips": 1, "why": "x"})
    cell = harness.load_cell("two_d_32_r4096_k6", spec, root=tmp_path)
    assert cell.config["replicas"] == 4096 and cell.traffic["chunk"] == 6
    # Without a workloads key, a per-layer metric follows the metric it moves.
    every_cell = {"kernel_launches_per_step", "device_idle_share"}
    assert {m["name"] for m in cell.per_layer} == every_cell
    spec["per_layer"].append({"name": "x_per_step", "unit": "1", "better": "lower",
                              "source": "device_trace", "layer": "device",
                              "moves": "replica_sweeps_per_s"})
    cell = harness.load_cell("two_d_32_r4096_k6", spec, root=tmp_path)
    assert {m["name"] for m in cell.per_layer} == every_cell | {"x_per_step"}


def empty_trace() -> dict:
    return {"timesteps": 4, "window_s": 1.0, "busy_s": 0.0, "work_s": 0.0, "step_s": 0.1,
            "events": {},
            "shapes": {"M": 100, "R": 8, "label_rows": 50, "edge_rows": 60},
            "device_ops": [], "idle_gaps": []}


def test_readers_return_nothing_without_events():
    for m in harness.load_spec()["per_layer"]:
        assert harness.reader(m["name"])(empty_trace()) is None


def test_readers_on_a_trace():
    tr = empty_trace()
    # The collective's 4 ms of the 0.25 s busy are no work: 0.05 s a
    # timestep against the untraced timestep's 0.1 s.
    tr.update(busy_s=0.25, work_s=0.2, events={
        "Memcpy DtoH (Device -> Pageable)": [8, 1e-5],
        "Memset (Device)": [4, 1e-6],
        "void (anonymous namespace)::carry_kernel<(anonymous namespace)::Metropolis>(x)": [4, 4e-5],
        "hook_min_kernel(int const*, int*, int const*, int const*, int, int, int, int)": [8, 8e-6],
        "ncclDevKernel_AllGather_RING_LL(ncclDevKernelArgsStorage<4096ul>)": [2, 2e-3],
        "void at::native::elementwise_kernel<x>": [10, 1e-4]})
    read = {m["name"]: harness.reader(m["name"])(tr) for m in harness.load_spec()["per_layer"]}
    assert read["host_reads_per_step"] == 2.0
    assert read["kernel_launches_per_step"] == (4 + 8 + 2 + 10) / 4
    assert read["device_idle_share"] == pytest.approx(50.0)
    assert read["collective_ms_per_step"] == pytest.approx(0.5)
    assert read["carry_decisions_roofline"] == pytest.approx(
        metrics.roofline_share(metrics.carry_decisions_bytes(100, 8), 1e-5))
    assert read["hook_min_roofline"] == pytest.approx(
        metrics.roofline_share(metrics.hook_min_bytes(50, 60, 8), 1e-6))


def test_untraced_step_wall_is_of_the_chunks_before_the_profiler():
    from benchmark import trace

    times = [1.0, 2.0, 9.0, 9.0, 9.0, 3.0]
    assert trace.untraced_step_s(times, 2, 4) == pytest.approx(3.0 / 8)
    assert trace.is_collective("ncclDevKernel_AllGather_RING_LL(x)")
    assert not trace.is_collective("void at::native::elementwise_kernel<x>")


@pytest.mark.parametrize("traced", [False, True])
def test_result_line_keys(traced):
    cell = harness.load_cell("two_d_32_k1")
    tr = empty_trace()
    tr["events"] = {"Memcpy DtoH (Device -> Pageable)": [8, 1e-5]}
    out = {"metrics": {"replica_sweeps_per_s": 1.0, "energy_ess_per_s": 2.0,
                       "chunk_ms_p95": 3.0, "setup_s": 4.0},
           "checks": {"state_mismatch": 0, "ns_mismatch": 0}, "attempted": 5, "failed": 0,
           "memory_peak_bytes": 7, "trace": tr}
    dev = {"platform": "gpu", "kind": "card", "count": 1, "memory_peak_bytes": 7}
    line = harness.result(cell, out, traced, dev)
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line) == keys + (["breakdown"] if traced else []) + ["checks"]
    assert line["correct"] is True
    assert json.loads(json.dumps(line)) == line
    if traced:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert line["metrics"]["host_reads_per_step"] == {"value": 2.0, "unit": "reads/step"}
        assert "carry_decisions_roofline" not in line["metrics"]
    else:
        assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end}
    out["checks"]["ns_mismatch"] = 1
    assert harness.result(cell, out, traced, dev)["correct"] is False


def imported_top_levels(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.partition(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.partition(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            arg = node.args[0]
            if isinstance(arg, ast.Constant):
                names.add(arg.value.partition(".")[0])
    return names


def test_nothing_under_benchmark_imports_jax():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 10
    for f in files:
        assert not imported_top_levels(f) & forbidden.FORBIDDEN, f


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    # The program's name begins with the JAX package's.
    import sys

    for name in ("isingmontecarlo_tpu_torch", "isingmontecarlo_tpu_torch.sse", "jaxtyping"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert "isingmontecarlo_tpu" not in forbidden.loaded()
    assert "jax" not in forbidden.loaded()
    monkeypatch.setitem(sys.modules, "isingmontecarlo_tpu.sse", sys)
    assert "isingmontecarlo_tpu" in forbidden.loaded()


def test_benchmark_json_keeps_the_contract():
    spec = harness.load_spec()
    name = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert spec["paths"] == ["benchmark"]
    assert 1 <= spec["run_seconds"] <= 51
    cells = {w["name"]: w for w in spec["workloads"]}
    assert len(cells) == len(spec["workloads"])
    assert sum(w["chips"] == 4 for w in spec["workloads"]) <= max(1, len(cells) // 4)
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and name.match(c["name"])
        assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).exists()
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == c["reduced"]
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert len(w["why"]) <= 200 and name.match(w["name"])
        assert (BENCH / "traffic" / f"{w['traffic']}.json").exists()
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in spec["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in spec["per_layer"]:
        assert m["moves"] in e2e and len(m["layer"]) <= 200 and name.match(m["name"])
        for w in m.get("workloads", []):
            assert w in e2e[m["moves"]].get("workloads", cells)
        assert (BENCH / "layer_metrics" / f"{m['name'].replace('.', '_')}.py").exists()
    layers = {m["layer"] for m in spec["per_layer"]}
    assert len(layers) == 5
    # A full check of 24 cells fits its time.
    assert (2 + 14 * 24) * (spec["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_harness_and_launcher_load_no_torch():
    # A multi-card run starts its ranks before it imports torch, so that
    # their imports and its own run side by side.
    import subprocess
    import sys

    code = ("import sys; import benchmark.harness, benchmark.ranks; "
            "sys.exit(' '.join(sorted({'torch', 'numpy'} & set(sys.modules))) or None)")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True)
    assert p.returncode == 0, p.stderr


def test_stage_report_takes_the_slowest_end_and_the_mean_cpu():
    from benchmark import ranks

    per_rank = [{"b": (12.0, 3.0), "a": (10.0, 1.0)}, {"a": (11.0, 2.0), "b": (13.0, 2.5)}]
    assert ranks.stage_report(9.0, per_rank) == "a 2.000 (cpu 1.500), b 4.000 (cpu 1.250)"
    assert ranks.stage_report(9.0, [{}]) == "none"


@pytest.mark.cuda
def test_a_short_run_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import subprocess
    import sys

    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "two_d_32_k1",
                        "--seed", "3000000019", "--seconds", "2", "--trace", "0"],
                       cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    assert json.loads(p.stdout.strip().splitlines()[-1])["correct"] is True
