"""The set-up of a cell of several cards alone, with no window and no check:

    python3 benchmark/setup_probe.py --workload <cell> --seed <n>

Takes ``run.py``'s path up to where the window would start (the ranks
started first, the parent's imports beside theirs), prints each set-up
stage's end (seconds from the process's start) and CPU seconds on standard
error, and ``setup_s`` as the last line of standard output: a measure of how
steady set-up is, at a fraction of a run's cost. (A one-card cell's set-up is
one process: ``run.py`` prints it.)"""

import time

T0_EPOCH = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    a = p.parse_args()
    from benchmark import harness, ranks

    cell = harness.load_cell(a.workload)
    if cell.chips < 2:
        print(f"{a.workload} runs on one card: run.py prints its set-up", file=sys.stderr)
        return 2
    load = os.getloadavg()
    job = ranks.start(f"benchmark.engines.{cell.traffic['engine']}:setup_rank", cell.chips,
                      "nccl", cell, a.seed, "cuda")
    try:
        import torch

        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            print(f"{a.workload} needs {cell.chips} CUDA card(s)", file=sys.stderr)
            return 3
        torch.set_num_threads(2)
        ranks.mark("parent_ready")
        per_rank = ranks.join(job, harness.engine(cell).RANK_TIMEOUT_S)
    finally:
        ranks.stop(job)
    print(f"{cell.name}: set-up stages, s from the start: parent "
          f"{ranks.stage_report(T0_EPOCH, [ranks.marks()])}; ranks "
          f"{ranks.stage_report(T0_EPOCH, per_rank)}", file=sys.stderr)
    print(json.dumps({"setup_s": min(m["barrier"][0] for m in per_rank) - T0_EPOCH,
                      "loadavg_before": load, "loadavg_after": os.getloadavg()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
