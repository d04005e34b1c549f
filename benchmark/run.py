"""The benchmark of ``isingmontecarlo_tpu_torch``, one cell a run:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout on a host with the cell's CUDA cards. Prints the
result as the last line of standard output (see ``benchmark/README.md``)."""

import time

T0 = time.perf_counter()
T0_EPOCH = time.time()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args()
    from benchmark import harness

    return harness.main(a.workload, a.seed, a.seconds, bool(a.trace), T0, T0_EPOCH)


if __name__ == "__main__":
    sys.exit(main())
