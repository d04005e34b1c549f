"""The control of a cell's comparison, at the cell's own size:

    python3 benchmark/control.py --workload <cell> --seeds <n> [<n> ...]

For each seed the cell is built and warmed up as a run does, one chunk of
the window runs, and the reference replays it twice from the program's
state at its start: in float32, as the configuration states, and in
bfloat16 (every operand and product of the diagonal update's acceptance
tests rounded to it). Prints one JSON line a seed with the comparison's
readings of the program (``program``) and of the bfloat16 reference put in
the program's place (``control``). A sound comparison reads 0 on the
program and more on the control. Needs the cell's CUDA cards; the CPU
tests run the same at a small size."""

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    a = p.parse_args()
    import torch

    from benchmark import harness

    cell = harness.load_cell(a.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{a.workload} needs {cell.chips} CUDA card(s)", file=sys.stderr)
        return 3
    for seed, got in zip(a.seeds, harness.engine(cell).control(cell, a.seeds, "cuda")):
        print(json.dumps({"workload": a.workload, "seed": seed, **got}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
