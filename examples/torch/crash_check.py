"""24x24 periodic TFIM soak on the PyTorch port (``examples/crash_check.py``;
the reference's ``examples/crash_check.rs``).

Run: python examples/torch/crash_check.py [steps] [--device cuda|cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from isingmontecarlo_tpu_torch import QmcIsingGraph, lattice  # noqa: E402

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("steps", nargs="?", type=int, default=1000)
parser.add_argument("--device", default="cuda")
args = parser.parse_args()

side_len = 24
edges = lattice.square(side_len, side_len, j=1.0)
g = QmcIsingGraph(edges, transverse=1.0, cutoff=side_len * side_len, replicas=8, seed=0,
                  device=args.device)
states, energy = g.timesteps_sample(args.steps, beta=1.0)
print("device:", g.device)
print("sampled states:", tuple(states.shape))
print("<E> ensemble:", float(energy.mean()))
print("verify:", g.verify())
