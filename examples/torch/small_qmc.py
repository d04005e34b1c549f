"""4-spin ring TFIM quickstart on the PyTorch port (``examples/small_qmc.py``;
the reference's ``examples/small_qmc.rs``).

Run: python examples/torch/small_qmc.py [--device cuda|cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from isingmontecarlo_tpu_torch import QmcIsingGraph  # noqa: E402

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--device", default="cuda")
args = parser.parse_args()

edges = [((0, 1), -1.0), ((1, 2), 1.0), ((2, 3), 1.0), ((3, 0), 1.0)]
transverse = 1.0

g = QmcIsingGraph.new_with_rng(edges, transverse, 0.0, cutoff=3, replicas=64, seed=0,
                               device=args.device)
energy = g.timesteps(1000, beta=1.0)
print("device:", g.device)
print("<E> per replica (first 8):", energy[:8].cpu().numpy())
print("<E> ensemble:", float(energy.mean()))
print("verify:", g.verify())
