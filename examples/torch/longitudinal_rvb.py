"""2D TFIM with a longitudinal field and RVB updates, with the worldline
oracle checked after every step, on the PyTorch port
(``examples/longitudinal_rvb.py``).

Run: python examples/torch/longitudinal_rvb.py [--device cuda|cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from isingmontecarlo_tpu_torch import QmcIsingGraph, lattice  # noqa: E402

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--device", default="cuda")
args = parser.parse_args()

L = 4
edges = lattice.square(L, L, j=1.0)
g = QmcIsingGraph(edges, transverse=1.0, longitudinal=0.3, replicas=32, seed=11,
                  device=args.device)
g.set_run_rvb(True, updates_per_timestep=8)

for step in range(20):
    g.timestep(beta=1.0)
    if not g.verify():
        raise SystemExit(f"worldline integrity broken at step {step}")

energy = g.timesteps(50, beta=1.0)
print("device:", g.device)
print("<E>:", float(energy.mean()))
print("RVB success rate:", round(g.rvb_success_rate(), 3))
print("verify:", g.verify())
