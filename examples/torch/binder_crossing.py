"""Binder-cumulant crossing at the 2D Ising critical point on the PyTorch
port (``examples/binder_crossing.py``).

For each lattice size, sweep temperatures around T_c = 2/ln(1+sqrt(2)) ~
2.269 on ``LatticeIsing`` (kernel K1 on the card) and print U4 = 1 -
<m^4>/(3<m^2>^2) averaged over replicas. Curves for different L cross near
T_c.

Run: python examples/torch/binder_crossing.py [sweeps] [replicas] [--device cuda|cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from isingmontecarlo_tpu_torch import LatticeIsing  # noqa: E402
from isingmontecarlo_tpu_torch.analysis import binder_cumulant  # noqa: E402

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("sweeps", nargs="?", type=int, default=400)
parser.add_argument("replicas", nargs="?", type=int, default=64)
parser.add_argument("--device", default="cuda")
args = parser.parse_args()

TC = 2.0 / np.log(1.0 + np.sqrt(2.0))
TEMPS = [2.0, 2.15, TC, 2.4, 2.6]
SIZES = [8, 16]

print(f"device: {torch.device(args.device)}  (T_c = {TC:.4f})", file=sys.stderr)
print(f"{'T':>6} " + " ".join(f"U4(L={L})" for L in SIZES))
for T in TEMPS:
    row = []
    for L in SIZES:
        g = LatticeIsing(L, j=-1.0, replicas=args.replicas, seed=L * 1000 + int(T * 100),
                         device=args.device)
        g.run_sweeps(args.sweeps, beta=1.0 / T)  # equilibrate
        samples = []
        for _ in range(args.sweeps // 4):
            g.run_sweeps(1, beta=1.0 / T)
            samples.append(g.state_ref().reshape(args.replicas, L * L))
        row.append(float(binder_cumulant(torch.stack(samples)).mean()))
    print(f"{T:6.3f} " + " ".join(f"{u: 8.4f}" for u in row))
print("expect: U4 -> 2/3 below T_c, -> 0 above; curves cross near T_c")
