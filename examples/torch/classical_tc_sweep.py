"""Classical 2D Ising across the phase transition on the PyTorch port
(``examples/classical_tc_sweep.py``).

256x256 checkerboard Metropolis (kernel K1 on the card) through
temperatures around the Onsager point T_c = 2/ln(1+sqrt(2)) ~ 2.269,
printing energy and |magnetization| per site; then Swendsen-Wang cluster
sweeps at T_c on a 64x64 graph, where cluster moves decorrelate in a few
sweeps (``classical/cluster.py``).

Run: python examples/torch/classical_tc_sweep.py [--device cuda|cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from isingmontecarlo_tpu_torch import LatticeIsing, lattice  # noqa: E402
from isingmontecarlo_tpu_torch.classical.cluster import swendsen_wang_run  # noqa: E402
from isingmontecarlo_tpu_torch.classical.metropolis import (  # noqa: E402
    GeneratorDraws, build_tables,
)

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--device", default="cuda")
args = parser.parse_args()
dev = torch.device(args.device)

L, R = 256, 16
TC = 2.0 / np.log(1.0 + np.sqrt(2.0))

print(f"device: {dev}")
print(f"{L}x{L} checkerboard Metropolis, R={R} replicas (T_c ~ {TC:.4f}):")
for t in (1.8, 2.1, TC, 2.5, 3.0):
    # Ordered start: |M| then follows the spontaneous-magnetization branch.
    g = LatticeIsing(L, j=-1.0, replicas=R, seed=int(t * 100), state=np.ones((L, L), bool),
                     device=dev)
    g.run_sweeps(400, beta=1.0 / t)
    e = float(g.get_energy().mean()) / (L * L)
    m = float(g.get_magnetization().abs().mean()) / (L * L)
    print(f"  T={t:5.3f}  E/site={e:+.4f}  |M|/site={m:.4f}")

Lc, Rc = 64, 16
print(f"\n{Lc}x{Lc} Swendsen-Wang at T_c, R={Rc} replicas:")
edges = lattice.square(Lc, Lc, j=-1.0)
tables = build_tables(edges, [0.0] * (Lc * Lc), device=dev)
draws = GeneratorDraws(torch.Generator(device=dev).manual_seed(7))
spins = draws.coin((Rc, Lc * Lc))
spins, es = swendsen_wang_run(spins, draws, 1.0 / TC, tables, 60, measure=True)
e = float(es[-20:].mean()) / (Lc * Lc)
print(f"  E/site={e:+.4f} after 60 cluster sweeps (Onsager E_c/site = -sqrt(2) ~ -1.4142)")
