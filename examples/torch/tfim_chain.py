"""1D TFIM chain, L=64, by SSE on the PyTorch port, checked against its exact
energy (``examples/tfim_chain.py``).

SSE (diagonal and cluster updates, the reference's TFIM timestep,
``qmc_ising.rs:644-795``) on the periodic L=64 transverse-field Ising chain
at the critical ratio G/|J| = 1. Under Jordan-Wigner the chain is free
fermions: E/L = -(1/L) sum_k eps_k/2 tanh(beta eps_k/2), eps_k =
2 sqrt(J^2 + G^2 - 2 J G cos k) over antiperiodic momenta (the even-parity
sector; the rest is exponentially small at L=64). Also <M^2> from the
sampled states.

Run: python examples/torch/tfim_chain.py [--device cuda|cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import numpy as np  # noqa: E402

from isingmontecarlo_tpu_torch import QmcIsingGraph, lattice  # noqa: E402

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--device", default="cuda")
args = parser.parse_args()

L, R = 64, 256
beta, gamma = 2.0, 1.0

ks = (2 * np.arange(L) + 1) * np.pi / L
eps = 2.0 * np.sqrt(1.0 + gamma**2 - 2.0 * gamma * np.cos(ks))
exact = float(-(eps / 2.0 * np.tanh(beta * eps / 2.0)).sum() / L)

edges = lattice.chain(L, j=-1.0, periodic=True)
g = QmcIsingGraph(edges, transverse=gamma, replicas=R, seed=0, device=args.device)
g.timesteps(100, beta, chunk=25)  # warm-up and cutoff growth
states, energy = g.timesteps_sample(400, beta, sampling_freq=4, chunk=50)

e_site = float(energy.mean()) / L
s = 2.0 * states.double() - 1.0
msq = float((s.sum(dim=-1) ** 2).mean()) / L**2

print(f"device: {g.device}  L={L} beta={beta} Gamma={gamma}")
print(f"QMC    E/site = {e_site:+.4f}")
print(f"exact  E/site = {exact:+.4f}  (Jordan-Wigner free fermions)")
print(f"<M^2>/L^2     = {msq:.4f}")
print("verify:", g.verify())
if abs(e_site - exact) >= 0.02:
    raise SystemExit(f"E/site {e_site} is not within 0.02 of {exact}")
