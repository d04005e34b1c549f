"""Classical Ising Monte Carlo (port of ``isingmontecarlo_tpu.classical``;
reference ``src/classical/graph.rs``): colour-parallel Metropolis sweeps,
matching-parallel edge flips, batched worm walks, Swendsen-Wang and Wolff
cluster moves on arbitrary graphs (:class:`GraphState`), and the
checkerboard fast path of kernel K1 on a periodic square lattice
(:class:`LatticeIsing`)."""

from isingmontecarlo_tpu_torch.classical import cluster, metropolis, worm
from isingmontecarlo_tpu_torch.classical.graph_state import GraphState, make_random_spin_state
from isingmontecarlo_tpu_torch.classical.lattice_ising import LatticeIsing

__all__ = ["GraphState", "LatticeIsing", "cluster", "make_random_spin_state",
           "metropolis", "worm"]
