"""Uniform periodic square-lattice fast path (port of
``isingmontecarlo_tpu/classical/lattice_ising.py``): the user-facing wrapper
over kernel K1, :func:`isingmontecarlo_tpu_torch.ops.checkerboard_multi_sweep`.

Spins live as ``bool[R, L, L]``; a call of :meth:`LatticeIsing.run_sweeps`
runs all its sweeps in one call of K1 on a CUDA device (one kernel launch,
a launch a wave of replicas, or a launch per k sweeps where the field is
too large for the card's resident shared memory) and in the plain version
on the CPU. Energy conventions match ``src/classical/graph.rs:430-447``.
"""

from __future__ import annotations

import numpy as np
import torch

from isingmontecarlo_tpu_torch.classical import metropolis as _metro


class LatticeIsing:
    """Batched classical Ising model on an L x L periodic lattice (even L)
    with uniform coupling ``j`` and field ``h``, on ``device``."""

    def __init__(
        self,
        L: int,
        j: float = -1.0,
        h: float = 0.0,
        *,
        replicas: int = 1,
        seed: int = 0,
        state=None,
        device: torch.device | str = "cuda",
    ):
        if L % 2:
            raise ValueError(f"LatticeIsing needs an even L, got L={L}")
        self.device = torch.device(device)
        self.L = L
        self.j = float(j)
        self.h = float(h)
        self.replicas = replicas
        self._seed = seed
        self._sweep_counter = 0
        if state is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            self.spins = torch.rand((replicas, L, L), generator=gen,
                                    device=self.device) < 0.5
        else:
            spins = torch.as_tensor(state, dtype=torch.bool, device=self.device)
            if spins.dim() == 2:
                spins = spins[None].expand(replicas, L, L)
            self.spins = spins.contiguous()

    def run_sweeps(self, nsweeps: int, beta: float) -> None:
        """``nsweeps`` full checkerboard Metropolis sweeps, keyed by the
        per-call seed ``seed * 1000003 + call number`` as in the JAX
        package."""
        self._sweep_counter += 1
        self.spins = _metro.lattice_multi_sweep(
            self.spins, self._seed * 1000003 + self._sweep_counter,
            beta, self.j, self.h, nsweeps,
        )

    def get_energy(self) -> torch.Tensor:
        """Total energy per replica ``f32[R]`` (``graph.rs:430-447``)."""
        return _metro.lattice_energy(self.spins, self.j, self.h)

    def get_magnetization(self) -> torch.Tensor:
        """Sum of spins (+-1) per replica, ``f32[R]``."""
        return torch.sum(_metro.sigma(self.spins), dim=(-1, -2))

    def state_ref(self) -> torch.Tensor:
        return self.spins

    def clone_state(self) -> np.ndarray:
        return self.spins.cpu().numpy()
