"""User-facing classical Ising MC API mirroring the reference ``GraphState``
(``src/classical/graph.rs:8-453``), batched over replicas (port of
``isingmontecarlo_tpu/classical/graph_state.py``).

The reference object is a single Markov chain; here ``R`` independent
chains run at once. Entry points:

- ``GraphState.new(edges, biases, ...)`` (``graph.rs:56-60``) and the
  ``new_with_state*`` variants (``graph.rs:62-88``);
- ``do_time_step(beta, ...)``: one MC step of a uniformly chosen move class
  (single-spin sweeps, edge-flip sweeps, worm updates; ``graph.rs:350-406``),
  the class drawn on the host so that choosing it reads nothing from the
  device;
- ``get_energy()`` (``graph.rs:430-447``) and the state accessors
  (``graph.rs:408-428``);
- ``enable_edge_importance_sampling`` (``graph.rs:321-336``);
- extra moves: ``swendsen_wang_step`` and ``wolff_step``.

Device randomness comes from a ``torch.Generator`` on the state's device.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from isingmontecarlo_tpu_torch.classical import cluster as _cluster
from isingmontecarlo_tpu_torch.classical import metropolis as _metro
from isingmontecarlo_tpu_torch.classical import worm as _worm
from isingmontecarlo_tpu_torch.lattice import Edge


class GraphState:
    """Batched classical Ising Monte Carlo on an arbitrary weighted graph."""

    def __init__(
        self,
        edges: Sequence[tuple[Edge, float]],
        biases: Sequence[float],
        *,
        replicas: int = 1,
        seed: int = 0,
        state=None,
        generator: torch.Generator | None = None,
        device: torch.device | str = "cuda",
    ):
        self.device = torch.device(device)
        self.edges = list(edges)
        self.nvars = len(biases)
        self.tables = _metro.build_tables(self.edges, biases, device=self.device)
        self.replicas = replicas
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(seed)
        self.draws = _metro.GeneratorDraws(generator)
        self._host_rng = np.random.default_rng(seed)
        if state is None:
            # Random initial state (graph.rs:451-453).
            self.spins = self.draws.coin((replicas, self.nvars))
        else:
            self.spins = torch.empty((replicas, self.nvars), dtype=torch.bool,
                                     device=self.device)
            self.set_state(state)
        self._only_basic_moves = False
        self._edge_attempt_p = None

    # -- constructors mirroring the reference ------------------------------

    @classmethod
    def new(cls, edges, biases, *, replicas: int = 1, seed: int = 0,
            device: torch.device | str = "cuda"):
        """Mirror of ``GraphState::new`` (``graph.rs:56-60``)."""
        return cls(edges, biases, replicas=replicas, seed=seed, device=device)

    @classmethod
    def new_with_state(cls, state, edges, biases, *, replicas: int = 1,
                       seed: int = 0, device: torch.device | str = "cuda"):
        """Seeded variant of ``GraphState::new_with_state_and_rng``
        (``graph.rs:62-88``)."""
        return cls(edges, biases, replicas=replicas, seed=seed, state=state,
                   device=device)

    @classmethod
    def new_with_state_and_rng(cls, state, edges, biases,
                               generator: torch.Generator, *, replicas: int = 1):
        """Mirror of ``GraphState::new_with_state_and_rng`` (``graph.rs:62-88``)
        with a caller-supplied ``torch.Generator`` (the reference's ``R: Rng``);
        the state lives on the generator's device."""
        return cls(edges, biases, replicas=replicas, state=state,
                   generator=generator, device=generator.device)

    # -- moves -------------------------------------------------------------

    def _spin_sweep(self, beta) -> None:
        shape = (self.tables.n_site_colors, self.replicas, self.nvars)
        self.spins = _metro.spin_flip_sweep(self.spins, self.draws.uniform(shape),
                                            beta, self.tables)

    def _edge_sweep(self, beta) -> None:
        C, E = self.tables.n_edge_colors, len(self.edges)
        u_attempt = (self.draws.uniform((C, E))
                     if self._edge_attempt_p is not None else None)
        self.spins = _metro.edge_flip_sweep(
            self.spins, self.draws.uniform((C, self.replicas, E)), beta,
            self.tables, attempt_p=self._edge_attempt_p, u_attempt=u_attempt)

    def do_time_step(
        self,
        beta: float,
        *,
        nspinupdates: int | None = None,
        nedgeupdates: int | None = None,
        nwormupdates: int | None = None,
        only_basic_moves: bool | None = None,
    ) -> None:
        """One MC step: a uniformly chosen move class (``graph.rs:350-406``).

        The reference performs ``nspinupdates`` single random-site attempts
        (default ``nvars/2``); one colour-parallel sweep performs ``nvars``
        attempts, so the counts are scaled to sweeps:
        ``max(1, round(nspinupdates / nvars))`` (likewise for edges)."""
        only_basic = (self._only_basic_moves if only_basic_moves is None
                      else only_basic_moves)
        choice = int(self._host_rng.integers(0, 2 if only_basic else 3))
        if choice == 0:
            n = nspinupdates if nspinupdates is not None else max(1, self.nvars // 2)
            for _ in range(max(1, round(n / max(1, self.nvars)))):
                self._spin_sweep(beta)
        elif choice == 1:
            ne = len(self.edges)
            n = nedgeupdates if nedgeupdates is not None else max(1, ne // 2)
            for _ in range(max(1, round(n / max(1, ne)))):
                self._edge_sweep(beta)
        else:
            for _ in range(nwormupdates if nwormupdates is not None else 1):
                self.spins = _worm.worm_sweep(self.spins, self.draws, beta, self.tables)

    def run_timesteps(self, t: int, beta: float) -> None:
        for _ in range(t):
            self.do_time_step(beta)

    def do_spin_flip(self, beta: float) -> None:
        """One colour-parallel single-spin-flip sweep (``graph.rs:91-119``;
        the reference flips one random site per call, here every replica
        attempts every site once)."""
        self._spin_sweep(beta)

    @staticmethod
    def should_flip(generator: torch.Generator, beta, delta_e) -> torch.Tensor:
        """Batched Metropolis accept (``graph.rs:339-347``): always when
        ``delta_e <= 0``, else with probability ``exp(-beta*delta_e)``, with
        uniforms from ``generator`` on its device."""
        delta_e = torch.as_tensor(delta_e, dtype=torch.float32, device=generator.device)
        u = torch.rand(delta_e.shape, generator=generator, device=generator.device)
        return (delta_e <= 0.0) | (u < torch.exp(-beta * delta_e))

    def swendsen_wang_step(self, beta: float) -> None:
        """Extra move (not in the reference): a Swendsen-Wang sweep."""
        R, N, E = self.replicas, self.nvars, len(self.edges)
        self.spins = _cluster.swendsen_wang_sweep(
            self.spins, self.draws.uniform((R, E)), self.draws.coin((R, N)),
            self.draws.uniform((R, N)), beta, self.tables)

    def wolff_step(self, beta: float) -> None:
        """Extra move (not in the reference): a Wolff cluster flip."""
        R, N, E = self.replicas, self.nvars, len(self.edges)
        self.spins = _cluster.wolff_sweep(
            self.spins, self.draws.uniform((R, E)), self.draws.randint(N, (R,)),
            beta, self.tables)

    def enable_edge_importance_sampling(self, enable: bool) -> None:
        """Edge importance sampling (``graph.rs:321-336``): the reference
        draws flip-attempt edges proportionally to their coupling weight;
        here each edge attempts with probability ``w_e / w_max`` per sweep,
        the same attempt-frequency profile."""
        if enable and self.edges:
            w = torch.abs(self.tables.ej)
            self._edge_attempt_p = w / torch.clamp(torch.max(w), min=1e-30)
        else:
            self._edge_attempt_p = None

    # -- accessors ---------------------------------------------------------

    def get_energy(self) -> torch.Tensor:
        """Energy per replica, ``f32[R]`` (``graph.rs:430-447``)."""
        return _metro.energy(self.spins, self.tables)

    def get_magnetization(self) -> torch.Tensor:
        return _metro.magnetization(self.spins)

    def clone_state(self) -> np.ndarray:
        return self.spins.cpu().numpy()

    def get_state(self) -> np.ndarray:
        """The spin state (``graph.rs:409-412``)."""
        return self.spins.cpu().numpy()

    def state_ref(self) -> torch.Tensor:
        return self.spins

    def set_state(self, state) -> None:
        state = torch.as_tensor(state, dtype=torch.bool, device=self.device)
        if state.dim() == 1:
            state = state[None, :].expand(self.spins.shape)
        if tuple(state.shape) != tuple(self.spins.shape):
            raise ValueError(f"state: expected shape {tuple(self.spins.shape)}, "
                             f"got {tuple(state.shape)}")
        self.spins = state.contiguous()

    def __repr__(self) -> str:
        """Per-replica ``<bits>\\t<energy>`` lines (the reference ``Debug``
        impl, ``graph.rs:17-31``)."""
        bits = self.get_state()
        energies = self.get_energy().cpu().numpy()
        return "\n".join(
            "".join("1" if b else "0" for b in row) + f"\t{e}"
            for row, e in zip(bits, energies)
        )


def make_random_spin_state(n: int, generator: torch.Generator,
                           replicas: int = 1) -> torch.Tensor:
    """Mirror of ``make_random_spin_state`` (``graph.rs:451-453``), batched:
    fair coin flips ``bool[replicas, n]`` on the generator's device."""
    return torch.rand((replicas, n), generator=generator, device=generator.device) < 0.5
