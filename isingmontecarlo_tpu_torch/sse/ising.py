"""TFIM timestep and stepping API (port of ``isingmontecarlo_tpu/sse/ising.py``;
reference ``QmcIsingGraph``, ``src/sse/qmc_ising.rs:28-46, 644-795``).

``H = sum_ij J_ij s^z_i s^z_j + G sum_i s^x_i + h sum_i s^z_i``

A timestep (``qmc_ising.rs:644-795``):

1. diagonal sweep (Metropolis, or heat-bath when enabled);
2. RVB updates, when enabled (``sse/rvb.py``);
3. cluster update (weighted when ``h != 0``);
4. resample spins that carry no op;
5. grow the cutoff ``M = max(M, n + n/2)`` (on the host, between chunks).

Randomness enters only through a :class:`Draws` object asked for each
update's uniforms by shape, in the shapes the JAX package draws; the
production one, :class:`GeneratorDraws`, draws from a ``torch.Generator`` on
the model's device (Philox on CUDA).
"""

from __future__ import annotations

import contextlib
import sys
from typing import Any, Callable, NamedTuple, Protocol, Sequence

import numpy as np
import torch

from isingmontecarlo_tpu_torch import profiling
from isingmontecarlo_tpu_torch.analysis import autocorr as _ac
from isingmontecarlo_tpu_torch.lattice import Edge, edge_arrays, nvars_from_edges
from isingmontecarlo_tpu_torch.sse import cluster as _cluster
from isingmontecarlo_tpu_torch.sse import debug as _debug
from isingmontecarlo_tpu_torch.sse import graphs as _graphs
from isingmontecarlo_tpu_torch.sse import loops as _loops
from isingmontecarlo_tpu_torch.sse import opstring as _ops
from isingmontecarlo_tpu_torch.sse import rvb as _rvb
from isingmontecarlo_tpu_torch.sse.diagonal import (
    HeatBathTables, diagonal_update, make_heatbath_tables,
)
from isingmontecarlo_tpu_torch.sse.model import BondModel, tfim_model


class SseState(NamedTuple):
    """The simulation state: op string and p=0 spins ``bool[R, N]``."""

    ops: _ops.OpString
    state: torch.Tensor


class HamInfo(NamedTuple):
    """Data required to evaluate the Hamiltonian (``qmc_ising.rs:890-905``).

    Equality follows the reference's ``PartialEq``: edges and transverse
    field only (``qmc_ising.rs:898-902``)."""

    edges: tuple
    transverse: float
    longitudinal: float
    nvars: int

    def __eq__(self, other) -> bool:
        return (isinstance(other, HamInfo) and self.edges == other.edges
                and self.transverse == other.transverse)

    def __ne__(self, other) -> bool:
        return not self.__eq__(other)


class Draws(Protocol):
    """The random numbers of one timestep, asked for by shape."""

    def diagonal(self, shape: tuple[int, int, int]) -> torch.Tensor:
        """Uniforms ``f32[3, M, R]`` of the diagonal update."""

    def cluster(self, shape: tuple[int, int]) -> torch.Tensor:
        """Per-root uniforms ``f32[SL, R]`` of the cluster update."""

    def free_spins(self, shape: tuple[int, int]) -> torch.Tensor:
        """Fair coin flips ``bool[R, N]`` for spins that carry no op."""

    def rvb(self, n_updates: int) -> _rvb.RvbDraws:
        """The draws of the timestep's RVB sweep of ``n_updates`` updates."""

    def loops(self) -> _loops.LoopDraws:
        """The draws of the timestep's directed-loop update."""

    def swap(self, shape: tuple[int]) -> torch.Tensor:
        """Uniforms ``f32[R]`` of a tempering swap after the timestep."""


class GeneratorDraws:
    """:class:`Draws` from a ``torch.Generator`` on one device."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    def _uniform(self, shape) -> torch.Tensor:
        return torch.rand(shape, generator=self.generator,
                          device=self.generator.device, dtype=torch.float32)

    def diagonal(self, shape):
        return self._uniform(shape)

    def cluster(self, shape):
        return self._uniform(shape)

    def free_spins(self, shape):
        return self._uniform(shape) < 0.5

    def rvb(self, n_updates):
        return _rvb.GeneratorRvbDraws(self.generator)

    def loops(self):
        return _loops.GeneratorLoopDraws(self.generator)

    def swap(self, shape):
        return self._uniform(shape)


def resample_free_spins(sse: SseState, fresh: torch.Tensor, model: BondModel,
                        has_op: torch.Tensor | None = None) -> SseState:
    """Spins with no ops take the coin flips ``fresh bool[R, N]``
    (``qmc_ising.rs:780-784``). ``has_op bool[R, N]`` may be passed by a
    caller that knows it; otherwise it is derived from the op string."""
    if has_op is None:
        R = sse.state.shape[0]
        vars_ = _ops.op_vars(sse.ops, model).reshape(-1, R)
        idx = torch.where(vars_ >= 0, vars_, model.nvars).long()
        has_op = torch.zeros((model.nvars + 1, R), dtype=torch.bool,
                             device=idx.device).scatter_(0, idx, True)[:-1].T
    return sse._replace(state=torch.where(has_op, sse.state, fresh))


def sweep(sse: SseState, beta, model: BondModel, draws: Draws,
          cluster_caps: tuple[int, int] | None = None,
          do_cluster: bool = True, hb: HeatBathTables | None = None,
          heatbath: bool = False, bond_scale: torch.Tensor | None = None,
          rvb_tables: _rvb.RvbTables | None = None, n_rvb: int = 0,
          rvb_compact: int | None = None,
          bond_xor: torch.Tensor | None = None) -> tuple[SseState, torch.Tensor]:
    """One timestep (``qmc_ising.rs:644-795`` minus cutoff growth). Returns
    ``(state, rvb_successes i32[R])``, zeros when RVB is off.

    ``do_cluster=False`` skips the cluster update and free-spin resample
    (``multi_sweep``'s ``cluster_every`` thinning). ``cluster_caps`` are the
    host-tracked ``(label_cap, edge_cap)`` of the cluster label problem;
    without them the cluster update labels at full size, never skipped.
    ``hb``, ``heatbath`` and ``bond_scale`` go to :func:`diagonal_update`.
    ``n_rvb > 0`` runs that many RVB updates after the diagonal update,
    on the occupied-slot prefix of ``rvb_compact`` rows when given
    (:func:`rvb.rvb_sweep`). ``bond_xor i32[R, NB]`` gives each replica a
    sign pattern (the signed tempering ladders; see ``diagonal.py``) in the
    diagonal and cluster updates; RVB refuses it, since its tables hold the
    base model's signs (``isingmontecarlo_tpu/sse/ising.py:124-126``)."""
    if n_rvb > 0 and rvb_tables is None:
        raise ValueError("RVB updates need rvb_tables (rvb.make_rvb_tables)")
    if n_rvb > 0 and bond_xor is not None:
        raise ValueError("RVB updates do not support per-replica sign patterns (bond_xor)")
    ops, state = sse
    M, R = ops.bond.shape
    N = model.nvars
    if cluster_caps is not None:
        lc, ec = cluster_caps
    else:
        lc, ec = M + N + 1, None
    if isinstance(beta, torch.Tensor) or np.ndim(beta) != 0:
        beta = torch.as_tensor(beta, dtype=torch.float32, device=state.device)
    else:
        # A fill on the device: a copy from the host's pageable memory would
        # wait for the card to drain its queue.
        beta = torch.full((), float(beta), dtype=torch.float32, device=state.device)
    # The stages without a host read run as CUDA graphs on the card
    # (sse/graphs.py); the draws and the reads between them stay eager.
    stage = _graphs.stager(model, state.device, (M, lc, ec))
    # The diagonal update and the free spins do not depend on the caps.
    by_cutoff = stage.resized((M, None, None))
    with profiling.span("sse.sweep"):
        with profiling.span("sse.diagonal"):
            if heatbath:
                profiling.count("sse.diagonal.heatbath")
            u = draws.diagonal((3, M, R))
            ops = by_cutoff("diagonal", diagonal_update, ops, state, beta, u, model, hb,
                            heatbath, bond_scale, bond_xor)
        if n_rvb > 0:
            with profiling.span("sse.rvb"):
                ops, state, succ = _rvb.rvb_sweep(ops, state, draws.rvb(n_rvb), model,
                                                  rvb_tables, n_rvb, compact_cutoff=rvb_compact)
        else:
            succ = torch.zeros((R,), dtype=torch.int32, device=state.device)
        if not do_cluster:
            return stage.detach(SseState(ops, state)), succ
        with profiling.span("sse.cluster"):
            # One segment graph serves the cluster update and the free-spin
            # resample (cluster flips never move ops), and computes the
            # labels' fits test for the read in sse.labels.
            with profiling.span("sse.segment_graph"):
                sg, has_op, fits = stage("segment_graph", _cluster.segment_stage, ops, model,
                                         lc, ec)
            ops, state = _cluster.cluster_update_impl(
                ops, state, draws.cluster, model, 0.5, lc, ec, sg, bond_xor, fits=fits,
                stage=stage,
            )
        with profiling.span("sse.free_spins"):
            sse = by_cutoff("free_spins", resample_free_spins, SseState(ops, state),
                            draws.free_spins((R, N)), model, has_op)
            return stage.detach(sse), succ


def multi_sweep(sse: SseState, beta, model: BondModel, nsweeps: int,
                next_draws: Callable[[], Draws],
                cluster_caps: tuple[int, int] | None = None,
                cluster_every: int = 1, collect_states: bool = False,
                hb: HeatBathTables | None = None, heatbath: bool = False,
                bond_scale: torch.Tensor | None = None,
                rvb_tables: _rvb.RvbTables | None = None, n_rvb: int = 0,
                rvb_compact: int | None = None, bond_xor: torch.Tensor | None = None,
                cluster_flags: Sequence[bool] | torch.Tensor | None = None):
    """``nsweeps`` timesteps; ``next_draws()`` gives each one's draws.

    The cluster update runs on every ``cluster_every``-th timestep only
    (``k = 1`` is the reference composition), or on the timesteps that
    ``cluster_flags`` (``nsweeps`` bools, or a bool tensor read once on the
    host) marks, which overrides ``cluster_every``
    (``isingmontecarlo_tpu/sse/ising.py:224, 265-271``). Returns ``(sse, ns
    i32[T, R], states bool[T, R, N] or None, rvb_successes i32[R])``, ``ns``
    the op count after each step and the successes summed over the steps."""
    if cluster_flags is None:
        flags = [i % cluster_every == cluster_every - 1 for i in range(nsweeps)]
    else:
        if isinstance(cluster_flags, torch.Tensor):
            profiling.count("host_reads.flags")
            cluster_flags = cluster_flags.tolist()
        flags = [bool(f) for f in cluster_flags]
        if len(flags) != nsweeps:
            raise ValueError(f"{len(flags)} cluster_flags for {nsweeps} timesteps")
    ns, states = [], []
    succ = torch.zeros((sse.state.shape[0],), dtype=torch.int32, device=sse.state.device)
    for i in range(nsweeps):
        sse, s = sweep(sse, beta, model, next_draws(), cluster_caps=cluster_caps,
                       do_cluster=flags[i],
                       hb=hb, heatbath=heatbath, bond_scale=bond_scale,
                       rvb_tables=rvb_tables, n_rvb=n_rvb, rvb_compact=rvb_compact,
                       bond_xor=bond_xor)
        if n_rvb > 0:
            succ += s
        ns.append(_ops.op_count(sse.ops))
        if collect_states:
            states.append(sse.state)
    return (sse, torch.stack(ns), torch.stack(states) if collect_states else None,
            succ)


def cap_counts(ops: _ops.OpString, model: BondModel):
    """Per-batch maxima of (constant-op count, multi-leg-op count): the real
    label and edge row counts of the cluster label problem, less N."""
    b = ops.bond.clamp(min=0).long()
    occ = ops.bond >= 0
    n_const = (model.is_constant[b] & occ).sum(dim=0)
    n_multi = (occ & (model.arity()[b] >= 2)).sum(dim=0)
    return n_const.max(), n_multi.max()


def rvb_compact_cutoff(n_max: int, current: int | None, cutoff: int) -> int | None:
    """The RVB sweeps' compaction cutoff after a refresh
    (``isingmontecarlo_tpu/sse/ising.py:770-784``): the largest op count
    ``n_max`` with 25% slack, 16-quantized; grown on demand, shrunk only
    past 2x; ``None`` (the full string) unless it cuts at least an eighth
    of the ``cutoff`` slots."""
    want = 16 * ((n_max + (n_max >> 2) + 2 + 15) // 16)
    if current is None or want > current or want * 2 < current:
        current = want
    return current if current <= cutoff - (cutoff >> 3) else None


def new_qmc(edges, transverse, longitudinal=0.0, cutoff=None, *, replicas=1,
            seed=0, state=None, device: torch.device | str = "cuda"):
    """Free-function constructor (``new_qmc``, ``qmc_ising.rs:49-65``)."""
    return QmcIsingGraph(edges, transverse, longitudinal, cutoff,
                         replicas=replicas, seed=seed, state=state, device=device)


def new_qmc_from_graph(graph_state, transverse, longitudinal=0.0, *, seed=0,
                       device: torch.device | str = "cuda"):
    """Seed a QMC run from classical-MC states (``new_qmc_from_graph``,
    ``qmc_ising.rs:68-77``)."""
    return QmcIsingGraph.new_from_graph_state(graph_state, transverse, longitudinal,
                                              seed=seed, device=device)


class QmcIsingGraph:
    """Batched transverse-field Ising model QMC on one device: ``R``
    independent replicas (``qmc_ising.rs:49-166``)."""

    def __init__(
        self,
        edges: Sequence[tuple[Edge, float]],
        transverse: float,
        longitudinal: float = 0.0,
        cutoff: int | None = None,
        *,
        replicas: int = 1,
        seed: int = 0,
        state=None,
        device: torch.device | str = "cuda",
    ):
        self.device = torch.device(device)
        self.edges = list(edges)
        self.transverse = float(transverse)
        self.longitudinal = float(longitudinal)
        self.nvars = nvars_from_edges(edges)
        self.model = tfim_model(edges, transverse, longitudinal, device=self.device)
        self.replicas = replicas
        self.draws = GeneratorDraws(
            torch.Generator(device=self.device).manual_seed(seed))
        self._heatbath = False
        self._hb_tables: HeatBathTables | None = None
        self._run_rvb = False
        self._rvb_tables: _rvb.RvbTables | None = None
        self._rvb_updates: int | None = None
        # Host-tracked occupied-slot compaction cutoff of the RVB sweeps
        # (None: the full string), refreshed with hysteresis in _maybe_grow.
        self._rvb_compact: int | None = None
        # RVB successes summed on the device (read by total_rvb_successes),
        # and the updates attempted.
        self._rvb_successes = torch.zeros((), dtype=torch.int64, device=self.device)
        self.rvb_clusters_counted = 0
        # Cold start: the cutoff has not tracked n + n/2 yet, so stepping
        # begins with single timesteps (see timesteps_measure); the
        # no-growth streak persists across calls.
        self._growth_pending = True
        self._growth_stable = 0
        # Host-tracked caps of the cluster label problem (monotone,
        # 16-quantized; see _maybe_grow). None until first measured.
        self._cluster_caps: tuple[int, int] | None = None
        self._cluster_every = 1
        # Reduces the growth statistics over the ranks of a sharded
        # tempering container (TemperingContainer.shard_over), so that every
        # rank grows alike; None on one device.
        self._reduce_max: Callable[[torch.Tensor], torch.Tensor] | None = None
        if state is None:
            spins = self.draws.free_spins((replicas, self.nvars))
        else:
            spins = self._spins(state)
        cutoff = max(cutoff or 0, self.nvars, 8)
        self.sse = SseState(
            ops=_ops.empty_opstring(cutoff, replicas, self.model.max_legs,
                                    device=self.device),
            state=spins,
        )

    # -- constructors ------------------------------------------------------

    @classmethod
    def new_with_rng(cls, edges, transverse, longitudinal=0.0, cutoff=None, *,
                     replicas=1, seed=0, state=None,
                     device: torch.device | str = "cuda"):
        """``QmcIsingGraph::new_with_rng`` (``qmc_ising.rs:118-148``)."""
        return cls(edges, transverse, longitudinal, cutoff, replicas=replicas,
                   seed=seed, state=state, device=device)

    @classmethod
    def new_from_graph_state(cls, graph_state, transverse, longitudinal=0.0, *,
                             seed=0, device: torch.device | str = "cuda"):
        """``new_from_graph`` (``qmc_ising.rs:151-166``): seed the quantum
        simulation from a classical :class:`GraphState`'s replicas."""
        spins = graph_state.state_ref()
        return cls(graph_state.edges, transverse, longitudinal,
                   replicas=spins.shape[0], seed=seed, state=spins, device=device)

    # -- Hamiltonian access (qmc_ising.rs:169-205) --------------------------

    def make_haminfo(self) -> HamInfo:
        """``qmc_ising.rs:169-176``."""
        return HamInfo(edges=tuple((tuple(e), float(j)) for e, j in self.edges),
                       transverse=self.transverse, longitudinal=self.longitudinal,
                       nvars=self.nvars)

    def hamiltonian(self, bond: int, inputs, outputs) -> float:
        """Matrix element of ``bond`` for the given leg substates
        (``qmc_ising.rs:179-205``), from the compiled tables."""
        si = sum(1 << l for l, v in enumerate(inputs) if v)
        so = sum(1 << l for l, v in enumerate(outputs) if v)
        return float(self.model.full_w[bond, si, so])

    # -- manager/state swap (qmc_ising.rs:563-602) --------------------------

    def can_swap_managers(self, other: "QmcIsingGraph") -> bool:
        """Graphs can swap when shapes agree (``qmc_ising.rs:563-591``; the
        Hamiltonians may differ)."""
        return (self.nvars == other.nvars and self.replicas == other.replicas
                and self.model.nbonds == other.model.nbonds)

    def swap_manager_and_state(self, other: "QmcIsingGraph") -> None:
        """Exchange op strings and states with another graph
        (``qmc_ising.rs:593-602``)."""
        if not self.can_swap_managers(other):
            raise ValueError("graphs of different shapes cannot swap managers")
        self.sse, other.sse = other.sse, self.sse

    # -- conversion (IntoQmc, qmc_ising.rs:934-976) -------------------------

    def into_qmc(self):
        """A generic :class:`~isingmontecarlo_tpu_torch.sse.runner.Qmc` with the
        same interactions, op string, state, random stream and device
        (``qmc_ising.rs:946-976``): edges become diagonal interactions
        ``[-J, J, J, -J]`` with offset, the transverse field a constant 2x2
        interaction, the longitudinal field a diagonal ``[-h, h]`` with
        offset. The bond layout is ``tfim_model``'s, so the op string
        carries over as it is."""
        from isingmontecarlo_tpu_torch.sse.runner import Qmc

        q = Qmc(self.nvars, replicas=self.replicas, state=self.sse.state,
                device=self.device)
        for (a, b), j in self.edges:
            q.make_diagonal_interaction_and_offset([-j, j, j, -j], [a, b])
        g = self.transverse
        for v in range(self.nvars):
            q.make_interaction([[g, g], [g, g]], [v])
        # The constant all-Gamma matrix is Gamma (sx + 1) and must stay
        # constant (a cluster edge), so its +Gamma per site goes into the
        # offset. The reference's IntoQmc drops it (qmc_ising.rs:958-963),
        # so its energies come out shifted by -N Gamma.
        q.offset += self.nvars * g
        if abs(self.longitudinal) > 1e-12:
            # Up |h| + h, down |h| - h, as longitudinal_hamiltonian
            # (qmc_ising.rs:880-888); the reference's IntoQmc passes an
            # inverted, sign-indefinite matrix (qmc_ising.rs:964-967).
            h = self.longitudinal
            for v in range(self.nvars):
                q.make_diagonal_interaction_and_offset([-h, h], [v])
        q._sse = self.sse
        generator = torch.Generator(device=self.device)
        generator.set_state(self.draws.generator.get_state())
        q.draws = GeneratorDraws(generator)
        return q

    # -- toggles (qmc_ising.rs:435-486) ------------------------------------

    def set_enable_heatbath(self, enable: bool) -> None:
        """Use the heat-bath diagonal update in every timestep
        (``qmc_ising.rs:443-486``)."""
        self._heatbath = bool(enable)
        if enable and self._hb_tables is None:
            self._hb_tables = make_heatbath_tables(self.model)

    def set_run_rvb(self, run: bool, updates_per_timestep: int | None = None) -> None:
        """Run RVB updates in every timestep (``qmc_ising.rs:435-441``): the
        reference's ``(nvars + 1) / 2`` a timestep (``qmc_ising.rs:709-710``),
        or ``updates_per_timestep``."""
        self._run_rvb = bool(run)
        if updates_per_timestep is not None:
            self._rvb_updates = updates_per_timestep
        elif self._rvb_updates is None:
            self._rvb_updates = (self.nvars + 1) // 2
        if run and self._rvb_tables is None:
            self._rvb_tables = _rvb.make_rvb_tables(self.edges, self.model)

    def set_cluster_every(self, k: int) -> None:
        """Run the cluster update and free-spin resample on every ``k``-th
        timestep of a chunk (``k = 1``, the default, is the reference
        composition)."""
        if k < 1:
            raise ValueError(f"cluster_every must be >= 1, got {k}")
        self._cluster_every = int(k)

    def _diag_args(self) -> dict:
        return dict(hb=self._hb_tables if self._heatbath else None,
                    heatbath=self._heatbath)

    def _rvb_args(self) -> dict:
        """The RVB keyword arguments of a sweep from the graph's settings."""
        if not self._run_rvb:
            return {}
        return dict(rvb_tables=self._rvb_tables, n_rvb=self._rvb_updates or 0,
                    rvb_compact=self._rvb_compact)

    def _count_rvb(self, succ: torch.Tensor, nsweeps: int) -> None:
        if self._run_rvb:
            self._rvb_successes += succ.sum()
            self.rvb_clusters_counted += (self._rvb_updates or 0) * self.replicas * nsweeps

    @property
    def total_rvb_successes(self) -> int:
        """Accepted RVB updates over all replicas so far (one host read)."""
        return int(self._rvb_successes)

    # -- accessors ---------------------------------------------------------

    @property
    def cutoff(self) -> int:
        return self.sse.ops.cutoff

    def get_cutoff(self) -> int:
        """``qmc_ising.rs:532``."""
        return self.cutoff

    def set_cutoff(self, cutoff: int) -> None:
        """Grow the op-string capacity (``qmc_ising.rs:537``; shrinking is a
        no-op, since slots above the old cutoff are identities)."""
        self.sse = self.sse._replace(ops=_ops.grow(self.sse.ops, cutoff))

    def get_nvars(self) -> int:
        return self.nvars

    def get_edges(self):
        return self.edges

    def get_transverse_field(self) -> float:
        return self.transverse

    def get_longitudinal_field(self) -> float:
        return self.longitudinal

    def _spins(self, state) -> torch.Tensor:
        spins = torch.as_tensor(state, dtype=torch.bool, device=self.device)
        if spins.dim() == 1:
            spins = spins[None].expand(self.replicas, self.nvars)
        return spins.contiguous()

    def set_state(self, state) -> None:
        """Overwrite the p=0 state ``bool[R, N]`` or ``bool[N]``
        (``state_mut``, ``qmc_ising.rs:497``)."""
        self.sse = self.sse._replace(state=self._spins(state))

    def state_mut(self):
        """Context manager yielding a host copy of the p=0 state, committed
        on exit (``state_mut``, ``qmc_ising.rs:497``)::

            with g.state_mut() as s:
                s[:, 0] = True
        """

        @contextlib.contextmanager
        def _ctx():
            s = self.clone_state()
            yield s
            self.set_state(s)

        return _ctx()

    def get_n(self) -> torch.Tensor:
        """Op count per replica ``i32[R]``."""
        return _ops.op_count(self.sse.ops)

    def get_bond_count(self, bond: int) -> torch.Tensor:
        """Ops at ``bond`` per replica, ``i32[R]`` (``qmc_stepper.rs:14``)."""
        return _ops.bond_counts(self.sse.ops, self.model.nbonds)[:, bond]

    def state_ref(self) -> torch.Tensor:
        return self.sse.state

    def clone_state(self) -> np.ndarray:
        """A host copy of the p=0 state ``bool[R, N]``."""
        return self.sse.state.cpu().numpy().copy()

    def into_vec(self) -> np.ndarray:
        """The p=0 state as a host array (``qmc_ising.rs:507-510``)."""
        return self.clone_state()

    def get_manager_ref(self) -> _ops.OpString:
        """The op string, the reference's op manager
        (``qmc_ising.rs:548-550``)."""
        return self.sse.ops

    def get_manager_mut(self) -> _ops.OpString:
        """``qmc_ising.rs:553-555``: mutate the tensors in place, or assign
        ``graph.sse = graph.sse._replace(ops=...)``."""
        return self.sse.ops

    def get_offset(self) -> float:
        return self.model.offset

    def get_energy_for_average_n(self, average_n, beta) -> torch.Tensor:
        """``E = -<n>/beta + offset`` (``qmc_ising.rs:805-809``)."""
        n = torch.as_tensor(average_n, device=self.device).to(torch.float32)
        return -(n / beta) + self.model.offset

    def verify(self) -> bool:
        """Worldline integrity of every replica (``qmc_ising.rs:824-861``)."""
        return bool(_ops.verify(self.sse.ops, self.sse.state, self.model).all())

    def imaginary_time_states(self) -> torch.Tensor:
        """All propagated states ``bool[M, R, N]``; O(M·R·N) memory, so for
        deep strings use :meth:`imaginary_time_fold`."""
        return _ops.itime_states(self.sse.ops, self.sse.state, self.model)

    def imaginary_time_fold(self, fold_fn, init):
        """Fold ``fold_fn(acc, state_at_p)`` over all ``M`` propagated
        states (``imaginary_time_fold``, ``qmc_stepper.rs:165-167``)."""
        return _ops.itime_fold(self.sse.ops, self.sse.state, self.model, fold_fn, init)

    # -- debug / introspection (qmc_debug.rs, qmc_ising.rs:489-494) --------

    def count_diagonal_and_off(self):
        """Per-replica (diagonal, off-diagonal) counts (``qmc_debug.rs:10``)."""
        return _debug.count_diagonal_and_off(self.sse.ops)

    def count_constant_ops(self):
        """Per-replica constant-op counts (``qmc_debug.rs:28``)."""
        return _debug.count_constant_ops(self.sse.ops, self.model)

    def print_debug(self, replica: int = 0) -> None:
        """ASCII worldline dump of one replica (``qmc_ising.rs:489-494``)."""
        _debug.debug_print_diagonal(self.sse.ops, self.sse.state, self.model,
                                    replica, file=sys.stdout)

    # -- checkpoints (SerializeQmcGraph, qmc_ising.rs:1000-1159) -------------

    def save(self, path: str, *, strip_rng: bool = False) -> None:
        """Write a checkpoint in the JAX package's ``.npz`` layout
        (:mod:`isingmontecarlo_tpu_torch.checkpoint`)."""
        from isingmontecarlo_tpu_torch import checkpoint as _ckpt

        _ckpt.save_qmc_ising(path, self, strip_rng=strip_rng)

    @classmethod
    def load(cls, path: str, *, seed: int | None = None,
             device: torch.device | str = "cuda") -> "QmcIsingGraph":
        """A graph from :meth:`save`'s file or the JAX package's; ``seed``
        reseeds the generator."""
        from isingmontecarlo_tpu_torch import checkpoint as _ckpt

        return _ckpt.load_qmc_ising(path, seed=seed, device=device)

    # -- autocorrelations (QmcAutoCorrelations, autocorrelations.rs:6-97) ---

    def calculate_autocorrelation(self, timesteps: int, beta: float,
                                  sampling_freq: int | None,
                                  sample_mapper: Callable) -> np.ndarray:
        """Run ``timesteps``, map the sampled states ``bool[T, R, N]``
        through ``sample_mapper`` and FFT-autocorrelate along time
        (``autocorrelations.rs:8-35``). Returns ``f32[num_samples]``."""
        states, _ = self.timesteps_sample(timesteps, beta, sampling_freq)
        return _ac.sample_autocorrelation(states, sample_mapper).cpu().numpy()

    def calculate_variable_autocorrelation(self, timesteps: int, beta: float,
                                           sampling_freq: int | None = None) -> np.ndarray:
        """Autocorrelation of the spins (``autocorrelations.rs:38-50``)."""
        states, _ = self.timesteps_sample(timesteps, beta, sampling_freq)
        return _ac.spin_autocorrelation(states).cpu().numpy()

    def calculate_spin_product_autocorrelation(
        self, timesteps: int, beta: float, var_products: Sequence[Sequence[int]],
        sampling_freq: int | None = None,
    ) -> np.ndarray:
        """Autocorrelation of spin products (``autocorrelations.rs:53-70``)."""
        states, _ = self.timesteps_sample(timesteps, beta, sampling_freq)
        return _ac.product_autocorrelation(states, var_products).cpu().numpy()

    def calculate_bond_autocorrelation(self, timesteps: int, beta: float,
                                       sampling_freq: int | None = None) -> np.ndarray:
        """Autocorrelation of bond satisfaction (``qmc_ising.rs:978-998``)."""
        states, _ = self.timesteps_sample(timesteps, beta, sampling_freq)
        return _ac.bond_autocorrelation(states, *edge_arrays(self.edges)).cpu().numpy()

    # -- stepping ----------------------------------------------------------

    def single_diagonal_step(self, beta: float) -> None:
        """One diagonal sweep only (``qmc_ising.rs:208-273``)."""
        M, R = self.sse.ops.bond.shape
        ops = diagonal_update(self.sse.ops, self.sse.state, beta,
                              self.draws.diagonal((3, M, R)), self.model,
                              **self._diag_args())
        self.sse = self.sse._replace(ops=ops)
        self._maybe_grow()

    def single_cluster_step(self) -> None:
        """One cluster update only (``qmc_ising.rs:275-321``)."""
        lc, ec = self._cluster_caps or (None, None)
        ops, state = _cluster.cluster_update(self.sse.ops, self.sse.state,
                                             self.draws.cluster, self.model,
                                             label_cap=lc, edge_cap=ec)
        self.sse = SseState(ops, state)

    def single_rvb_sweep(self, updates_in_sweep: int | None = None) -> tuple[int, int]:
        """RVB updates only (``qmc_ising.rs:323-418``), on the full string.
        Returns ``(successes summed over replicas, updates attempted)``."""
        if self._rvb_tables is None:
            self._rvb_tables = _rvb.make_rvb_tables(self.edges, self.model)
        n = updates_in_sweep or (self.nvars + 1) // 2
        ops, state, succ = _rvb.rvb_sweep(self.sse.ops, self.sse.state, self.draws.rvb(n),
                                          self.model, self._rvb_tables, n)
        self.sse = SseState(ops, state)
        succs = succ.sum()
        self._rvb_successes += succs
        counted = n * self.replicas
        self.rvb_clusters_counted += counted
        return int(succs), counted

    def rvb_success_rate(self) -> float:
        """``qmc_ising.rs:605-607``."""
        return self.total_rvb_successes / max(self.rvb_clusters_counted, 1)

    def _maybe_grow(self) -> None:
        """Cutoff growth ``M = max(M, n + n/2)`` (``qmc_ising.rs:786``),
        quantized to multiples of 16, and a refresh of the cluster label
        caps and of the RVB compaction cutoff. One host read, of maxima over
        the replicas (and over the ranks, through ``_reduce_max``, on a
        sharded container)."""
        with profiling.span("sse.grow"):
            stats = torch.stack([_ops.op_count(self.sse.ops).max().to(torch.int64),
                                 *cap_counts(self.sse.ops, self.model)])
            if self._reduce_max is not None:
                stats = self._reduce_max(stats)
            profiling.count("host_reads.grow")
            n_max, nc, nm = (int(x) for x in stats.tolist())
            want = n_max + n_max // 2
            if want > self.cutoff:
                new_m = ((want + 15) // 16) * 16
                self.sse = self.sse._replace(ops=_ops.grow(self.sse.ops, new_m))
            if self._run_rvb:
                self._rvb_compact = rvb_compact_cutoff(n_max, self._rvb_compact, self.cutoff)
            N = self.nvars
            want_l = max(256, 16 * ((int((nc + N + 2) * 1.3) + 15) // 16))
            want_e = max(256, 16 * ((int((nm + N + 2) * 1.3) + 15) // 16))
            cur = self._cluster_caps or (0, 0)
            if want_l > cur[0] or want_e > cur[1]:
                self._cluster_caps = (max(want_l, cur[0]), max(want_e, cur[1]))

    def timestep(self, beta: float) -> torch.Tensor:
        """One timestep; returns the state (``qmc_ising.rs:644-795``)."""
        self.sse, succ = sweep(self.sse, beta, self.model, self.draws,
                               cluster_caps=self._cluster_caps, **self._diag_args(),
                               **self._rvb_args())
        self._count_rvb(succ, 1)
        self._maybe_grow()
        return self.sse.state

    def timesteps(self, t: int, beta: float, chunk: int = 16) -> torch.Tensor:
        """``t`` timesteps; returns the average energy per replica ``f32[R]``
        (``qmc_stepper.rs:17-20``)."""
        _, energy = self.timesteps_measure(t, beta, None, lambda acc, s: acc,
                                           chunk=chunk)
        return energy

    def timesteps_sample(self, t: int, beta: float, sampling_freq: int | None = None,
                         chunk: int = 16):
        """Returns ``(states bool[num_samples, R, N], energy f32[R])``, both
        on the device (``qmc_stepper.rs:23-40``)."""
        samples, energy = self.timesteps_measure(
            t, beta, [], lambda acc, s: (acc.append(s), acc)[1], sampling_freq,
            chunk=chunk,
        )
        if not samples:
            return torch.zeros((0, self.replicas, self.nvars), dtype=torch.bool,
                               device=self.device), energy
        return torch.stack(samples), energy

    def timesteps_sample_iter(self, t: int, beta: float, sampling_freq: int | None,
                              iter_fn: Callable[[torch.Tensor], None],
                              chunk: int = 16) -> torch.Tensor:
        """Call ``iter_fn(state)`` on every sample (``qmc_stepper.rs:43-73``);
        returns the average energy per replica."""
        _, energy = self.timesteps_measure(
            t, beta, None, lambda acc, s: (iter_fn(s), acc)[1], sampling_freq,
            chunk=chunk,
        )
        return energy

    def timesteps_sample_iter_zip(self, t: int, beta: float,
                                  sampling_freq: int | None, zip_with,
                                  iter_fn: Callable[[Any, torch.Tensor], None],
                                  chunk: int = 16) -> torch.Tensor:
        """Zip samples with an iterable (``qmc_stepper.rs:97-130``):
        ``iter_fn(next(zip_with), state)`` per sample, until the iterable is
        exhausted."""
        it = iter(zip_with)

        def fold(acc, s):
            try:
                z = next(it)
            except StopIteration:
                return acc
            iter_fn(z, s)
            return acc

        _, energy = self.timesteps_measure(t, beta, None, fold, sampling_freq,
                                           chunk=chunk)
        return energy

    def timesteps_measure(
        self,
        timesteps: int,
        beta: float,
        init_acc: Any,
        state_fold: Callable[[Any, torch.Tensor], Any],
        sampling_freq: int | None = None,
        chunk: int = 16,
        op_counts: list | None = None,
    ):
        """Fold ``state_fold(acc, state)`` over the states of every
        ``sampling_freq``-th step and average their op counts
        (``qmc_stepper.rs:133-162``). Returns ``(acc, energy f32[R])``.

        ``op_counts``, where given, gets each chunk's op counts after every
        timestep appended, ``i32[todo, R]`` on the device (no host read):
        their concatenation is the run's per-timestep op-count series, from
        which the energy's ESS is taken."""
        freq = sampling_freq or 1
        acc = init_acc
        total_n = torch.zeros((self.replicas,), dtype=torch.float64, device=self.device)
        steps_measured = 0
        done = 0
        stable = 2 if not self._growth_pending else self._growth_stable
        while done < timesteps:
            # Growth phase: from a cold cutoff, single timesteps (the
            # reference grows after every step) until two in a row stop
            # growing, then chunks, checked between chunks.
            todo = 1 if stable < 2 else min(chunk, timesteps - done)
            collect = any((done + i + 1) % freq == 0 for i in range(todo))
            self.sse, ns, states, succ = multi_sweep(
                self.sse, beta, self.model, todo, lambda: self.draws,
                cluster_caps=self._cluster_caps,
                cluster_every=self._cluster_every if todo > 1 else 1,
                collect_states=collect, **self._diag_args(), **self._rvb_args(),
            )
            self._count_rvb(succ, todo)
            if op_counts is not None:
                op_counts.append(ns)
            for i in range(todo):
                if (done + i + 1) % freq == 0:
                    if states is not None:
                        acc = state_fold(acc, states[i])
                    total_n += ns[i]
                    steps_measured += 1
            done += todo
            before = self.cutoff
            self._maybe_grow()
            stable = 0 if self.cutoff != before else stable + 1
        self._growth_stable = stable
        self._growth_pending = stable < 2
        average_n = total_n / max(steps_measured, 1)
        return acc, self.get_energy_for_average_n(average_n, beta)
