"""Generic k-local interaction QMC (port of ``isingmontecarlo_tpu/sse/runner.py``;
reference ``Qmc``, ``src/sse/qmc_runner.rs:26-440``), batched over replicas.

Interactions are arbitrary ``2^k x 2^k`` matrices (or ``2^k`` diagonals) over
``k`` variables, added through ``make_interaction[_and_offset]`` and
``make_diagonal_interaction[_and_offset]`` (``qmc_runner.rs:112-156``). A
timestep (``qmc_runner.rs:363-377``):

1. diagonal update (Metropolis, or heat-bath when enabled);
2. directed-loop update, when enabled (``sse/loops.py``);
3. cluster update, when the model has cluster edges and Ising symmetry;
4. resample the spins that carry no op (every timestep, with or without the
   cluster update);
5. grow the cutoff (on the host, after the step).

Randomness enters through the :class:`~isingmontecarlo_tpu_torch.sse.ising.Draws`
protocol, the loop update's through ``draws.loops()``.
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

import numpy as np
import torch

from isingmontecarlo_tpu_torch.analysis import autocorr as _ac
from isingmontecarlo_tpu_torch.sse import cluster as _cluster
from isingmontecarlo_tpu_torch.sse import loops as _loops
from isingmontecarlo_tpu_torch.sse import opstring as _ops
from isingmontecarlo_tpu_torch.sse.diagonal import (
    HeatBathTables, diagonal_update, make_heatbath_tables,
)
from isingmontecarlo_tpu_torch.sse.ising import (
    Draws, GeneratorDraws, SseState, cap_counts, resample_free_spins,
)
from isingmontecarlo_tpu_torch.sse.model import BondModel, generic_model


def generic_sweep(sse: SseState, beta, model: BondModel, draws: Draws,
                  do_loops: bool, do_cluster: bool, heatbath: bool = False,
                  hb: HeatBathTables | None = None,
                  cluster_caps: tuple[int, int] | None = None,
                  loop_cap: int | None = None) -> tuple[SseState, torch.Tensor]:
    """One generic-engine timestep (``qmc_runner.rs:363-377``, minus cutoff
    growth). Returns ``(state, loop-cap reverts bool[R])``."""
    ops, state = sse
    M, R = ops.bond.shape
    ops = diagonal_update(ops, state, beta, draws.diagonal((3, M, R)), model,
                          hb=hb, heatbath=heatbath)
    reverted = torch.zeros((R,), dtype=torch.bool, device=state.device)
    if do_loops:
        ops, state, reverted = _loops.loop_update(ops, state, draws.loops(), model,
                                                  cap_hops=loop_cap)
    has_op = None
    if do_cluster:
        if cluster_caps is not None:
            lc, ec = cluster_caps
        else:
            lc, ec = M + model.nvars + 1, None
        # One segment graph serves the cluster update and the free-spin
        # resample: cluster flips never move ops.
        sg, has_op, fits = _cluster.segment_stage(ops, model, lc, ec)
        ops, state = _cluster.cluster_update_impl(ops, state, draws.cluster, model,
                                                  0.5, lc, ec, sg, fits=fits)
    return resample_free_spins(SseState(ops, state), draws.free_spins((R, model.nvars)),
                               model, has_op=has_op), reverted


def generic_multi_sweep(sse: SseState, beta, model: BondModel, nsweeps: int,
                        next_draws: Callable[[], Draws], do_loops: bool,
                        do_cluster: bool, heatbath: bool = False,
                        hb: HeatBathTables | None = None,
                        cluster_caps: tuple[int, int] | None = None,
                        loop_cap: int | None = None):
    """``nsweeps`` generic timesteps; ``next_draws()`` gives each one's
    draws. Returns ``(sse, op counts i32[T, R], loop-cap reverts
    i32[T, R])``."""
    ns, reverts = [], []
    for _ in range(nsweeps):
        sse, rev = generic_sweep(sse, beta, model, next_draws(), do_loops, do_cluster,
                                 heatbath=heatbath, hb=hb, cluster_caps=cluster_caps,
                                 loop_cap=loop_cap)
        ns.append(_ops.op_count(sse.ops))
        reverts.append(rev.to(torch.int32))
    return sse, torch.stack(ns), torch.stack(reverts)


class Interaction:
    """A k-local interaction (the reference ``Interaction``,
    ``qmc_runner.rs:561-699``). ``mat`` is the stored (post-offset) matrix:
    ``2^k x 2^k`` (row = outputs, column = inputs) or a length-``2^k``
    diagonal; the first variable is the most significant bit
    (``qmc_runner.rs:668-680``)."""

    def __init__(self, mat: np.ndarray, vars: Sequence[int]):
        self.mat = np.asarray(mat, dtype=np.float64)
        self.vars = list(vars)
        self.n = len(self.vars)
        self.diagonal = self.mat.ndim == 1
        diag = self.mat if self.diagonal else np.diagonal(self.mat)
        self.constant_along_diagonal = bool(np.all(np.abs(diag - diag.flat[0]) < 1e-12))
        self._constant = (not self.diagonal) and bool(
            np.all(np.abs(self.mat - self.mat.flat[0]) < 1e-12))

    def is_constant(self) -> bool:
        """All entries equal (``qmc_runner.rs:562-564``)."""
        return self._constant

    def is_constant_diag(self) -> bool:
        """``qmc_runner.rs:567-569``."""
        return self.constant_along_diagonal

    @staticmethod
    def _index(bits) -> int:
        acc = 0
        for b in bits:
            acc = (acc << 1) | int(bool(b))
        return acc

    def at(self, inputs, outputs) -> float:
        """Matrix element for the given leg substates
        (``qmc_runner.rs:573-612``)."""
        if len(inputs) != self.n or len(outputs) != self.n:
            raise ValueError(f"Interaction covers {self.n} vars, "
                             f"given ({len(inputs)}/{len(outputs)})")
        if self.diagonal:
            if self._index(inputs) != self._index(outputs):
                return 0.0
            return float(self.mat[self._index(inputs)])
        return float(self.mat[self._index(outputs), self._index(inputs)])

    def sym_under_ising(self) -> bool:
        """Symmetry under a global spin flip (``qmc_runner.rs:643-664``)."""
        return sym_under_ising(self.mat, self.n)


def sym_under_ising(mat: np.ndarray, k: int) -> bool:
    """Global-spin-flip symmetry of an interaction matrix or diagonal
    (``qmc_runner.rs:643-664``)."""
    mat = np.asarray(mat, dtype=np.float64)
    n = 1 << k
    if mat.ndim == 1:
        return all(abs(mat[i] - mat[(~i) & (n - 1)]) < 1e-12 for i in range(n))
    return all(abs(mat[o, i] - mat[(~o) & (n - 1), (~i) & (n - 1)]) < 1e-12
               for o in range(n) for i in range(n))


class Qmc:
    """Batched generic-interaction SSE QMC on one device: ``R`` independent
    replicas (``qmc_runner.rs:26-440``)."""

    def __init__(self, nvars: int, *, replicas: int = 1, seed: int = 0,
                 do_loop_updates: bool = False, state=None,
                 device: torch.device | str = "cuda"):
        self.device = torch.device(device)
        self.nvars = nvars
        self.replicas = replicas
        self.do_loop_updates = do_loop_updates
        self.draws = GeneratorDraws(torch.Generator(device=self.device).manual_seed(seed))
        self._do_heatbath = False
        self._loop_cap: int | None = None
        # Reverted walks summed on the device; read by total_loop_reverts.
        self._loop_reverts = torch.zeros((), dtype=torch.int64, device=self.device)
        self.total_loop_updates = 0
        self._interactions: list[tuple[np.ndarray, list[int]]] = []
        self.offset = 0.0
        self.has_cluster_edges = False
        self.breaks_ising_symmetry = False
        # Cold start: single timesteps until the cutoff stops growing (see
        # timesteps); the no-growth streak persists across calls.
        self._growth_pending = True
        self._growth_stable = 0
        self._cluster_caps: tuple[int, int] | None = None
        self._model: BondModel | None = None
        self._hb: HeatBathTables | None = None
        if state is None:
            spins = self.draws.free_spins((replicas, nvars))
        else:
            spins = torch.as_tensor(state, dtype=torch.bool, device=self.device)
            if spins.dim() == 1:
                spins = spins[None].expand(replicas, nvars)
        self._spins = spins.contiguous()
        self._sse: SseState | None = None

    @classmethod
    def new_with_state(cls, nvars: int, state, *, replicas: int = 1, seed: int = 0,
                       do_loop_updates: bool = False,
                       device: torch.device | str = "cuda") -> "Qmc":
        """``qmc_runner.rs:54-62``."""
        return cls(nvars, replicas=replicas, seed=seed, do_loop_updates=do_loop_updates,
                   state=state, device=device)

    # -- interactions ------------------------------------------------------

    def _add(self, mat, vars, diagonal: bool, offset: bool) -> None:
        mat = np.asarray(mat, dtype=np.float64)
        vars = list(vars)
        n = 1 << len(vars)
        if diagonal:
            mat = mat.reshape(-1)
            if mat.shape[0] != n:
                raise ValueError(f"diagonal interaction needs 2^{len(vars)} entries")
        else:
            mat = mat.reshape(n, n) if mat.size == n * n else mat
            if mat.shape != (n, n):
                raise ValueError(f"interaction needs 2^{len(vars)} x 2^{len(vars)} entries")
        if offset:
            # Subtract the smallest diagonal entry and track it
            # (qmc_runner.rs:123-156, 440-559): E = -<n>/beta + offset.
            diag = mat if diagonal else np.diagonal(mat).copy()
            shift = float(np.min(diag))
            if diagonal:
                mat = mat - shift
            else:
                mat = mat.copy()
                np.fill_diagonal(mat, np.diagonal(mat) - shift)
            self.offset -= shift
        self._append(mat, vars)

    def _append(self, mat: np.ndarray, vars: list[int]) -> None:
        """Store a checked, shifted interaction and update the flags."""
        if np.any(mat < 0):
            raise ValueError("interaction weights must be non-negative")
        k = len(vars)
        if not sym_under_ising(mat, k):
            self.breaks_ising_symmetry = True
        if mat.ndim == 2 and k == 1 and np.all(np.abs(mat - mat.flat[0]) < 1e-12):
            self.has_cluster_edges = True
        self._interactions.append((mat, vars))
        self._model = None  # the tables are rebuilt on next use

    def make_interaction(self, mat, vars) -> None:
        self._add(mat, vars, diagonal=False, offset=False)

    def make_interaction_and_offset(self, mat, vars) -> None:
        self._add(mat, vars, diagonal=False, offset=True)

    def make_diagonal_interaction(self, mat, vars) -> None:
        self._add(mat, vars, diagonal=True, offset=False)

    def make_diagonal_interaction_and_offset(self, mat, vars) -> None:
        self._add(mat, vars, diagonal=True, offset=True)

    # -- compiled model ----------------------------------------------------

    @property
    def model(self) -> BondModel:
        if self._model is None:
            if not self._interactions:
                raise ValueError("no interactions added")
            self._model = generic_model(self.nvars, self._interactions, offset=self.offset,
                                        device=self.device)
        return self._model

    def _ensure_sse(self) -> SseState:
        if self._sse is None:
            self._sse = SseState(
                ops=_ops.empty_opstring(max(self.nvars, 8), self.replicas,
                                        self.model.max_legs, device=self.device),
                state=self._spins,
            )
        return self._sse

    # -- toggles (qmc_runner.rs:258-275) -----------------------------------

    def set_do_heatbath(self, do: bool) -> None:
        self._do_heatbath = bool(do)
        if do and self._hb is None:
            self._hb = make_heatbath_tables(self.model)

    def set_do_loop_updates(self, do: bool) -> None:
        self.do_loop_updates = bool(do)

    def should_do_cluster_update(self) -> bool:
        """``qmc_runner.rs:223-239``: clusters need edges and Ising symmetry."""
        return self.has_cluster_edges and not self.breaks_ising_symmetry

    def should_do_heatbath(self) -> bool:
        """``qmc_runner.rs:263-265``."""
        return self._do_heatbath

    def should_do_loop_update(self) -> bool:
        """``qmc_runner.rs:273-275``."""
        return self.do_loop_updates

    def _diag_args(self) -> dict:
        return dict(hb=self._hb if self._do_heatbath else None, heatbath=self._do_heatbath)

    # -- individual update moves (qmc_runner.rs:159-256) -------------------

    def diagonal_update(self, beta: float) -> None:
        """One diagonal sweep only (``qmc_runner.rs:159-203``)."""
        sse = self._ensure_sse()
        M, R = sse.ops.bond.shape
        ops = diagonal_update(sse.ops, sse.state, beta, self.draws.diagonal((3, M, R)),
                              self.model, **self._diag_args())
        self._sse = sse._replace(ops=ops)
        self._maybe_grow()

    def loop_update(self) -> None:
        """One directed-loop update only (``qmc_runner.rs:205-220``)."""
        sse = self._ensure_sse()
        ops, state, reverted = _loops.loop_update(sse.ops, sse.state, self.draws.loops(),
                                                  self.model, cap_hops=self._loop_cap)
        self._loop_reverts += reverted.sum()
        self.total_loop_updates += self.replicas
        self._sse = SseState(ops, state)

    def set_loop_cap(self, cap_hops: int | None) -> None:
        """Override the directed-loop walk cap (default ``4*K*M + 16``;
        walks that do not close revert and count in
        :attr:`total_loop_reverts`)."""
        self._loop_cap = cap_hops

    @property
    def total_loop_reverts(self) -> int:
        """Walks reverted at the cap so far, over all replicas (a host read)."""
        return int(self._loop_reverts)

    @total_loop_reverts.setter
    def total_loop_reverts(self, value: int) -> None:
        self._loop_reverts = torch.full((), int(value), dtype=torch.int64, device=self.device)

    def loop_revert_rate(self) -> float:
        """Fraction of directed-loop walks that hit the cap and reverted."""
        return self.total_loop_reverts / max(self.total_loop_updates, 1)

    def cluster_update(self) -> None:
        """One cluster update only; raises on models without cluster edges
        or without Ising symmetry (``qmc_runner.rs:223-239`` returns ``Err``
        there)."""
        if not self.should_do_cluster_update():
            raise ValueError("cluster update needs cluster-edge interactions and "
                             "Ising symmetry (qmc_runner.rs:223-239)")
        sse = self._ensure_sse()
        lc, ec = self._cluster_caps or (None, None)
        self._sse = SseState(*_cluster.cluster_update(sse.ops, sse.state, self.draws.cluster,
                                                      self.model, 0.5, lc, ec))

    def flip_free_bits(self) -> None:
        """Resample the spins that carry no op (``qmc_runner.rs:241-256``)."""
        sse = self._ensure_sse()
        self._sse = resample_free_spins(
            sse, self.draws.free_spins((self.replicas, self.nvars)), self.model)

    # -- stepping ----------------------------------------------------------

    def _multi_timestep(self, beta: float, nsweeps: int) -> torch.Tensor:
        """``nsweeps`` timesteps, then cutoff growth; returns the op counts
        ``i32[T, R]``."""
        sse = self._ensure_sse()
        self._sse, ns, reverts = generic_multi_sweep(
            sse, beta, self.model, nsweeps, lambda: self.draws,
            do_loops=self.do_loop_updates, do_cluster=self.should_do_cluster_update(),
            cluster_caps=self._cluster_caps, loop_cap=self._loop_cap, **self._diag_args(),
        )
        if self.do_loop_updates:
            self._loop_reverts += reverts.sum()
            self.total_loop_updates += self.replicas * nsweeps
        self._maybe_grow()
        return ns

    def timestep(self, beta: float) -> torch.Tensor:
        """One timestep; returns the state (``qmc_runner.rs:363-377``)."""
        self._multi_timestep(beta, 1)
        return self._sse.state

    def _maybe_grow(self) -> None:
        """Cutoff growth ``M = max(M, n + n/2)``, 16-quantized, and the
        cluster label caps, from one host read."""
        sse = self._ensure_sse()
        counts = [_ops.op_count(sse.ops).max()]
        if self.should_do_cluster_update():
            counts += cap_counts(sse.ops, self.model)
        n_max, *caps = (int(x) for x in torch.stack(counts).tolist())
        want = n_max + n_max // 2
        if want > sse.ops.cutoff:
            self._sse = sse._replace(ops=_ops.grow(sse.ops, ((want + 15) // 16) * 16))
        if caps:
            nc, nm = caps
            N = self.nvars
            want_l = max(256, 16 * ((int((nc + N + 2) * 1.3) + 15) // 16))
            want_e = max(256, 16 * ((int((nm + N + 2) * 1.3) + 15) // 16))
            cur = self._cluster_caps or (0, 0)
            if want_l > cur[0] or want_e > cur[1]:
                self._cluster_caps = (max(want_l, cur[0]), max(want_e, cur[1]))

    def timesteps(self, t: int, beta: float, chunk: int = 16) -> torch.Tensor:
        """Average energy per replica ``f32[R]`` over ``t`` timesteps
        (``qmc_stepper.rs:17``), ``chunk`` timesteps between host reads.

        From a cold cutoff it takes single timesteps (the reference grows
        after every timestep, ``qmc_ising.rs:786``) until two in a row stop
        growing, then chunks."""
        total_n = torch.zeros((self.replicas,), dtype=torch.float32, device=self.device)
        done = 0
        stable = 2 if not self._growth_pending else self._growth_stable
        while done < t:
            todo = 1 if stable < 2 else min(chunk, t - done)
            before = self.get_cutoff()
            ns = self._multi_timestep(beta, todo)
            stable = 0 if self.get_cutoff() != before else stable + 1
            total_n = total_n + ns.to(torch.float32).sum(dim=0)
            done += todo
        self._growth_stable = stable
        self._growth_pending = stable < 2
        return -((total_n / t) / beta) + self.model.offset

    def timesteps_sample(self, t: int, beta: float, sampling_freq: int | None = None):
        """Returns ``(states bool[num_samples, R, N], energy f32[R])``
        (``qmc_stepper.rs:23-40``)."""
        samples, energy = self.timesteps_measure(
            t, beta, [], lambda acc, s: (acc.append(s), acc)[1], sampling_freq)
        if not samples:
            return torch.zeros((0, self.replicas, self.nvars), dtype=torch.bool,
                               device=self.device), energy
        return torch.stack(samples), energy

    def timesteps_measure(self, t: int, beta: float, init_acc: Any,
                          state_fold: Callable[[Any, torch.Tensor], Any],
                          sampling_freq: int | None = None):
        """Fold ``state_fold(acc, state)`` over every ``sampling_freq``-th
        step's state and average their op counts (``qmc_stepper.rs:133-162``).
        Returns ``(acc, energy f32[R])``."""
        freq = sampling_freq or 1
        acc = init_acc
        total_n = torch.zeros((self.replicas,), dtype=torch.float32, device=self.device)
        measured = 0
        for i in range(t):
            self.timestep(beta)
            if (i + 1) % freq == 0:
                acc = state_fold(acc, self._sse.state)
                total_n = total_n + _ops.op_count(self._sse.ops)
                measured += 1
        return acc, -((total_n / max(measured, 1)) / beta) + self.model.offset

    def timesteps_sample_iter(self, t: int, beta: float, sampling_freq,
                              iter_fn: Callable[[torch.Tensor], None]) -> torch.Tensor:
        """``iter_fn(state)`` on every sample (``qmc_stepper.rs:43-73``);
        returns the average energy per replica."""
        _, energy = self.timesteps_measure(
            t, beta, None, lambda acc, s: (iter_fn(s), acc)[1], sampling_freq)
        return energy

    def timesteps_sample_iter_zip(self, t: int, beta: float, sampling_freq, zip_with,
                                  iter_fn: Callable[[Any, torch.Tensor], None]) -> torch.Tensor:
        """``iter_fn(next(zip_with), state)`` per sample until the iterable
        runs out (``qmc_stepper.rs:97-130``)."""
        it = iter(zip_with)

        def fold(acc, s):
            try:
                z = next(it)
            except StopIteration:
                return acc
            iter_fn(z, s)
            return acc

        _, energy = self.timesteps_measure(t, beta, None, fold, sampling_freq)
        return energy

    def imaginary_time_fold(self, fold_fn, init):
        """Fold ``fold_fn(acc, state_at_p)`` over all ``M`` propagated
        states (``qmc_stepper.rs:165-167``)."""
        sse = self._ensure_sse()
        return _ops.itime_fold(sse.ops, sse.state, self.model, fold_fn, init)

    # -- manager/state swap (qmc_runner.rs:319-341) ------------------------

    def can_swap_managers(self, other: "Qmc") -> bool:
        return (self.nvars == other.nvars and self.replicas == other.replicas
                and self.model.nbonds == other.model.nbonds)

    def swap_manager_and_state(self, other: "Qmc") -> None:
        if not self.can_swap_managers(other):
            raise ValueError("Qmc instances of different shapes cannot swap managers")
        self._sse, other._sse = other._ensure_sse(), self._ensure_sse()

    def increase_cutoff_to(self, cutoff: int) -> None:
        """Grow the op-string capacity (``qmc_runner.rs:306-312``)."""
        self.set_cutoff(cutoff)

    # -- autocorrelations (qmc_runner.rs:736-751) --------------------------

    def calculate_bond_autocorrelation(self, t: int, beta: float,
                                       sampling_freq: int | None = None) -> np.ndarray:
        """Autocorrelation of every non-constant interaction's diagonal
        matrix element over sampled states (``QmcBondAutoCorrelations``,
        ``qmc_runner.rs:736-751``)."""
        states, _ = self.timesteps_sample(t, beta, sampling_freq)  # bool[T, R, N]
        m = self.model
        b_ids = torch.nonzero(~m.is_constant)[:, 0]
        vars_b = m.bond_vars[b_ids].long()  # [B, K]
        bits = torch.where(vars_b >= 0, states[..., vars_b.clamp(min=0)], False)
        legs = torch.arange(m.max_legs, device=states.device)
        si = (bits.long() << legs).sum(dim=-1)  # [T, R, B]
        return _ac.fft_autocorrelation(m.diag_w[b_ids, si]).cpu().numpy()

    # -- accessors ---------------------------------------------------------

    def get_n(self) -> torch.Tensor:
        """Op count per replica ``i32[R]``."""
        return _ops.op_count(self._ensure_sse().ops)

    def get_bonds(self) -> list[Interaction]:
        """The added interactions (``qmc_runner.rs:108-110``)."""
        return [Interaction(m, v) for m, v in self._interactions]

    def get_manager_ref(self) -> _ops.OpString:
        """The op string, the reference's op manager (``qmc_runner.rs:294-296``)."""
        return self._ensure_sse().ops

    def get_offset(self) -> float:
        """Accumulated diagonal offset (``qmc_runner.rs:289-291``)."""
        return self.offset

    def get_cutoff(self) -> int:
        """``qmc_runner.rs:299-301``."""
        return self._ensure_sse().ops.cutoff

    def set_cutoff(self, cutoff: int) -> None:
        """Grow the op-string capacity (``qmc_runner.rs:304-308``; shrinking
        is a no-op, since slots above the old cutoff are identities)."""
        sse = self._ensure_sse()
        self._sse = sse._replace(ops=_ops.grow(sse.ops, cutoff))

    def clone_state(self) -> np.ndarray:
        """A host copy of the p=0 state ``bool[R, N]`` (``qmc_runner.rs:344-346``)."""
        return self._ensure_sse().state.cpu().numpy().copy()

    def into_vec(self) -> np.ndarray:
        """The p=0 state as a host array (``qmc_runner.rs:284-286``)."""
        return self.clone_state()

    def state_ref(self) -> torch.Tensor:
        return self._ensure_sse().state

    def get_bond_count(self, bond: int) -> torch.Tensor:
        """Ops at ``bond`` per replica, ``i32[R]``."""
        return _ops.bond_counts(self._ensure_sse().ops, self.model.nbonds)[:, bond]

    def save(self, path: str, *, strip_rng: bool = False) -> None:
        """Write a checkpoint in the JAX package's ``.npz`` layout
        (:mod:`isingmontecarlo_tpu_torch.checkpoint`)."""
        from isingmontecarlo_tpu_torch import checkpoint as _ckpt

        _ckpt.save_qmc(path, self, strip_rng=strip_rng)

    @classmethod
    def load(cls, path: str, *, seed: int | None = None,
             device: torch.device | str = "cuda") -> "Qmc":
        """A ``Qmc`` from :meth:`save`'s file or the JAX package's; ``seed``
        reseeds the generator."""
        from isingmontecarlo_tpu_torch import checkpoint as _ckpt

        return _ckpt.load_qmc(path, seed=seed, device=device)

    def verify(self) -> bool:
        """Worldline integrity of every replica."""
        sse = self._ensure_sse()
        return bool(_ops.verify(sse.ops, sse.state, self.model).all())
