"""Parallel tempering (port of ``isingmontecarlo_tpu/parallel/tempering.py``;
reference ``src/sse/parallel_tempering/``).

The replicas are the batch axis ``R`` of one :class:`QmcIsingGraph`, each
with its own parameter *label*: an inverse temperature ``beta[R]``,
per-bond Hamiltonian multipliers ``scales[R, NB]`` (heterogeneous ladders:
per-class transverse, coupling and longitudinal scales, or per-bond
coupling disorder through :meth:`TemperingContainer.add_qmc_stepper`) and,
for couplings of mixed sign, per-bond substate-XOR masks ``xors[R, NB]``
(``diagonal.py``, "sign patterns"). A replica exchange swaps labels, not
op strings: the states have one fixed shape, so exchanging labels is the
same move at O(R) cost. Neighbour pairs are adjacent ranks in beta-sorted
order, with the acceptance

``log p = (n_b - n_a) log(beta_a / beta_b)
          + sum_bond (count_b - count_a) log(c_a / c_b)``

from the per-bond op counts (the reference's Ising ``relative_weight``,
``tempering_traits.rs:117-155``), or for signed ladders the op-resolved
:func:`~isingmontecarlo_tpu_torch.sse.opstring.log_weight_delta` (the
reference's ``OpWeights`` op walk, ``tempering_traits.rs:163-196``).

A sweep runs every replica at its own label through the kernels of the
SSE timestep (K2, K3 or K3-hb, K4); the swap is plain PyTorch on ``[R]``
vectors, and :func:`tempering_sweep_chunk` keeps the acceptance, the label
permutation, the parity and the swap count on the device, read once a
chunk.

Sharded (:meth:`TemperingContainer.shard_over`,
:func:`tempering_sweep_chunk_sharded`): the replica axis splits into
contiguous blocks over the ranks of a ``torch.distributed`` process group,
one process a card (the reference's rayon pool, ``tempering_container.rs:
315-478``). Sweeps stay rank-local; a swap all-gathers only the label
vectors (``n[R]`` and ``betas[R]``; the ``[R, NB]`` label tables, bond
counts and heat-bath rows where the ladder needs them; on signed ladders
the per-replica deltas), every rank computes the same permutation from
one replicated swap stream, and keeps its own block of it.
"""

from __future__ import annotations

import functools
import os
from typing import Callable, NamedTuple, Sequence

import numpy as np
import torch
import torch.distributed as dist

from isingmontecarlo_tpu_torch import profiling
from isingmontecarlo_tpu_torch.analysis import autocorr as _ac
from isingmontecarlo_tpu_torch.lattice import edge_arrays
from isingmontecarlo_tpu_torch.parallel import _dist
from isingmontecarlo_tpu_torch.sse import opstring as _ops
from isingmontecarlo_tpu_torch.sse.diagonal import HeatBathTables, make_heatbath_tables
from isingmontecarlo_tpu_torch.sse.ising import (
    Draws, GeneratorDraws, QmcIsingGraph, SseState, multi_sweep, sweep,
)
from isingmontecarlo_tpu_torch.sse.model import BondModel

_TINY = 1e-30


def new_with_rng(seed: int = 0, device: torch.device | str = "cuda") -> "TemperingContainer":
    """Empty container for incremental filling (``new_with_rng``,
    ``tempering_container.rs:36-39``)."""
    return TemperingContainer.new(seed, device=device)


def new_thread_rng(device: torch.device | str = "cuda") -> "TemperingContainer":
    """Empty container seeded from the OS's entropy (``new_thread_rng``,
    ``tempering_container.rs:41-44``)."""
    return TemperingContainer.new(int.from_bytes(os.urandom(4), "little"), device=device)


def _canonical_edge_map(edges) -> dict:
    """``(min(a, b), max(a, b)) -> J``, so that edge sets compare whatever
    their listing order."""
    m = {}
    for (a, b), j in edges:
        k = (min(a, b), max(a, b))
        if k in m:
            raise ValueError(f"duplicate edge {k}")
        m[k] = float(j)
    return m


def _ratio(a: float, b: float, what: str) -> float:
    if abs(a) < 1e-12 and abs(b) < 1e-12:
        return 1.0
    if abs(a) < 1e-12 or abs(b) < 1e-12 or (a > 0) != (b > 0):
        raise ValueError(
            f"no positive weight ratio for {what}: {a} vs {b} — a label swap "
            "cannot represent a sign flip (weight-table zeros move); use "
            "opstring.log_relative_weight + swap_manager_and_state instead"
        )
    return b / a


def _ratio_signed(a: float, b: float, what: str) -> tuple[float, int]:
    """(positive magnitude ratio, substate-XOR mask) such that the weight
    table under ``b`` is ``scale * base_table[:, s ^ mask]``: a sign flip of
    an Ising two-site or longitudinal bond swaps its aligned and
    anti-aligned columns (``qmc_ising.rs:863-888``), which ``mask = 1``
    represents exactly. Zero against nonzero stays unrepresentable."""
    if abs(a) < 1e-12 and abs(b) < 1e-12:
        return 1.0, 0
    if abs(a) < 1e-12 or abs(b) < 1e-12:
        raise ValueError(
            f"no weight correspondence for {what}: {a} vs {b} — zero and "
            "nonzero couplings have different weight-table supports"
        )
    return abs(b / a), 0 if (a > 0) == (b > 0) else 1


def _relative_bond_params(base, q) -> tuple[np.ndarray, np.ndarray]:
    """Per-bond (positive multiplier ``f32[NB]``, substate-XOR mask
    ``i32[NB]``) of ``q`` relative to ``base``: ``w_q(b, s) = scale[b] *
    w_base(b, s ^ xor[b])`` exactly (:func:`_ratio_signed`). A transverse
    sign flip stays an error: that table is the same for every substate
    (``qmc_ising.rs:869-877``), so no permutation represents it."""
    mb = _canonical_edge_map(base.edges)
    mq = _canonical_edge_map(q.edges)
    if set(mb) != set(mq):
        raise ValueError("graphs must share the edge set")
    ne = len(base.edges)
    n = base.nvars
    nb = base.model.nbonds
    scale = np.ones(nb, np.float32)
    xor = np.zeros(nb, np.int32)
    for i, ((a, b), jb) in enumerate(base.edges):
        k = (min(a, b), max(a, b))
        scale[i], xor[i] = _ratio_signed(jb, mq[k], f"edge {k} coupling")
    scale[ne:ne + n] = _ratio(base.transverse, q.transverse, "transverse field")
    if nb > ne + n:
        scale[ne + n:], xor[ne + n:] = _ratio_signed(
            base.longitudinal, q.longitudinal, "longitudinal field")
    elif abs(base.longitudinal - q.longitudinal) > 1e-12:
        raise ValueError("longitudinal fields differ but base has no h bonds")
    return scale, xor


def tfim_bond_classes(nedges: int, nvars: int, nbonds: int) -> np.ndarray:
    """``i32[NB]`` class of each bond of the TFIM layout: 0 two-site, 1
    transverse, 2 longitudinal."""
    cls = np.full(nbonds, 2, np.int32)
    cls[:nedges] = 0
    cls[nedges:nedges + nvars] = 1
    return cls


def _pair_starts(rank: torch.Tensor, parity, R: int) -> torch.Tensor:
    """Ranks that start a pair in one alternating-parity neighbour-swap
    sweep (``swap_on_chunks``, ``tempering_container.rs:274-302``)."""
    return ((rank - parity) % 2 == 0) & (rank >= parity) & (rank + 1 < R)


def candidate_partner(betas: torch.Tensor, parity) -> torch.Tensor:
    """``i32[R]``: the replica whose labels replica ``r`` takes if its pair
    accepts (itself where unpaired). The pairing follows from the rank
    parity alone, before any draw."""
    R = betas.shape[0]
    order = torch.argsort(betas, stable=True)
    rank = torch.arange(R, device=betas.device)
    is_start = _pair_starts(rank, parity, R)
    is_prev = torch.roll(is_start, 1) & (rank > 0)
    cand_rank = torch.where(is_start, rank + 1, torch.where(is_prev, rank - 1, rank))
    out = torch.empty_like(order)
    out[order] = order[cand_rank]
    return out.to(torch.int32)


def tempering_step(n: torch.Tensor, betas: torch.Tensor, u: torch.Tensor, parity,
                   n_class: torch.Tensor | None = None, log_c: torch.Tensor | None = None,
                   ops: _ops.OpString | None = None, model: BondModel | None = None,
                   scales: torch.Tensor | None = None, xors: torch.Tensor | None = None,
                   delta: torch.Tensor | None = None, blocked: torch.Tensor | None = None):
    """One neighbour-swap sweep on the swap uniforms ``u f32[R]``. Returns
    ``(perm i32[R], n_swaps i32[])``, both on the device: ``perm[r]`` is the
    replica whose labels replica ``r`` takes (itself where no swap), as
    ``swap_on_chunks`` (``tempering_container.rs:274-302``). ``parity`` (an
    int or an ``i32[]`` tensor) 0 pairs ranks (0, 1), (2, 3), ...; 1 pairs
    (1, 2), (3, 4), .... ``n i32[R]`` are the op counts; ``n_class`` and
    ``log_c`` (``[R, NB]``) add the per-bond count term.

    Signed ladders pass ``ops``, ``model``, ``scales`` and ``xors`` instead:
    every op is weighed under its own and its candidate partner's label
    (:func:`~isingmontecarlo_tpu_torch.sse.opstring.log_weight_delta`,
    which includes the scale term), and a pair whose strings have zero
    weight under the exchanged labels is refused. ``delta f32[R]`` and
    ``blocked bool[R]`` pass those per-replica terms in precomputed (the
    sharded chunk computes them on each rank and gathers them)."""
    R = betas.shape[0]
    order = torch.argsort(betas, stable=True)  # ascending beta, rank -> replica
    b_sorted = betas[order]
    n_sorted = n[order].to(torch.float32)
    rank = torch.arange(R, device=betas.device)
    is_start = _pair_starts(rank, parity, R)
    b_next = torch.roll(b_sorted, -1)
    n_next = torch.roll(n_sorted, -1)
    # log p at pair-start ranks: (n_b - n_a)(log beta_a - log beta_b)
    logp = (n_next - n_sorted) * (torch.log(b_sorted.clamp(min=_TINY))
                                  - torch.log(b_next.clamp(min=_TINY)))
    if n_class is not None:
        nc_sorted = n_class[order].to(torch.float32)  # [R, C]
        lc_sorted = log_c[order]
        nc_next = torch.roll(nc_sorted, -1, dims=0)
        lc_next = torch.roll(lc_sorted, -1, dims=0)
        logp = logp + ((nc_next - nc_sorted) * (lc_sorted - lc_next)).sum(dim=1)
    blocked_pair = torch.zeros((R,), dtype=torch.bool, device=betas.device)
    if xors is not None and delta is None:
        # The pairing is fixed before any draw, so every replica weighs its
        # string under its candidate partner's label.
        cpart = candidate_partner(betas, parity).long()
        delta, blocked = _ops.log_weight_delta(ops, model, scales, xors,
                                               scales[cpart], xors[cpart])
    if delta is not None:
        if blocked is None:
            blocked = torch.zeros((R,), dtype=torch.bool, device=betas.device)
        d_sorted = delta[order]
        blk_sorted = blocked[order]
        logp = logp + d_sorted + torch.roll(d_sorted, -1)
        blocked_pair = blk_sorted | torch.roll(blk_sorted, -1)
    accept_start = is_start & ~blocked_pair & (torch.log(u.clamp(min=_TINY)) < logp)
    accept_from_prev = torch.roll(accept_start, 1) & (rank > 0)
    partner_rank = torch.where(accept_start, rank + 1,
                               torch.where(accept_from_prev, rank - 1, rank))
    # Replica order[rank] takes the labels of replica order[partner_rank].
    perm = torch.empty_like(order)
    perm[order] = order[partner_rank]
    return perm.to(torch.int32), accept_start.sum(dtype=torch.int32)


def swap_qmc_steppers(g_a: QmcIsingGraph, beta_a: float, g_b: QmcIsingGraph, beta_b: float,
                      u: torch.Tensor) -> int:
    """Metropolis swap attempt between two :class:`QmcIsingGraph` ensembles
    of any two Hamiltonians (the ``OpWeights`` fallback for pairs with no
    label representation, ``tempering_traits.rs:163-196``): per replica
    lane, ``log p = (n_b - n_a) log(beta_a / beta_b) + log W(a's string |
    H_b) / W(a's string | H_a) + log W(b's string | H_a) / W(b's string |
    H_b)``; accepted lanes exchange op strings and states in place, on the
    uniforms ``u f32[R]``. Returns the number of swapped replicas (one host
    read)."""
    if not g_a.can_swap_managers(g_b):
        raise ValueError("graph shapes do not match")
    m = max(g_a.cutoff, g_b.cutoff)
    g_a.set_cutoff(m)
    g_b.set_cutoff(m)
    ops_a, ops_b = g_a.sse.ops, g_b.sse.ops
    n_a = _ops.op_count(ops_a).to(torch.float32)
    n_b = _ops.op_count(ops_b).to(torch.float32)
    lw_ab, z_ab = _ops.log_relative_weight(ops_a, g_a.model, g_b.model)
    lw_ba, z_ba = _ops.log_relative_weight(ops_b, g_b.model, g_a.model)
    logp = ((n_b - n_a) * float(np.log(max(beta_a, _TINY)) - np.log(max(beta_b, _TINY)))
            + lw_ab + lw_ba)
    acc = ~z_ab & ~z_ba & (torch.log(u.clamp(min=_TINY)) < logp)

    def mix(a, b, lane_axis):
        shape = [1] * a.dim()
        shape[lane_axis] = a.shape[lane_axis]
        msk = acc.reshape(shape)
        return torch.where(msk, b, a), torch.where(msk, a, b)

    bond_a, bond_b = mix(ops_a.bond, ops_b.bond, 1)
    in_a, in_b = mix(ops_a.inputs, ops_b.inputs, 2)
    out_a, out_b = mix(ops_a.outputs, ops_b.outputs, 2)
    st_a, st_b = mix(g_a.sse.state, g_b.sse.state, 0)
    g_a.sse = SseState(_ops.OpString(bond_a, in_a, out_a), st_a)
    g_b.sse = SseState(_ops.OpString(bond_b, in_b, out_b), st_b)
    return int(acc.sum())


def _local(x: torch.Tensor) -> torch.Tensor:
    return x


def _swap_labels(sse: SseState, model: BondModel, betas: torch.Tensor,
                 scales: torch.Tensor, xors: torch.Tensor | None,
                 hb: HeatBathTables | None, hetero: bool, u: torch.Tensor, parity,
                 gather: Callable[[torch.Tensor], torch.Tensor] = _local, lo: int = 0):
    """One neighbour-swap sweep of the labels on uniforms ``u f32[R]``: the
    op-resolved acceptance on a signed ladder (each string weighed under
    its candidate partner's label), the per-bond count term on a
    heterogeneous one. Returns the permuted ``(betas, scales, xors, hb)``
    (per-replica heat-bath tables follow their labels), the swap count
    ``i32[]`` and the permutation ``i32[R]``.

    Sharded (``isingmontecarlo_tpu/parallel/tempering.py:477-522``), the
    arguments are a rank's block ``[lo, lo + R_l)`` and ``gather``
    all-gathers such blocks: the label vectors cross ranks (``n`` and
    ``betas`` always, ``scales`` on heterogeneous or signed ladders, ``xors``
    on signed ones, the bond counts on heterogeneous ones, per-replica
    heat-bath tables where there are any; a signed ladder's strings are
    weighed on their own rank and only ``(delta, blocked)`` cross), every
    rank computes the permutation of all ``R`` replicas from the same
    ``u``, and keeps its block."""
    with profiling.span("pt.swap"):
        R_l = betas.shape[0]
        signed = xors is not None
        n_g = gather(_ops.op_count(sse.ops))
        betas_g = gather(betas)
        scales_g = gather(scales) if hetero or signed else None
        xors_g = gather(xors) if signed else None
        if signed:
            cpart = candidate_partner(betas_g, parity)[lo:lo + R_l].long()
            delta, blocked = _ops.log_weight_delta(sse.ops, model, scales, xors, scales_g[cpart],
                                                   xors_g[cpart])
            perm, nsw = tempering_step(n_g, betas_g, u, parity, delta=gather(delta),
                                       blocked=gather(blocked))
        elif hetero:
            perm, nsw = tempering_step(n_g, betas_g, u, parity,
                                       gather(_ops.bond_counts(sse.ops, model.nbonds)),
                                       torch.log(scales_g.clamp(min=_TINY)))
        else:
            perm, nsw = tempering_step(n_g, betas_g, u, parity)
        take = perm[lo:lo + R_l].long()
        if hetero or signed:
            scales = scales_g[take]
        if signed:
            xors = xors_g[take]
        if hb is not None and hb.cum_max_w.dim() == 2:
            hb = HeatBathTables(cum_max_w=gather(hb.cum_max_w)[take], total=gather(hb.total)[take])
        return betas_g[take], scales, xors, hb, nsw, perm


def _sweep_chunk(sse, betas, scales, parity, do_swap, model, nsweeps, next_draws, hb, heatbath,
                 hetero, collect_states, cluster_caps, xors, gather=_local, lo=0, world=1,
                 rep_check=False):
    """The loop of :func:`tempering_sweep_chunk` and, with ``gather``,
    ``lo`` and ``world`` of a rank's block, of
    :func:`tempering_sweep_chunk_sharded`; ``rep_check`` also sums
    position-weighted swap uniforms and permutations ``f64[2]``."""
    R = betas.shape[0] * world
    dev = betas.device
    parity = torch.as_tensor(parity, dtype=torch.int32, device=dev)
    nswaps = torch.zeros((), dtype=torch.int32, device=dev)
    sums = torch.zeros(2, dtype=torch.float64, device=dev)
    weight = torch.arange(1, R + 1, dtype=torch.float64, device=dev) if rep_check else None
    ns, states, betas_t = [], [], []
    for t in range(nsweeps):
        draws = next_draws()
        sse, _ = sweep(sse, betas, model, draws, cluster_caps=cluster_caps, hb=hb,
                       heatbath=heatbath, bond_scale=scales if hetero else None,
                       bond_xor=xors)
        if do_swap[t]:
            u = draws.swap((R,))
            betas, scales, xors, hb, nsw, perm = _swap_labels(
                sse, model, betas, scales, xors, hb, hetero, u, parity, gather, lo)
            parity = 1 - parity
            nswaps = nswaps + nsw
            if rep_check:
                sums = sums + torch.stack([(u.double() * weight).sum(),
                                           (perm.double() * weight).sum()])
        ns.append(_ops.op_count(sse.ops))
        if collect_states:
            states.append(sse.state)
            betas_t.append(betas)
    return (sse, betas, scales, xors, hb, parity, nswaps, torch.stack(ns),
            torch.stack(states) if collect_states else None,
            torch.stack(betas_t) if collect_states else None), sums


def tempering_sweep_chunk(sse: SseState, betas: torch.Tensor, scales: torch.Tensor, parity,
                          do_swap: Sequence[bool], model: BondModel, nsweeps: int,
                          next_draws: Callable[[], Draws],
                          hb: HeatBathTables | None = None, heatbath: bool = False,
                          hetero: bool = False, collect_states: bool = False,
                          cluster_caps: tuple[int, int] | None = None,
                          xors: torch.Tensor | None = None):
    """``nsweeps`` tempering steps: each runs one timestep of every replica
    at its own label (``next_draws()`` gives its draws), then, where
    ``do_swap[t]``, a neighbour swap on that timestep's ``swap`` uniforms
    that permutes ``betas``, and for heterogeneous ladders ``scales`` and
    the per-replica heat-bath tables, and for signed ladders the sign
    patterns ``xors`` (the reference's run/swap loop,
    ``tempering_container.rs:411-478``). The acceptance, the labels, the
    ``parity`` and the swap count stay on the device: the loop reads nothing
    back to the host itself.

    Returns ``(sse, betas, scales, xors, hb, parity i32[], nswaps i32[],
    ns i32[T, R], states bool[T, R, N] or None, betas_t f32[T, R] or
    None)``, the last two the per-sweep samples when ``collect_states``."""
    return _sweep_chunk(sse, betas, scales, parity, do_swap, model, nsweeps, next_draws, hb,
                        heatbath, hetero, collect_states, cluster_caps, xors)[0]


class ShardDraws:
    """The draws of one rank of a sharded ladder: the timestep's draws from
    the rank's own generator (``sweep``), the swap uniforms ``f32[R]`` from a
    generator seeded alike on every rank (``swap``), so that every rank
    draws the same global vector and computes the same permutation. The
    port's form of the JAX chunk's key folds
    (``isingmontecarlo_tpu/parallel/tempering.py:467-469``); like theirs, the
    stream depends on the number of ranks."""

    def __init__(self, sweep: Draws, swap: Draws):
        self.sweep = sweep
        self.swap_draws = swap

    def diagonal(self, shape):
        return self.sweep.diagonal(shape)

    def cluster(self, shape):
        return self.sweep.cluster(shape)

    def free_spins(self, shape):
        return self.sweep.free_spins(shape)

    def rvb(self, n_updates):
        return self.sweep.rvb(n_updates)

    def loops(self):
        return self.sweep.loops()

    def swap(self, shape):
        return self.swap_draws.swap(shape)


class BlockDraws:
    """The draws of one unsharded run of ``R`` replicas, cut to the block
    ``[lo, lo + R_l)`` of one rank: each call draws the whole ``R``-replica
    shape from ``generator`` and keeps the block's columns (diagonal and
    cluster uniforms) or rows (free spins), and the swap uniforms whole.
    Ranks whose generators are seeded alike then see what one unsharded
    run on that generator draws, which holds a sharded chunk equal to
    :func:`tempering_sweep_chunk` on the same uniforms, where the cluster
    shapes do not depend on the block (no cluster caps)."""

    def __init__(self, generator: torch.Generator, lo: int, R_l: int, R: int):
        self.draws = GeneratorDraws(generator)
        self.cols = slice(lo, lo + R_l)
        self.R = R

    def diagonal(self, shape):
        return self.draws.diagonal((*shape[:-1], self.R))[..., self.cols].contiguous()

    def cluster(self, shape):
        return self.draws.cluster((shape[0], self.R))[:, self.cols].contiguous()

    def free_spins(self, shape):
        return self.draws.free_spins((self.R, shape[1]))[self.cols].contiguous()

    def swap(self, shape):
        return self.draws.swap(shape)


def tempering_sweep_chunk_sharded(sse: SseState, betas: torch.Tensor, scales: torch.Tensor,
                                  parity, do_swap: Sequence[bool], model: BondModel,
                                  nsweeps: int, next_draws: Callable[[], Draws], *, group=None,
                                  hb: HeatBathTables | None = None, heatbath: bool = False,
                                  hetero: bool = False, collect_states: bool = False,
                                  cluster_caps: tuple[int, int] | None = None,
                                  xors: torch.Tensor | None = None,
                                  debug_rep_check: bool = False):
    """:func:`tempering_sweep_chunk` on this rank's block of the replicas,
    over the ranks of ``group`` (the world group when None); the JAX
    package's ``shard_map`` chunk (``isingmontecarlo_tpu/parallel/
    tempering.py:434-656``). The arguments are the rank's shards (``sse``
    ``[M, R_l]``, ``betas [R_l]``, ...) with ``R = R_l x world`` replicas
    in all, rank ``k`` holding ``[k R_l, (k + 1) R_l)``. Sweeps are
    rank-local; a swap crosses ranks only with label vectors
    (:func:`_swap_labels`), on ``next_draws()``'s ``swap((R,))``
    uniforms, which must be the same on every rank (:class:`ShardDraws`)
    while the sweeps' draws differ. ``do_swap`` is a host list and must be
    equal on every rank; nothing inside the chunk reads the host.

    Returns the rank's ``(sse, betas, scales, xors, hb, parity i32[],
    nswaps i32[], ns i32[T, R_l], states bool[T, R_l, N] or None, betas_t
    f32[T, R_l] or None)``; with ``debug_rep_check`` also every rank's
    fingerprint of what it computed redundantly ``f64[world, 4]``: the swap
    count, the parity, and position-weighted sums of the swap uniforms and
    of the permutations; its rows are equal where the ranks agree."""
    _dist.require_group()
    world = dist.get_world_size(group)
    out, sums = _sweep_chunk(
        sse, betas, scales, parity, do_swap, model, nsweeps, next_draws, hb, heatbath, hetero,
        collect_states, cluster_caps, xors, gather=lambda x: _dist.all_gather(x, group),
        lo=dist.get_rank(group) * betas.shape[0], world=world, rep_check=debug_rep_check)
    if debug_rep_check:
        nswaps, parity = out[6], out[5]
        mine = torch.cat([torch.stack([nswaps, parity]).double(), sums])
        out = out + (_dist.all_gather(mine[None], group, tag="fingerprint"),)
    return out


class _Shard(NamedTuple):
    """Where a sharded container's block sits: its process ``group``,
    ``world`` size, ``rank``, the global replica count and the rank's
    draws (its own sweep stream, the replicated swap stream)."""

    group: object
    world: int
    rank: int
    replicas: int
    draws: ShardDraws

    @property
    def lo(self) -> int:
        """The rank's first replica."""
        return self.rank * (self.replicas // self.world)

    def gather(self, x: torch.Tensor, dim: int = 0, tag: str = "swap") -> torch.Tensor:
        return _dist.all_gather(x, self.group, dim, tag)


class TemperingContainer:
    """Parallel tempering over a batched :class:`QmcIsingGraph` on one
    device (``TemperingContainer`` / ``ParallelQmcTimeSteps``,
    ``tempering_container.rs:53-238, 315-478``): all replicas advance
    together, neighbour swaps alternate parity, and sampled states can be
    grouped by temperature.

    Heterogeneous ladders: per-beta ``transverse_scales``,
    ``coupling_scales`` or ``longitudinal_scales`` temper in field or
    coupling space too; a swap then exchanges the whole label. Signed
    ladders (couplings of mixed sign) come from :meth:`add_qmc_stepper`.
    Every replica lives on ``device`` (the card by default).

    :meth:`shard_over` splits the replicas over the ranks of a process
    group: every rank builds the same container, then keeps its block, and
    the drivers take the sharded path. Attributes (``graph``, ``betas``,
    ``scales``, ``xors``) then hold the rank's block; what the JAX package
    returns as a global array (``timesteps_sample``'s samples,
    ``states_by_temperature``, ``class_scales``, ``verify``) comes back
    global on every rank."""

    def __init__(self, edges, transverse: float, longitudinal: float = 0.0, *,
                 betas: Sequence[float], replicas_per_beta: int = 1, seed: int = 0,
                 transverse_scales: Sequence[float] | None = None,
                 coupling_scales: Sequence[float] | None = None,
                 longitudinal_scales: Sequence[float] | None = None,
                 device: torch.device | str = "cuda"):
        betas = np.asarray(betas, dtype=np.float32)
        R = len(betas) * replicas_per_beta
        self.device = torch.device(device)
        self.graph = QmcIsingGraph(edges, transverse, longitudinal, replicas=R, seed=seed,
                                   device=self.device)
        self.betas = torch.from_numpy(np.repeat(betas, replicas_per_beta)).to(self.device)

        def expand(x):
            if x is None:
                return None
            x = np.asarray(x, np.float32)
            if x.shape != betas.shape:
                raise ValueError("one scale per beta")
            return np.repeat(x, replicas_per_beta)

        ts, cs, ls = (expand(x) for x in (transverse_scales, coupling_scales,
                                          longitudinal_scales))
        self.hetero = any(s is not None for s in (ts, cs, ls))
        ones = np.ones(R, np.float32)
        # [R, 3]: class 0 two-site, 1 transverse, 2 longitudinal.
        per_class = np.stack([x if x is not None else ones for x in (cs, ts, ls)], axis=1)
        m = self.graph.model
        cls = tfim_bond_classes(len(self.graph.edges), m.nvars, m.nbonds)
        # Per-bond multipliers [R, NB]; per-bond disorder enters through
        # add_qmc_stepper.
        self.scales = torch.from_numpy(per_class[:, cls]).to(self.device)
        self.xors: torch.Tensor | None = None  # i32[R, NB] sign patterns
        self._seed = int(seed)
        self._parity = 0
        self.total_swaps = 0
        self._heatbath = False
        self._hb: HeatBathTables | None = None
        self._pending = None  # graphs added to a new() container
        self._shard: _Shard | None = None  # set by shard_over
        # Every rank's sweep generator state and the swap generator's, set
        # by checkpoint.load_tempering from a sharded container's file and
        # restored by shard_over.
        self._resume_rng: tuple | None = None

    # -- incremental construction (tempering_container.rs:53-74) ------------

    @classmethod
    def new(cls, seed: int = 0, device: torch.device | str = "cuda") -> "TemperingContainer":
        """An empty container to fill with :meth:`add_qmc_stepper`
        (``TemperingContainer::new``, ``tempering_container.rs:53-61``)."""
        self = object.__new__(cls)
        self._pending = []
        self._seed = int(seed)
        self.device = torch.device(device)
        self.graph = None
        self.betas = None
        self.scales = None
        self.hetero = False
        self.xors = None
        self._parity = 0
        self.total_swaps = 0
        self._heatbath = False
        self._hb = None
        self._shard = None
        self._resume_rng = None
        return self

    def add_qmc_stepper(self, q: QmcIsingGraph, beta: float) -> None:
        """Append a graph at inverse temperature ``beta`` (``add_qmc_stepper``,
        ``tempering_container.rs:65-74``). Raises ``ValueError`` where the
        reference returns ``Err``: other shapes, other edge sets, zero
        against nonzero couplings. Same-sign per-bond disorder becomes
        per-bond multipliers (``tempering_traits.rs:117-155``), couplings of
        mixed sign substate-XOR labels with the op-resolved swap
        (``tempering_traits.rs:163-196``)."""
        if self._pending is None or self.graph is not None:
            raise ValueError("container already materialized; add graphs first")
        if self._pending:
            base = self._pending[0][0]
            if q.nvars != base.nvars or q.model.nbonds != base.model.nbonds:
                raise ValueError("graph shapes do not match the ladder")
            _relative_bond_params(base, q)  # raises when not representable
        self._pending.append((q, float(beta)))

    def _finalize(self) -> None:
        """Join the graphs of :meth:`add_qmc_stepper` into one batch: states
        stacked, op strings grown to the largest cutoff and concatenated
        along R (the reference syncs cutoffs before swapping,
        ``tempering_container.rs:129-137``)."""
        if self._pending is None:
            return
        if not self._pending:
            raise ValueError("no graphs added to the tempering container")
        pend, self._pending = self._pending, None
        dev = self.device
        base = pend[0][0]
        R = sum(q.replicas for q, _ in pend)
        max_m = max(q.cutoff for q, _ in pend)
        state = torch.cat([q.sse.state.to(dev) for q, _ in pend])
        g = QmcIsingGraph(base.edges, base.transverse, base.longitudinal, max_m, replicas=R,
                          seed=self._seed, state=state, device=dev)
        grown = [_ops.grow(q.sse.ops, max_m) for q, _ in pend]
        g.sse = g.sse._replace(ops=_ops.OpString(
            bond=torch.cat([o.bond.to(dev) for o in grown], dim=1),
            inputs=torch.cat([o.inputs.to(dev) for o in grown], dim=2),
            outputs=torch.cat([o.outputs.to(dev) for o in grown], dim=2),
        ))
        self.graph = g
        self.betas = torch.from_numpy(np.concatenate(
            [np.full(q.replicas, b, np.float32) for q, b in pend])).to(dev)
        params = [_relative_bond_params(base, q) for q, _ in pend]
        sc = np.concatenate([np.tile(s[None], (q.replicas, 1))
                             for (q, _), (s, _) in zip(pend, params)])  # [R, NB]
        xr = np.concatenate([np.tile(x[None], (q.replicas, 1))
                             for (q, _), (_, x) in zip(pend, params)])
        self.hetero = bool(np.max(np.abs(sc - 1.0)) > 1e-12)
        self.scales = torch.from_numpy(sc).to(dev)
        self.xors = torch.from_numpy(xr).to(dev) if xr.any() else None
        if self._heatbath:
            self.set_enable_heatbath(True)

    def set_enable_heatbath(self, enable: bool) -> None:
        """Heat-bath diagonal updates for the whole ladder
        (``set_enable_heatbath``, ``qmc_ising.rs:444-486``); heterogeneous
        ladders get per-replica tables (the reference's per-graph
        ``BondWeights``)."""
        self._heatbath = bool(enable)
        if self._pending is not None:
            return  # built when the added graphs are joined
        self._hb = make_heatbath_tables(self.graph.model, self._bond_scale()) if enable else None

    @property
    def replicas(self) -> int:
        """All replicas of the ladder, on every rank of a sharded one."""
        self._finalize()
        return self._shard.replicas if self._shard else self.graph.replicas

    @property
    def rng_key(self) -> torch.Generator:
        """The generator of the container's draws (``rng_mut``,
        ``tempering_container.rs:236``): sweeps and swaps, or on a sharded
        container the rank's sweeps (the swaps draw from a generator that
        every rank holds alike). Assign a generator on the container's
        device to replace it."""
        self._finalize()
        return self.graph.draws.generator

    @rng_key.setter
    def rng_key(self, generator: torch.Generator) -> None:
        self._finalize()
        if generator.device.type != self.device.type:
            raise ValueError(f"a generator on {generator.device} cannot draw for {self.device}")
        self.graph.draws.generator = generator

    def _draws(self) -> Draws:
        """The draws of the container's next timestep and swap."""
        return self._shard.draws if self._shard else self.graph.draws

    def _global(self, x: torch.Tensor, dim: int = 0, tag: str = "samples") -> torch.Tensor:
        """``x``, or on a sharded container every rank's block of it joined
        along the replica axis ``dim``."""
        return self._shard.gather(x, dim, tag) if self._shard else x

    # -- sharding over a process group (the JAX package's shard_over) ---------

    def shard_over(self, group=None) -> None:
        """Keep this rank's block of the replicas and run the drivers
        sharded over the ranks of ``group`` (the world group when None), one
        process a card (the JAX package's ``shard_over`` over a mesh,
        ``isingmontecarlo_tpu/parallel/tempering.py:1049-1082``; the
        reference's rayon pool, ``tempering_container.rs:315-478``). Every
        rank must have built the same container (edges, seed, ladder) on its
        own device. Rank ``k`` of ``world`` keeps replicas ``[k R / world,
        (k + 1) R / world)`` of the op string, states and labels and of the
        per-replica heat-bath tables; its sweeps draw from a generator seeded
        from ``(seed, k)``, its swaps from one seeded alike on every rank.
        Host decisions that gate a collective (the cutoff and cluster caps,
        so the growth phase and chunk sizes) are taken on maxima reduced
        over the ranks, so that every rank takes them alike.

        A container that ``checkpoint.load_tempering`` read from a sharded
        container's file without ``seed`` carries every rank's generator
        states (``_resume_rng``): they are restored here in place of the
        seeding, and the chain resumes as it was.

        Raises when no process group is initialised, when ``R`` is not a
        multiple of the world size, when the container is sharded already,
        or when the generator states it carries are for another world size."""
        self._finalize()
        _dist.require_group()
        if self._shard is not None:
            raise ValueError("the container is sharded already")
        world = dist.get_world_size(group)
        rank = dist.get_rank(group)
        R = self.graph.replicas
        if R % world:
            raise ValueError(f"replicas {R} not divisible by the world size {world}")
        resume, self._resume_rng = self._resume_rng, None
        if resume is not None and resume[0].shape[0] != world:
            self._resume_rng = resume
            raise ValueError(f"the checkpoint holds the generators of {resume[0].shape[0]} "
                             f"ranks, not {world}: load it with seed= to reseed")
        R_l = R // world
        cols = slice(rank * R_l, (rank + 1) * R_l)
        g = self.graph
        ops = g.sse.ops
        g.sse = SseState(_ops.OpString(bond=ops.bond[:, cols].contiguous(),
                                       inputs=ops.inputs[:, :, cols].contiguous(),
                                       outputs=ops.outputs[:, :, cols].contiguous()),
                         g.sse.state[cols].contiguous())
        g.replicas = R_l
        self.betas = self.betas[cols].contiguous()
        self.scales = self.scales[cols].contiguous()
        if self.xors is not None:
            self.xors = self.xors[cols].contiguous()
        if self._hb is not None and self._hb.cum_max_w.dim() == 2:
            self._hb = HeatBathTables(cum_max_w=self._hb.cum_max_w[cols].contiguous(),
                                      total=self._hb.total[cols].contiguous())
        swap = torch.Generator(device=self.device)
        if resume is not None:
            g.draws.generator.set_state(resume[0][rank].clone())
            swap.set_state(resume[1].clone())
        else:
            g.draws.generator.manual_seed(_dist.rank_seed(self._seed, rank))
            swap.manual_seed(self._seed + 0x7E47)
        g._reduce_max = lambda x: _dist.all_reduce_max(x, group)
        self._shard = _Shard(group, world, rank, R, ShardDraws(g.draws, GeneratorDraws(swap)))

    def _bond_scale(self) -> torch.Tensor | None:
        return self.scales if self.hetero else None

    @property
    def class_scales(self) -> np.ndarray:
        """``f32[R, 3]`` (coupling, transverse, longitudinal) multipliers,
        read at one bond of each TFIM class; meaningful for class-wise
        ladders (the general label is the per-bond ``scales``)."""
        self._finalize()
        m = self.graph.model
        ne = len(self.graph.edges)
        n = m.nvars
        sc = self._global(self.scales, tag="labels").cpu().numpy()
        ones = np.ones(sc.shape[0], np.float32)
        cs = sc[:, 0] if ne > 0 else ones
        ts = sc[:, ne]
        ls = sc[:, ne + n] if m.nbonds > ne + n else ones
        return np.stack([cs, ts, ls], axis=1)

    # -- tempering_container.rs:77-81 ----------------------------------------

    def timesteps(self, t: int, chunk: int = 16) -> None:
        """Advance every replica ``t`` timesteps at its own label, starting
        with single timesteps while the cutoff grows (as
        ``QmcIsingGraph.timesteps_measure``)."""
        self._finalize()
        g = self.graph
        done = 0
        stable = 2 if not g._growth_pending else g._growth_stable
        while done < t:
            todo = 1 if stable < 2 else min(chunk, t - done)
            g.sse, _, _, _ = multi_sweep(
                g.sse, self.betas, g.model, todo, lambda: g.draws,
                cluster_caps=g._cluster_caps, hb=self._hb, heatbath=self._heatbath,
                bond_scale=self._bond_scale(), bond_xor=self.xors,
            )
            done += todo
            before = g.cutoff
            g._maybe_grow()
            stable = 0 if g.cutoff != before else stable + 1
        g._growth_stable = stable
        g._growth_pending = stable < 2

    # -- tempering_container.rs:121-163 --------------------------------------

    def tempering_step(self) -> int:
        """One alternating-parity neighbour-swap sweep on uniforms from the
        graph's generator; returns the swap count (one host read)."""
        self._finalize()
        g = self.graph
        kw = dict(gather=self._shard.gather, lo=self._shard.lo) if self._shard else {}
        self.betas, self.scales, self.xors, self._hb, swaps, _ = _swap_labels(
            g.sse, g.model, self.betas, self.scales, self.xors, self._hb, self.hetero,
            self._draws().swap((self.replicas,)), self._parity, **kw)
        self._parity = 1 - self._parity
        profiling.count("host_reads.tempering_step")
        swaps = int(swaps)
        self.total_swaps += swaps
        return swaps

    # -- tempering_container.rs:166-208, 411-451 ------------------------------

    def timesteps_sample(self, t: int, swap_freq: int = 1, sampling_freq: int | None = None,
                         chunk: int = 32):
        """Interleave timesteps, swaps and state samples. Returns ``(states
        bool[S, R, N], betas_at_sample f32[S, R])`` on the device, so samples
        can be grouped by temperature afterwards.

        After the growth phase (single timesteps while the cutoff grows),
        chunks of ``chunk`` timesteps run through
        :func:`tempering_sweep_chunk` (on a sharded container
        :func:`tempering_sweep_chunk_sharded`, and the samples are
        gathered), with the parity and the swap count read once a chunk and
        the cutoff refreshed between chunks."""
        self._finalize()
        freq = sampling_freq or 1
        g = self.graph
        states, bet = [], []
        step = 0
        while step < t and g._growth_pending:
            self.timesteps(1, chunk=1)
            if (step + 1) % swap_freq == 0:
                self.tempering_step()
            if (step + 1) % freq == 0:
                states.append(self._global(g.sse.state))
                bet.append(self._global(self.betas))
            step += 1
        while step < t:
            todo = min(chunk, t - step)
            do_swap = [(step + i + 1) % swap_freq == 0 for i in range(todo)]
            samp = [(step + i + 1) % freq == 0 for i in range(todo)]
            kw = dict(hb=self._hb, heatbath=self._heatbath, hetero=self.hetero,
                      collect_states=any(samp), cluster_caps=g._cluster_caps, xors=self.xors)
            chunk_fn = tempering_sweep_chunk
            if self._shard:
                chunk_fn = functools.partial(tempering_sweep_chunk_sharded,
                                             group=self._shard.group)
            (g.sse, self.betas, self.scales, self.xors, hb, parity, nswaps, _, st,
             bt) = chunk_fn(g.sse, self.betas, self.scales, self._parity, do_swap, g.model,
                            todo, self._draws, **kw)
            if self._shard and any(samp):
                with profiling.span("pt.samples"):
                    st, bt = self._global(st, 1), self._global(bt, 1)
            if self._hb is not None:
                self._hb = hb
            profiling.count("host_reads.parity_swaps")
            self._parity, swapped = (int(x) for x in torch.stack([parity, nswaps]).tolist())
            self.total_swaps += swapped
            for i, s in enumerate(samp):
                if s:
                    states.append(st[i])
                    bet.append(bt[i])
            step += todo
            g._maybe_grow()
        if not states:
            return (torch.zeros((0, self.replicas, g.nvars), dtype=torch.bool,
                                device=self.device),
                    torch.zeros((0, self.replicas), dtype=torch.float32, device=self.device))
        return torch.stack(states), torch.stack(bet)

    # -- per-replica autocorrelations (tempering_container.rs:482-633) --------

    def calculate_variable_autocorrelations(self, t: int, swap_freq: int = 1,
                                            sampling_freq: int | None = None) -> np.ndarray:
        """Spin autocorrelation of each replica, ``f32[R, S]``."""
        states, _ = self.timesteps_sample(t, swap_freq, sampling_freq)
        s = 2.0 * states.to(torch.float32) - 1.0  # [S, R, N]
        return np.stack([_ac.fft_autocorrelation(s[:, r]).cpu().numpy()
                         for r in range(self.replicas)])

    def calculate_bond_autocorrelations(self, t: int, swap_freq: int = 1,
                                        sampling_freq: int | None = None) -> np.ndarray:
        """Bond-satisfaction autocorrelation of each replica, ``f32[R, S]``."""
        states, _ = self.timesteps_sample(t, swap_freq, sampling_freq)
        ev, ej = edge_arrays(self.graph.edges)
        return np.stack([_ac.bond_autocorrelation(states[:, r:r + 1], ev, ej).cpu().numpy()
                         for r in range(self.replicas)])

    def states_by_temperature(self):
        """The current states and betas, ordered by ascending beta."""
        self._finalize()
        betas = self._global(self.betas)
        order = torch.argsort(betas, stable=True)
        return self._global(self.graph.sse.state)[order], betas[order]

    # -- small accessors (tempering_container.rs:211-238) ----------------------

    def iter_over_states(self, f) -> None:
        """``f(state_row, beta)`` for every replica, on host copies
        (``tempering_container.rs:211-216``)."""
        self._finalize()
        states = self._global(self.graph.sse.state).cpu().numpy()
        betas = self._global(self.betas).cpu().numpy()
        for r in range(self.replicas):
            f(states[r], float(betas[r]))

    def graph_ref(self):
        """The batched graph and its per-replica betas, the reference's
        ``&[(Q, beta)]`` (``tempering_container.rs:219-221``); the rank's
        block on a sharded container."""
        self._finalize()
        return self.graph, self.betas

    def graph_mut(self):
        """``tempering_container.rs:223-225``."""
        self._finalize()
        return self.graph, self.betas

    def num_graphs(self) -> int:
        """``tempering_container.rs:227-229``."""
        self._finalize()
        return self.replicas

    def get_total_swaps(self) -> int:
        """``tempering_container.rs:231-233``."""
        return self.total_swaps

    def verify(self) -> bool:
        """Worldline integrity of every replica, each weighed under its own
        sign pattern on a signed ladder (flipped bonds hold ops of zero base
        weight); on a sharded container, of every rank's block."""
        self._finalize()
        sse = self.graph.sse
        ok = bool(_ops.verify(sse.ops, sse.state, self.graph.model, self.xors).all())
        return _dist.all_true(ok, self.device, self._shard.group) if self._shard else ok


# -- the multi-process driver (``__graft_entry__.dryrun_multichip``) -------------------


def dryrun_sharded(n: int, backend: str = "gloo", device: torch.device | str = "cuda",
                   timeout: float = 600.0) -> list[dict]:
    """The JAX package's ``dryrun_multichip`` on ``n`` spawned ranks of a
    ``backend`` process group: a heterogeneous heat-bath ladder (a 4x4
    lattice, ``2n`` replicas, betas in [0.5, 2], transverse scales in
    [0.8, 1.25], per-replica tables) sharded over the ranks, one chunk of
    two sweep+swap steps, then one RVB-enabled Metropolis sweep at the
    swapped labels. Rank ``k`` runs on card ``k`` modulo the card count
    (``gloo`` ranks may share one), or on the CPU where ``device`` is the
    CPU. Returns every rank's summary: its device, the swap count, the
    gathered op counts and betas, ``verify`` over all ranks, and the rank's
    kernel launches and collective traffic."""
    if torch.device(device).type == "cuda":
        from isingmontecarlo_tpu_torch.ops import _build

        _build.library()  # once here, not by every rank
    return _dist.spawn(_dryrun_rank, n, backend, str(device), timeout=timeout)


def _dryrun_rank(rank: int, world: int, device: str) -> dict:
    from isingmontecarlo_tpu_torch import ops
    from isingmontecarlo_tpu_torch.lattice import square
    from isingmontecarlo_tpu_torch.sse.rvb import make_rvb_tables

    ops.reset_launch_counts()
    _dist.reset_traffic()

    dev = _dist.rank_device(device, rank, dist.get_backend())
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    R = 2 * world
    tc = TemperingContainer(square(4, 4, j=1.0), 1.0, betas=np.linspace(0.5, 2.0, R),
                            transverse_scales=np.linspace(0.8, 1.25, R), seed=0, device=dev)
    tc.graph.set_cutoff(32)
    tc.set_enable_heatbath(True)
    tc.shard_over()
    g = tc.graph
    (sse, betas, scales, _, _, _, nswaps, _, _, _) = tempering_sweep_chunk_sharded(
        g.sse, tc.betas, tc.scales, 0, [True, True], g.model, 2, tc._draws,
        hb=tc._hb, heatbath=True, hetero=True)
    sse, _ = sweep(sse, betas, g.model, g.draws, rvb_tables=make_rvb_tables(g.edges, g.model),
                   n_rvb=2, bond_scale=scales)
    ok = bool(_ops.verify(sse.ops, sse.state, g.model).all())
    return {"rank": rank, "device": str(dev), "replicas": R, "swaps": int(nswaps),
            "n": _dist.all_gather(_ops.op_count(sse.ops), tag="result").tolist(),
            "betas": _dist.all_gather(betas, tag="result").tolist(),
            "verify": _dist.all_true(ok, dev), "launches": ops.launch_counts(),
            "traffic": _dist.traffic()}
