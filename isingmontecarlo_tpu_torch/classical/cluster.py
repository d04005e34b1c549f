"""Swendsen-Wang and Wolff cluster updates for classical Ising models (port
of ``isingmontecarlo_tpu/classical/cluster.py``; the reference has no
classical cluster move):

1. Activate each *satisfied* bond (``J sigma_i sigma_j = -|J|``) with
   probability ``1 - exp(-2 beta |J|)``.
2. Label connected components of the activated-bond graph by min-label
   hooks with pointer jumping.
3. Flip every cluster independently with probability 1/2; with
   longitudinal biases, accept each cluster's flip with the Metropolis
   factor of its bias energy change instead.

All arrays carry a leading replica axis ``R``; the draws are passed in.
"""

from __future__ import annotations

import torch

from isingmontecarlo_tpu_torch.classical.metropolis import (
    Draws,
    GraphTables,
    _beta,
    energy,
    sigma,
)

_BIG = torch.iinfo(torch.int32).max


def _connected_components(active: torch.Tensor, edges: torch.Tensor, n: int) -> torch.Tensor:
    """Min-label connected components.

    ``active bool[R, E]`` activation per edge, ``edges i32[E, 2]``. Returns
    ``labels i32[R, N]``: each vertex holds the least vertex id of its
    component. Each round hooks every active edge's endpoints to the lesser
    label (``scatter_reduce`` with ``amin``) and jumps pointers twice; the
    loop reads one flag from the device per round to find the fixpoint, as
    the JAX ``while_loop`` tests its condition."""
    R = active.shape[0]
    labels = torch.arange(n, dtype=torch.int32, device=active.device).repeat(R, 1)
    va = edges[:, 0].long().expand(R, -1)
    vb = edges[:, 1].long().expand(R, -1)
    while True:
        mn = torch.minimum(labels.gather(1, va), labels.gather(1, vb))
        upd = torch.where(active, mn, _BIG)
        new = labels.scatter_reduce(1, va, upd, "amin")
        new = new.scatter_reduce(1, vb, upd, "amin")
        # Pointer jumping: a vertex's label is a vertex id, chase it twice.
        new = torch.minimum(new, new.gather(1, new.long()))
        new = torch.minimum(new, new.gather(1, new.long()))
        if torch.equal(new, labels):
            return new
        labels = new


def _active_bonds(spins, u_bond, beta, tables: GraphTables) -> torch.Tensor:
    """``bool[R, E]``: satisfied bonds kept with ``1 - exp(-2 beta |J|)``."""
    s = sigma(spins)
    va = tables.edges[:, 0].long()
    vb = tables.edges[:, 1].long()
    j = tables.ej
    satisfied = j[None, :] * s[:, va] * s[:, vb] < 0.0
    p_act = 1.0 - torch.exp(-2.0 * beta * torch.abs(j)[None, :])
    return satisfied & (u_bond < p_act)


def swendsen_wang_sweep(spins: torch.Tensor, u_bond: torch.Tensor,
                        coin: torch.Tensor, u_acc: torch.Tensor, beta,
                        tables: GraphTables) -> torch.Tensor:
    """One Swendsen-Wang sweep on an arbitrary weighted graph.

    Draws: ``u_bond f32[R, E]`` bond activation, ``coin bool[R, N]`` the
    flip of the cluster whose root (least id) is each site, ``u_acc
    f32[R, N]`` the bias acceptance of each root's cluster (read only when
    the graph has biases). ``beta`` may be a scalar or ``f32[R]``."""
    R, N = spins.shape
    b = _beta(beta, spins.device)
    active = _active_bonds(spins, u_bond, b, tables)
    labels = _connected_components(active, tables.edges, N).long()
    flip = coin.gather(1, labels)
    if tables.has_bias:
        # dE_bias of flipping cluster c = sum_{v in c} 2 h_v sigma_v.
        de_v = 2.0 * tables.biases[None, :] * sigma(spins)
        de_c = torch.zeros((R, N), dtype=torch.float32,
                           device=spins.device).scatter_add(1, labels, de_v)
        acc_c = u_acc < torch.exp(-b * torch.clamp(de_c, min=0.0))
        flip = flip & acc_c.gather(1, labels)
    return spins ^ flip


def swendsen_wang_run(spins: torch.Tensor, draws: Draws, beta,
                      tables: GraphTables, nsweeps: int, measure: bool = False):
    """``nsweeps`` SW sweeps; optionally also returns the energy after each,
    ``f32[T, R]``."""
    R, N = spins.shape
    E = tables.edges.shape[0]
    es = []
    for _ in range(nsweeps):
        spins = swendsen_wang_sweep(spins, draws.uniform((R, E)), draws.coin((R, N)),
                                    draws.uniform((R, N)), beta, tables)
        if measure:
            es.append(energy(spins, tables))
    return spins, torch.stack(es) if measure else None


def wolff_sweep(spins: torch.Tensor, u_bond: torch.Tensor, seed_site: torch.Tensor,
                beta, tables: GraphTables) -> torch.Tensor:
    """Wolff single-cluster update, one cluster per replica: Swendsen-Wang
    bond activation (``u_bond f32[R, E]``), then a flip of the component
    that holds ``seed_site i64[R]`` only. Equivalent in distribution to
    growing one Wolff cluster (without bias fields)."""
    R, N = spins.shape
    active = _active_bonds(spins, u_bond, _beta(beta, spins.device), tables)
    labels = _connected_components(active, tables.edges, N)
    seed_label = labels.gather(1, seed_site.long()[:, None])
    return spins ^ (labels == seed_label)
