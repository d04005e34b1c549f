"""Colour-parallel Metropolis updates for classical Ising models (port of
``isingmontecarlo_tpu/classical/metropolis.py``).

Semantics mirror the reference (``src/classical/graph.rs``):

- Energy: ``E = sum_edges J * (s_i == s_j ? +1 : -1) + sum_i (s_i ? -h_i : +h_i)``
  (``graph.rs:430-447``; spins map ``true -> +1``).
- Single-spin flip ``dE = -2 * sum_j J_vj * sigma_v sigma_j + 2 h_v sigma_v``
  (``graph.rs:91-119``).
- Metropolis acceptance ``dE <= 0`` always, else ``exp(-beta dE)``
  (``graph.rs:339-347``).
- Paired edge flip: flip both endpoints of an edge, ``dE`` omits the shared
  edge's coupling (``graph.rs:122-153``).

All sites of one vertex colour are updated at once (non-adjacent, so their
acceptances are independent), colour after colour; edge flips go by strong
edge colour the same way. Spins are ``bool[R, N]`` (or ``bool[R, L, L]`` on
the uniform-lattice fast path), replicas first.

Randomness stays out of the update math: every sweep takes its uniforms as
tensors in the shapes the JAX package draws them, and the run functions ask a
:class:`Draws` object for them.
"""

from __future__ import annotations

from typing import NamedTuple, Protocol, Sequence

import numpy as np
import torch

from isingmontecarlo_tpu_torch import lattice
from isingmontecarlo_tpu_torch import ops


class GraphTables(NamedTuple):
    """Compiled form of a classical Ising graph, on one device. The first
    nine fields are the JAX package's ``GraphTables``; the rest are derived
    from them on the host (:func:`tables_from_numpy`)."""

    neigh: torch.Tensor  # i32[N, D]  padded neighbour indices, -1 = pad
    nj: torch.Tensor  # f32[N, D]  couplings aligned with neigh
    biases: torch.Tensor  # f32[N]
    site_color: torch.Tensor  # i32[N]
    n_site_colors: int
    edges: torch.Tensor  # i32[E, 2]
    ej: torch.Tensor  # f32[E]
    edge_color: torch.Tensor  # i32[E]
    n_edge_colors: int
    site_classes: tuple[torch.Tensor, ...]  # i64 site ids of each colour
    edge_classes: tuple[torch.Tensor, ...]  # i64 edge ids of each colour
    has_bias: bool


def tables_from_numpy(neigh, nj, biases, site_color, n_site_colors, edges, ej,
                      edge_color, n_edge_colors, device) -> GraphTables:
    """:class:`GraphTables` on ``device`` from numpy arrays."""
    site_color = np.asarray(site_color, np.int32)
    edge_color = np.asarray(edge_color, np.int32)
    biases = np.asarray(biases, np.float32)

    def t(a, dtype):
        return torch.from_numpy(np.array(a)).to(device=device, dtype=dtype).contiguous()

    def classes(color, n):
        return tuple(t(np.flatnonzero(color == c), torch.int64) for c in range(n))

    return GraphTables(
        neigh=t(neigh, torch.int32), nj=t(nj, torch.float32),
        biases=t(biases, torch.float32), site_color=t(site_color, torch.int32),
        n_site_colors=int(n_site_colors),
        edges=t(np.asarray(edges, np.int32).reshape(-1, 2), torch.int32),
        ej=t(ej, torch.float32), edge_color=t(edge_color, torch.int32),
        n_edge_colors=int(n_edge_colors),
        site_classes=classes(site_color, int(n_site_colors)),
        edge_classes=classes(edge_color, int(n_edge_colors)),
        has_bias=bool(np.any(biases != 0.0)),
    )


def build_tables(edges, biases, device: torch.device | str = "cuda") -> GraphTables:
    """Compile an edge list and biases (``build_tables``, JAX ``:47``)."""
    nvars = len(biases)
    neigh, nj = lattice.adjacency(nvars, edges)
    site_color = lattice.greedy_coloring(nvars, edges)
    edge_color = lattice.greedy_edge_coloring(nvars, edges)
    if len(edges):
        ev, ej = lattice.edge_arrays(edges)
    else:
        ev, ej = np.zeros((0, 2), np.int32), np.zeros((0,), np.float32)
    return tables_from_numpy(
        neigh, nj, biases, site_color,
        int(site_color.max()) + 1 if nvars else 1, ev, ej, edge_color,
        int(edge_color.max()) + 1 if len(edges) else 1, device,
    )


class Draws(Protocol):
    """The random numbers of the classical moves, asked for by shape."""

    def uniform(self, shape: Sequence[int]) -> torch.Tensor:
        """``f32`` uniforms in ``[0, 1)``."""

    def coin(self, shape: Sequence[int]) -> torch.Tensor:
        """Fair ``bool`` coin flips."""

    def randint(self, high: int, shape: Sequence[int]) -> torch.Tensor:
        """``i64`` integers in ``[0, high)``."""


class GeneratorDraws:
    """:class:`Draws` from a ``torch.Generator`` on one device."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    def uniform(self, shape):
        return torch.rand(tuple(shape), generator=self.generator,
                          device=self.generator.device, dtype=torch.float32)

    def coin(self, shape):
        return self.uniform(shape) < 0.5

    def randint(self, high, shape):
        return torch.randint(0, high, tuple(shape), generator=self.generator,
                             device=self.generator.device)


def sigma(spins: torch.Tensor) -> torch.Tensor:
    """bool -> +-1 float32 (true -> +1, matching ``graph.rs:430-447``)."""
    return 2.0 * spins.to(torch.float32) - 1.0


def _masked_adjacency(tables: GraphTables):
    """``(neigh, w)`` with pads pointing at site 0 with weight 0."""
    pad = tables.neigh < 0
    return (torch.where(pad, 0, tables.neigh).long(),
            torch.where(pad, 0.0, tables.nj))


def _field(s: torch.Tensor, neigh: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``sum_d w[n, d] * s[:, neigh[n, d]]`` for the rows of ``neigh``."""
    return (s[:, neigh] * w).sum(dim=-1)


def local_field(spins: torch.Tensor, tables: GraphTables) -> torch.Tensor:
    """``f32[R, N]``: ``sum_j J_vj sigma_j`` over neighbours of each site."""
    return _field(sigma(spins), *_masked_adjacency(tables))


def energy(spins: torch.Tensor, tables: GraphTables) -> torch.Tensor:
    """Total energy per replica, ``f32[R]`` (``graph.rs:430-447``)."""
    s = sigma(spins)
    bond_e = 0.5 * torch.sum(local_field(spins, tables) * s, dim=-1)
    bias_e = -torch.sum(tables.biases[None, :] * s, dim=-1)
    return bond_e + bias_e


def magnetization(spins: torch.Tensor) -> torch.Tensor:
    """``sum_i sigma_i`` per replica, ``f32[R]``."""
    return torch.sum(sigma(spins), dim=-1)


def _beta(beta, device) -> torch.Tensor:
    """``beta`` as f32, a column ``[R, 1]`` when it is per replica."""
    b = torch.as_tensor(beta, dtype=torch.float32, device=device)
    return b[:, None] if b.dim() else b


def _accept(u, beta, delta_e):
    """Metropolis acceptance mask (``graph.rs:339-347``)."""
    return u < torch.exp(-beta * torch.clamp(delta_e, min=0.0))


def spin_flip_sweep(spins: torch.Tensor, u: torch.Tensor, beta,
                    tables: GraphTables) -> torch.Tensor:
    """One full colour-parallel Metropolis sweep over all sites.

    ``u f32[n_site_colors, R, N]`` holds the uniforms of each colour pass
    (only the entries of that colour's sites are read). ``beta`` may be a
    scalar or ``f32[R]``. Equivalent work to ``nvars`` single-site attempts
    of ``do_spin_flip`` (``graph.rs:91-119``)."""
    b = _beta(beta, spins.device)
    neigh, w = _masked_adjacency(tables)
    for c, sites in enumerate(tables.site_classes):
        s = sigma(spins)
        sv = s[:, sites]
        field = _field(s, neigh[sites], w[sites])
        delta_e = -2.0 * field * sv + 2.0 * tables.biases[sites][None, :] * sv
        acc = _accept(u[c][:, sites], b, delta_e)
        spins = spins.clone()
        spins[:, sites] ^= acc
    return spins


def edge_flip_sweep(spins: torch.Tensor, u: torch.Tensor, beta,
                    tables: GraphTables, attempt_p: torch.Tensor | None = None,
                    u_attempt: torch.Tensor | None = None) -> torch.Tensor:
    """One matching-parallel paired edge-flip sweep (``graph.rs:122-153``).

    Each strong colour class flips both endpoints of its accepted edges;
    ``dE`` counts each endpoint's neighbour couplings minus the shared edge
    plus both bias terms. ``u f32[n_edge_colors, R, E]`` are the acceptance
    uniforms. ``attempt_p f32[E]`` enables edge importance sampling: an edge
    of the class attempts when ``u_attempt[c, e] < attempt_p[e]``, with
    ``u_attempt f32[n_edge_colors, E]``."""
    b = _beta(beta, spins.device)
    neigh, w = _masked_adjacency(tables)
    for c, es in enumerate(tables.edge_classes):
        va = tables.edges[es, 0].long()
        vb = tables.edges[es, 1].long()
        ej = tables.ej[es][None, :]
        s = sigma(spins)
        sa, sb = s[:, va], s[:, vb]
        # dE(v omitting partner) = -2 (field_v - J_e sigma_partner) sigma_v
        #                         + 2 h_v sigma_v        (graph.rs:141-148)
        fa = _field(s, neigh[va], w[va]) - ej * sb
        fb = _field(s, neigh[vb], w[vb]) - ej * sa
        de = (-2.0 * (fa * sa + fb * sb)
              + 2.0 * (tables.biases[va][None, :] * sa + tables.biases[vb][None, :] * sb))
        acc = _accept(u[c][:, es], b, de)
        if attempt_p is not None:
            acc = acc & (u_attempt[c][es] < attempt_p[es])[None, :]
        # A strong colour class has disjoint endpoints, so the two XOR
        # writes touch every site at most once.
        spins = spins.clone()
        spins[:, va] ^= acc
        spins[:, vb] ^= acc
    return spins


def metropolis_run(spins: torch.Tensor, draws: Draws, beta, tables: GraphTables,
                   nsweeps: int, measure: bool = False):
    """``nsweeps`` Metropolis sweeps; optionally also returns the energy
    after each one, ``f32[T, R]``."""
    es = []
    shape = (tables.n_site_colors, *spins.shape)
    for _ in range(nsweeps):
        spins = spin_flip_sweep(spins, draws.uniform(shape), beta, tables)
        if measure:
            es.append(energy(spins, tables))
    return spins, torch.stack(es) if measure else None


# ---------------------------------------------------------------------------
# Fast path: uniform 2D periodic lattice as [R, L, L] with checkerboard sweeps.
# ---------------------------------------------------------------------------


def checkerboard_sweep(spins: torch.Tensor, u: torch.Tensor, beta, j, h) -> torch.Tensor:
    """One full checkerboard Metropolis sweep of ``bool[R, L, L]`` with
    uniform ``j`` and ``h``: the full-field form of the JAX package's XLA
    path, two parity half-sweeps with uniforms ``u f32[2, R, L, L]`` (only
    the half-sweep's colour is read)."""
    R, L, _ = spins.shape
    yy = torch.arange(L, device=spins.device)[:, None]
    xx = torch.arange(L, device=spins.device)[None, :]
    parity = (xx + yy) % 2
    b = torch.as_tensor(beta, dtype=torch.float32, device=spins.device)
    bcol = b[:, None, None] if b.dim() else b
    for par in range(2):
        s = sigma(spins)
        nsum = (torch.roll(s, 1, dims=-1) + torch.roll(s, -1, dims=-1)
                + torch.roll(s, 1, dims=-2) + torch.roll(s, -1, dims=-2))
        de = -2.0 * j * nsum * s + 2.0 * h * s
        acc = u[par] < torch.exp(-bcol * torch.clamp(de, min=0.0))
        spins = torch.where((parity == par)[None] & acc, ~spins, spins)
    return spins


def lattice_multi_sweep(spins: torch.Tensor, seed: int, beta, j, h,
                        nsweeps: int) -> torch.Tensor:
    """``nsweeps`` checkerboard sweeps of ``bool[R, L, L]`` through kernel K1
    (:func:`isingmontecarlo_tpu_torch.ops.checkerboard_multi_sweep`): its
    CUDA kernel for a CUDA tensor, its plain version for a CPU tensor. The
    draws are Philox numbers keyed by the 64-bit ``seed``."""
    return ops.checkerboard_multi_sweep(spins, seed, float(beta), float(j),
                                        float(h), nsweeps)


def lattice_energy(spins: torch.Tensor, j, h) -> torch.Tensor:
    """Energy per replica for the uniform periodic lattice fast path."""
    s = sigma(spins)
    e_bond = j * (torch.sum(s * torch.roll(s, -1, dims=-1), dim=(-1, -2))
                  + torch.sum(s * torch.roll(s, -1, dims=-2), dim=(-1, -2)))
    e_bias = -h * torch.sum(s, dim=(-1, -2))
    return e_bond + e_bias
