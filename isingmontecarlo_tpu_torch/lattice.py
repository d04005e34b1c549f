"""Edge-list lattices and graph tables (numpy only).

A copy of the parts of ``isingmontecarlo_tpu/lattice.py`` that the SSE and
classical engines use, kept as a copy rather than an import: importing the
JAX package imports ``jax``, which the GPU host does not have. The edge-list
convention is the reference's ``Vec<((usize, usize), f64)>``
(``src/sse/qmc_ising.rs:80-95``). The graph compiler's branches are the
JAX package's pure-Python ones; its native C++ compiler is not copied, so
the colourings here are valid but need not equal the ones the JAX package
builds with it.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

Edge = tuple[int, int]


def nvars_from_edges(edges: Sequence[tuple[Edge, float]]) -> int:
    """Number of variables = max index + 1 (reference ``qmc_ising.rs:92``)."""
    return max(max(a, b) for (a, b), _ in edges) + 1


def edge_arrays(
    edges: Sequence[tuple[Edge, float]],
) -> tuple[np.ndarray, np.ndarray]:
    """Split an edge list into ``(i32[E,2], f32[E])`` arrays."""
    ev = np.asarray([[a, b] for (a, b), _ in edges], dtype=np.int32)
    ej = np.asarray([j for _, j in edges], dtype=np.float32)
    return ev, ej


def adjacency(
    nvars: int,
    edges: Sequence[tuple[Edge, float]],
) -> tuple[np.ndarray, np.ndarray]:
    """Padded per-site adjacency (the reference's ``binding_mat``,
    ``graph.rs:69-80``, as dense padded tables).

    Returns ``(neigh, nj)`` with shapes ``[N, D]``, each row sorted by
    neighbour index; ``neigh == -1`` marks padding and ``nj`` is zero there.
    """
    lists: list[list[tuple[int, float]]] = [[] for _ in range(nvars)]
    for (a, b), j in edges:
        lists[a].append((b, j))
        lists[b].append((a, j))
    for l in lists:
        l.sort(key=lambda t: t[0])
    deg = max(max((len(l) for l in lists), default=0), 1)
    neigh = np.full((nvars, deg), -1, dtype=np.int32)
    nj = np.zeros((nvars, deg), dtype=np.float32)
    for v, l in enumerate(lists):
        for d, (ov, j) in enumerate(l):
            neigh[v, d] = ov
            nj[v, d] = j
    return neigh, nj


def _neighbour_sets(nvars: int, edges) -> list[set[int]]:
    adj: list[set[int]] = [set() for _ in range(nvars)]
    for (a, b), _ in edges:
        adj[a].add(b)
        adj[b].add(a)
    return adj


def greedy_coloring(nvars: int, edges: Sequence[tuple[Edge, float]]) -> np.ndarray:
    """Greedy vertex colouring, highest degree first; returns ``i32[N]``.

    Sites sharing a colour are non-adjacent, so they can be Metropolis-updated
    in parallel (the replacement for the reference's one-random-site
    updates, ``graph.rs:91-119``).
    """
    adj = _neighbour_sets(nvars, edges)
    colors = np.full(nvars, -1, dtype=np.int32)
    for v in sorted(range(nvars), key=lambda v: -len(adj[v])):
        used = {colors[u] for u in adj[v] if colors[u] >= 0}
        c = 0
        while c in used:
            c += 1
        colors[v] = c
    return colors


def greedy_edge_coloring(
    nvars: int, edges: Sequence[tuple[Edge, float]]
) -> np.ndarray:
    """Greedy *strong* (distance-2) edge colouring; returns ``i32[E]``.

    Used to parallelise the reference's paired edge flips
    (``graph.rs:122-153``). Edges of one colour share no vertex *and* no
    endpoint of one is adjacent to an endpoint of another: flipping edge
    (a, b) changes the local field at every neighbour of a and b, so only
    distance-2-separated edges have independent Metropolis factors.
    """
    adj = _neighbour_sets(nvars, edges)
    colors = np.full(len(edges), -1, dtype=np.int32)
    # Colours forbidden at each vertex: colours of edges incident to it.
    vert_used: list[set[int]] = [set() for _ in range(nvars)]
    for e, ((a, b), _) in enumerate(edges):
        used: set[int] = set()
        for v in (a, b):
            used |= vert_used[v]
            for u in adj[v]:
                used |= vert_used[u]
        c = 0
        while c in used:
            c += 1
        colors[e] = c
        vert_used[a].add(c)
        vert_used[b].add(c)
    return colors


def chain(L: int, j: float = 1.0, periodic: bool = True) -> list[tuple[Edge, float]]:
    """1D chain/ring with uniform coupling."""
    edges = [(((v, v + 1)), j) for v in range(L - 1)]
    if periodic and L > 2:
        edges.append(((L - 1, 0), j))
    return edges


def square(
    Lx: int,
    Ly: int,
    j: float = 1.0,
    periodic: bool = True,
) -> list[tuple[Edge, float]]:
    """2D square lattice with uniform coupling, row-major site indexing."""

    def idx(x: int, y: int) -> int:
        return (y % Ly) * Lx + (x % Lx)

    edges = []
    for y in range(Ly):
        for x in range(Lx):
            if periodic or x + 1 < Lx:
                edges.append(((idx(x, y), idx(x + 1, y)), j))
            if periodic or y + 1 < Ly:
                edges.append(((idx(x, y), idx(x, y + 1)), j))
    # Dedup for tiny open/periodic overlaps (Lx or Ly <= 2).
    seen = set()
    out = []
    for (a, b), jj in edges:
        k = (min(a, b), max(a, b))
        if a != b and k not in seen:
            seen.add(k)
            out.append(((a, b), jj))
    return out


def bench_two_d_periodic(l: int) -> list[tuple[Edge, float]]:
    """The reference benchmark lattice, mirrored exactly
    (``benches/end_to_end.rs:12-30``): L x L periodic, right couplings -1,
    down couplings +1/-1 by column parity (every plaquette frustrated)."""

    def f(i: int, j: int) -> int:
        return j * l + i

    edges: list[tuple[Edge, float]] = []
    for j in range(l):
        for i in range(l):
            edges.append(((f(i, j), f((i + 1) % l, j)), -1.0))
    for j in range(l):
        for i in range(l):
            edges.append(((f(i, j), f(i, (j + 1) % l)), 1.0 if i % 2 == 0 else -1.0))
    return edges


def frustrated_square(
    Lx: int, Ly: int, j: float = 1.0, periodic: bool = True
) -> list[tuple[Edge, float]]:
    """2D periodic lattice with alternating-sign couplings, mirroring the
    frustrated benchmark lattices of ``benches/end_to_end.rs:100-118`` (sign
    depends on the parity of the site coordinates)."""

    def idx(x: int, y: int) -> int:
        return (y % Ly) * Lx + (x % Lx)

    edges = []
    for y in range(Ly):
        for x in range(Lx):
            sx = j if (x + y) % 2 == 0 else -j
            if periodic or x + 1 < Lx:
                edges.append(((idx(x, y), idx(x + 1, y)), sx))
            if periodic or y + 1 < Ly:
                edges.append(((idx(x, y), idx(x, y + 1)), -sx))
    seen = set()
    out = []
    for (a, b), jj in edges:
        k = (min(a, b), max(a, b))
        if a != b and k not in seen:
            seen.add(k)
            out.append(((a, b), jj))
    return out
