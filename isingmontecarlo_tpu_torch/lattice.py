"""Edge-list lattices for the SSE engine (numpy only).

A copy of the parts of ``isingmontecarlo_tpu/lattice.py`` that the SSE
slice uses, kept as a copy rather than an import: importing the JAX package
imports ``jax``, which the GPU host does not have. The edge-list convention is
the reference's ``Vec<((usize, usize), f64)>`` (``src/sse/qmc_ising.rs:80-95``).
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
