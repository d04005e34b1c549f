"""The upstream's benchmark lattice (``"kind": "bench_two_d_periodic"``)."""

from __future__ import annotations


def edges(spec: dict) -> list[tuple[tuple[int, int], float]]:
    """``spec["L"]``: Renmusxd/IsingMonteCarlo ``benches/end_to_end.rs:12-30``,
    L x L periodic, rightward couplings -1, downward couplings +1 on even
    columns and -1 on odd ones, so every plaquette is frustrated."""
    L = spec["L"]

    def f(i: int, j: int) -> int:
        return j * L + i

    out = [((f(i, j), f((i + 1) % L, j)), -1.0) for j in range(L) for i in range(L)]
    out += [((f(i, j), f(i, (j + 1) % L)), 1.0 if i % 2 == 0 else -1.0)
            for j in range(L) for i in range(L)]
    return out
