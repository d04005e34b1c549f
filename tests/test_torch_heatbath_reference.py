"""``QmcIsingGraph`` with the heat-bath diagonal update held to the
benchmark's plain heat-bath reference (``benchmark/reference/
sse_heatbath.py``) element for element, chunk by chunk, as the benchmark's
cell ``two_d_heatbath_32_r4096_k6`` holds it on the card: the op string, the
spins, the op count after every timestep and the cluster caps, with the
cluster update on every timestep and on every 6th, and across a growth of
the cutoff. Also K3-hb's byte count, and that a thinned timestep draws the
diagonal update's uniforms and nothing else.

CPU only, on the 4x4 benchmark lattice at R=8."""

from __future__ import annotations

import pytest
import torch

from benchmark import check, draws
from benchmark.layer_metrics._carry_heatbath_bytes import carry_heatbath_bytes
from benchmark.reference import sse as ref
from benchmark.reference import sse_heatbath as ref_hb
from isingmontecarlo_tpu_torch import lattice
from isingmontecarlo_tpu_torch.sse import ising

from torch_port_utils import release_jax_executables  # noqa: F401  (autouse)

torch.set_num_threads(1)

CHUNK = 6


def heatbath_graph(k: int, seed: int) -> tuple[ising.QmcIsingGraph, torch.Generator]:
    """The 4x4 graph with heat-bath and ``cluster_every=k`` on the
    benchmark's seeded draws, warmed up at beta 1."""
    g = ising.QmcIsingGraph(lattice.bench_two_d_periodic(4), 1.0, replicas=8, seed=seed,
                            device="cpu")
    gen = draws.generator(seed, "cpu")
    g.draws = draws.SeededDraws(gen)
    g.set_enable_heatbath(True)
    g.set_cluster_every(k)
    g.timesteps(24, 1.0, chunk=CHUNK)
    return g, gen


@pytest.mark.parametrize("k,grow", [(1, False), (6, False), (6, True)])
def test_the_graph_equals_the_heatbath_reference(k, grow):
    g, gen = heatbath_graph(k, seed=40 + k + grow)
    model = ref.tfim(g.edges, 1.0)
    # At beta 2 the op counts double, so the cutoff grows between chunks.
    beta = 2.0 if grow else 1.0
    cutoff = g.cutoff
    for _ in range(3):
        start = check.to_host(check.snapshot(g.sse, caps=g._cluster_caps, gen=gen.get_state()))
        g.sse, ns, _, _ = ising.multi_sweep(g.sse, beta, g.model, CHUNK, lambda: g.draws,
                                            cluster_caps=g._cluster_caps, cluster_every=k,
                                            **g._diag_args())
        g._maybe_grow()
        end = check.to_host(check.snapshot(g.sse, caps=g._cluster_caps, ns=ns))
        want = ref_hb.chunk(start, model, beta, CHUNK, k,
                            check._restored(start["gen"], "cpu"), "cpu")
        assert check.compare(want, end) == {"state": 0, "ns": 0, "growth": 0}
    assert g.cutoff > cutoff or not grow


def test_carry_heatbath_bytes_match_the_kernel_table():
    # PERF.md's kernel table: K3-hb 16.13 MB at M=7000, R=256.
    assert carry_heatbath_bytes(7000, 256) == 7000 * 256 * 9 + 8 * 256
    assert carry_heatbath_bytes(7000, 256) / 1e6 == pytest.approx(16.13, abs=0.005)


class Recorded(draws.SeededDraws):
    """The benchmark's draws, with each request's kind and shape kept."""

    def __init__(self, gen):
        super().__init__(gen)
        self.asked = []

    def diagonal(self, shape):
        self.asked.append(("diagonal", tuple(shape)))
        return super().diagonal(shape)

    def cluster(self, shape):
        self.asked.append(("cluster", tuple(shape)))
        return super().cluster(shape)

    def free_spins(self, shape):
        self.asked.append(("free_spins", tuple(shape)))
        return super().free_spins(shape)


def test_a_thinned_timestep_draws_only_the_diagonal_uniforms():
    g, _ = heatbath_graph(6, seed=7)
    M, R, N = g.cutoff, g.replicas, g.nvars
    d = Recorded(draws.generator(1, "cpu"))
    sse, _ = ising.sweep(g.sse, 1.0, g.model, d, cluster_caps=g._cluster_caps,
                         do_cluster=False, **g._diag_args())
    assert d.asked == [("diagonal", (3, M, R))]
    ising.sweep(sse, 1.0, g.model, d, cluster_caps=g._cluster_caps, **g._diag_args())
    assert [kind for kind, _ in d.asked] == ["diagonal", "diagonal", "cluster", "free_spins"]
    assert d.asked[-1] == ("free_spins", (R, N))
    # The reference draws the same: the diagonal's uniforms alone, then all three.
    host = check.to_host(check.snapshot(g.sse))
    ops = ref.Ops(host["bond"], host["ins"], host["outs"])
    asked = []

    def draw(shape):
        asked.append(tuple(shape))
        return draws.uniform(draws.generator(2, "cpu"), shape)

    model = ref.tfim(g.edges, 1.0)
    beta = torch.full((R,), 1.0).numpy()
    ops, state = ref_hb.timestep(ops, host["state"], beta, model, draw, g._cluster_caps, "cpu",
                                 do_cluster=False)
    assert asked == [(3, M, R)]
    ref_hb.timestep(ops, state, beta, model, draw, g._cluster_caps, "cpu", do_cluster=True)
    assert asked[:2] == [(3, M, R), (3, M, R)] and asked[-1] == (R, N) and len(asked) == 4
