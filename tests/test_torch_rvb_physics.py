"""The port's RVB chains on their own, on the CPU, mirroring the JAX
package's ``tests/test_rvb.py`` (the reference's ``check_rvb_crash.rs`` and
``longitudinal_crash.rs``): worldline integrity after every timestep, the
counters of ``single_rvb_sweep``, energies against exact diagonalization,
and the compaction cutoff's hysteresis.
"""

import itertools

import numpy as np
import pytest
import torch
from test_sse import exact_tfim_energy

from isingmontecarlo_tpu import lattice
from isingmontecarlo_tpu_torch.sse import ising as tising
from isingmontecarlo_tpu_torch.sse import opstring as tops
from isingmontecarlo_tpu_torch.sse import rvb as trvb

from torch_port_utils import release_jax_executables  # noqa: F401  (autouse)

torch.set_num_threads(1)


def _soak(edges, transverse, longitudinal=0.0, seed=0):
    g = tising.QmcIsingGraph(edges, transverse, longitudinal, replicas=16, seed=seed,
                             device="cpu")
    g.set_run_rvb(True, updates_per_timestep=5)
    for _ in range(8):
        g.timestep(1.0)
        assert g.verify(), "worldline integrity broken by RVB"
    assert g.rvb_clusters_counted == 8 * 5 * 16
    assert 0 < g.total_rvb_successes < g.rvb_clusters_counted


@pytest.mark.parametrize("seed", [0, 1])
def test_3x3_periodic_verifies(seed):
    _soak(lattice.square(3, 3, j=1.0), 1.0, seed=seed)


def test_4x4_frustrated_verifies():
    _soak(lattice.frustrated_square(4, 4, j=1.0), 2.0, seed=3)


@pytest.mark.parametrize("seed,h", list(itertools.product([0, 1], [0.3, -0.4])))
def test_longitudinal_verifies(seed, h):
    """h != 0 freezes the longitudinal ops into clusters; RVB must keep the
    worldlines whole and every weight positive."""
    _soak(lattice.square(3, 3, j=1.0), 1.0, longitudinal=h, seed=seed)


def test_chunked_pass_verifies(monkeypatch):
    """The acceptance-and-mutation pass in chunks of 128 slots (its gate
    forced) keeps the worldlines whole, with the generator's per-chunk
    noise."""
    monkeypatch.setattr(trvb, "VEC_MAX_ELEMS", 1)
    g = tising.QmcIsingGraph(lattice.square(6, 6), 1.0, replicas=8, seed=7, device="cpu")
    for _ in range(10):
        g.timestep(2.0)
    g.set_run_rvb(True, updates_per_timestep=5)
    assert g.cutoff > 2 * 128
    for _ in range(4):
        n = g.get_n().clone()
        g.single_rvb_sweep(5)
        assert g.verify() and torch.equal(g.get_n(), n)
    assert g.total_rvb_successes > 0


def test_single_rvb_sweep_counters_and_rate():
    g = tising.QmcIsingGraph(lattice.square(3, 3, j=1.0), 1.0, replicas=16, seed=7,
                             device="cpu")
    for _ in range(5):
        g.timestep(1.0)
    n = g.get_n().clone()
    succ, counted = g.single_rvb_sweep(4)
    assert g.verify()
    assert torch.equal(g.get_n(), n)  # RVB never inserts or removes ops
    assert counted == 4 * 16 and 0 <= succ <= counted
    assert (g.total_rvb_successes, g.rvb_clusters_counted) == (succ, counted)
    assert g.rvb_success_rate() == succ / counted
    succ2, _ = g.single_rvb_sweep()  # (N + 1) // 2 = 5 updates
    assert g.rvb_clusters_counted == 4 * 16 + 5 * 16
    assert g.total_rvb_successes == succ + succ2
    assert 0.0 < g.rvb_success_rate() < 1.0


@pytest.mark.parametrize("h,seed", [(0.0, 11), (0.4, 13)])
def test_ring_energy_matches_ed_with_rvb(h, seed):
    """RVB must not bias the stationary distribution: <E> on a 4-site ring
    with RVB on (2 updates a timestep) against exact diagonalization."""
    edges = lattice.chain(4, j=1.0)
    beta = 1.5
    exact = exact_tfim_energy(edges, 1.0, h, beta, 4)
    g = tising.QmcIsingGraph(edges, 1.0, h, cutoff=96, replicas=128, seed=seed,
                             device="cpu")
    g.set_run_rvb(True, updates_per_timestep=2)
    g.timesteps(48, beta, chunk=48)
    e = g.timesteps(192, beta, chunk=48).numpy()
    mean, sem = float(e.mean()), float(e.std() / np.sqrt(len(e)))
    assert abs(mean - exact) < max(5 * sem, 0.15), (mean, exact, sem)
    assert g.verify()
    assert g._rvb_compact is not None  # the sweeps ran on the compacted prefix
    assert 0.0 < g.rvb_success_rate() < 1.0


# (n_max, compaction cutoff before, cutoff M) -> after, from
# isingmontecarlo_tpu/sse/ising.py:770-784: want = 16 * ceil((n + n/4 + 2) / 16);
# grow when want exceeds it, shrink only when want is under half; None
# unless at most M - M/8.
HYSTERESIS = [
    (100, None, 512, 128),  # 100 + 25 + 2 = 127 -> 128
    (100, 128, 512, 128),
    (120, 128, 512, 160),  # want 160 > 128: grow
    (60, 160, 512, 160),  # want 80: not under half of 160, keep
    (40, 160, 512, 64),  # want 64 < 80: shrink
    (400, 160, 512, None),  # want 512 > 448 = 512 - 64: the full string
    (0, None, 32, 16),  # want 16 <= 32 - 4
    (0, None, 16, None),  # want 16 > 16 - 2
    (300, None, 400, None),  # want 384 > 350 = 400 - 50
    (300, None, 448, 384),  # 384 <= 392 = 448 - 56
]


@pytest.mark.parametrize("n_max,before,cutoff,after", HYSTERESIS)
def test_rvb_compact_cutoff_hysteresis(n_max, before, cutoff, after):
    assert tising.rvb_compact_cutoff(n_max, before, cutoff) == after


def test_maybe_grow_refreshes_the_compaction_cutoff():
    """Through QmcIsingGraph: the cutoff follows the largest op count with
    hysteresis, only while RVB is on."""
    edges = lattice.chain(4)
    g = tising.QmcIsingGraph(edges, 1.0, cutoff=512, replicas=2, device="cpu")
    g._maybe_grow()
    assert g._rvb_compact is None  # RVB off
    g.set_run_rvb(True)

    def with_ops(n):
        bond = torch.full((g.cutoff, 2), -1, dtype=torch.int32)
        bond[:n, 0] = len(edges)  # transverse-field ops on var 0
        g.sse = g.sse._replace(ops=g.sse.ops._replace(bond=bond))
        g._maybe_grow()
        return g._rvb_compact

    assert with_ops(100) == 128
    assert with_ops(120) == 160
    assert with_ops(60) == 160
    assert with_ops(40) == 64
    assert int(tops.op_count(g.sse.ops).max()) == 40
