"""The port's generic engine on its own chains (``torch.Generator`` draws)
on the CPU, against dense exact diagonalization, and ``into_qmc`` against
the ``QmcIsingGraph`` it came from (the JAX package's
``tests/test_sse.py:185-325`` and ``tests/test_api_surface.py:151-178``,
with their tolerances).

The energy estimator is ``E = -<n>/beta + offset``, where SSE with the
weights ``W_b`` samples ``H = -sum_b W_b`` (see :func:`exact_energy`).
"""

import numpy as np
import pytest
import torch
from test_sse import exact_tfim_energy

from isingmontecarlo_tpu_torch import lattice
from isingmontecarlo_tpu_torch.sse import QmcIsingGraph
from isingmontecarlo_tpu_torch.sse.runner import Qmc

from torch_port_utils import release_jax_executables  # noqa: F401  (autouse)

torch.set_num_threads(1)

W_XXZ = np.array([[0.5, 0, 0, 0], [0, 1.0, 0.7, 0], [0, 0.7, 1.0, 0], [0, 0, 0, 0.5]])


def exact_energy(nvars, interactions, beta):
    """Thermal ``<H>`` of ``H = -sum_b W_b`` by dense diagonalization; each
    ``W_b`` is a ``2^k x 2^k`` matrix (row = outputs) or a diagonal over its
    variables, the first variable the most significant bit."""
    dim = 1 << nvars
    H = np.zeros((dim, dim))
    for mat, vars in interactions:
        mat = np.asarray(mat, dtype=np.float64)
        k = len(vars)
        mask = sum(1 << v for v in vars)

        def local(idx):
            return sum(((idx >> v) & 1) << (k - 1 - l) for l, v in enumerate(vars))

        for idx in range(dim):
            if mat.ndim == 1:
                H[idx, idx] -= mat[local(idx)]
                continue
            for jdx in range(dim):
                if (idx | mask) == (jdx | mask):
                    H[jdx, idx] -= mat[local(jdx), local(idx)]
    w = np.linalg.eigvalsh(H)
    z = np.exp(-beta * (w - w.min()))
    return float(((w - w.min()) * z).sum() / z.sum()) + w.min()


def measure(q, beta, warm, steps):
    """``-<n>/beta`` per replica over ``steps`` timesteps after ``warm``,
    with ``verify()`` after both."""
    for _ in range(warm):
        q.timestep(beta)
    assert q.verify()
    total_n = torch.zeros(q.replicas, dtype=torch.float64)
    for _ in range(steps):
        q.timestep(beta)
        total_n += q.get_n()
    assert q.verify()
    return (-(total_n / steps) / beta).numpy()


def xxz_chain(seed, cap=None):
    q = Qmc(3, replicas=256, seed=seed, do_loop_updates=True, device="cpu")
    if cap is not None:
        q.set_loop_cap(cap)
    for a in range(2):
        q.make_interaction(W_XXZ, [a, a + 1])
    assert not q.has_cluster_edges
    return q


def test_directed_loop_xxz_matches_exact_diag():
    """Only the directed loops make off-diagonal ops here."""
    beta = 1.2
    q = xxz_chain(seed=0)
    e = measure(q, beta, 30, 120)
    exact = exact_energy(3, q._interactions, beta)
    se = e.std() / np.sqrt(len(e))
    assert abs(e.mean() - exact) < max(4 * se, 0.08), (e.mean(), exact, se)
    assert q.loop_revert_rate() == 0.0


def test_loop_cap_revert_unbiased():
    """A forced cap of 16 hops reverts walks often, and the energy still
    matches ED: a loop and its reversal close within the cap alike."""
    beta = 1.2
    q = xxz_chain(seed=2, cap=16)
    for _ in range(40):
        q.timestep(beta)
    q.total_loop_reverts = q.total_loop_updates = 0
    e = measure(q, beta, 0, 150)
    rate = q.loop_revert_rate()
    assert 0.005 < rate < 0.95, f"the cap must fire (rate={rate})"
    exact = exact_energy(3, q._interactions, beta)
    se = e.std() / np.sqrt(len(e))
    assert abs(e.mean() - exact) < max(4 * se, 0.08), (e.mean(), exact, se, rate)


def test_tfim_via_interactions_matches_exact():
    """The TFIM's weight matrices through the generic engine (cluster
    update, no loops): E(offset 0) = <H_TFIM> - (sum|J| + N Gamma)."""
    L, beta, gamma = 4, 1.0, 1.0
    edges = lattice.chain(L, j=1.0, periodic=True)
    exact = exact_tfim_energy(edges, gamma, 0.0, beta, L)
    q = Qmc(L, replicas=256, seed=13, device="cpu")
    for (a, b), j in edges:
        q.make_diagonal_interaction([abs(j) - j, abs(j) + j, abs(j) + j, abs(j) - j], [a, b])
    for v in range(L):
        q.make_interaction(np.full((2, 2), gamma), [v])
    assert q.should_do_cluster_update()
    e = measure(q, beta, 60, 200) + sum(abs(j) for _, j in edges) + L * gamma
    se = e.std() / np.sqrt(len(e))
    assert abs(e.mean() - exact) < max(4 * se, 0.1), (e.mean(), exact, se)


def test_three_spin_model_with_loops_and_clusters_matches_exact():
    """A K=3 model: an Ising-symmetric diagonal 3-spin term on a 6-site
    ring and a transverse field, with loops and the cluster update."""
    w3 = np.array([1.5, 0.5, 1.0, 0.25, 0.25, 1.0, 0.5, 1.5])
    beta, n = 1.0, 6
    q = Qmc(n, replicas=128, seed=4, do_loop_updates=True, device="cpu")
    for a in range(n):
        q.make_diagonal_interaction_and_offset(w3, [a, (a + 1) % n, (a + 2) % n])
    for v in range(n):
        q.make_interaction(np.full((2, 2), 0.6), [v])
    assert q.model.max_legs == 3 and q.should_do_cluster_update()
    e = measure(q, beta, 30, 120) + q.get_offset()
    exact = exact_energy(n, q._interactions, beta) + q.get_offset()
    se = e.std() / np.sqrt(len(e))
    assert abs(e.mean() - exact) < max(4 * se, 0.08), (e.mean(), exact, se)


@pytest.mark.parametrize("h", [0.0, 0.3])
def test_into_qmc_keeps_the_string_valid(h):
    g = QmcIsingGraph(lattice.chain(4, j=1.0), 1.0, longitudinal=h, replicas=8, seed=21,
                      device="cpu")
    for _ in range(10):
        g.timestep(1.5)
    assert g.verify()
    q = g.into_qmc()
    assert q.verify()
    np.testing.assert_array_equal(q.get_n().numpy(), g.get_n().numpy())
    assert q.get_offset() == pytest.approx(g.get_offset())
    q.set_do_loop_updates(True)
    for _ in range(5):
        q.timestep(1.5)
        assert q.verify()


def test_into_qmc_statistically_equivalent():
    """``tests/convert_test.rs``'s analog: both engines sample one
    distribution, so their energies agree."""
    beta, t = 1.0, 150
    g = QmcIsingGraph(lattice.chain(4, j=1.0), 1.0, replicas=64, seed=2, device="cpu")
    q = g.into_qmc()
    q.set_do_loop_updates(True)
    e_ising = float(g.timesteps(t, beta).mean())
    e_qmc = float(q.timesteps(t, beta).mean())
    assert q.get_offset() == pytest.approx(g.get_offset())
    assert e_ising == pytest.approx(e_qmc, rel=0.15, abs=0.5)
