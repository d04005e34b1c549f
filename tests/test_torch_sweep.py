"""The port's whole timestep against the JAX package, and the port's own
chain against exact diagonalization.

- ``sweep`` chained over several steps and ``multi_sweep(cluster_every=k)``
  with JAX's draws reproduced from its key: exact at h = 0.
- The port's chain (a ``torch.Generator``) on an 8-site TFIM chain:
  energy within 5 standard errors of ED, ``verify()`` after every step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_sse import exact_tfim_energy
from torch_port_utils import (
    JaxKeyDraws, assert_ops_equal, jax_graph, np_, t_, torch_model, torch_sse,
)

from isingmontecarlo_tpu import lattice
from isingmontecarlo_tpu.sse import ising as jising
from isingmontecarlo_tpu.sse import opstring as jops
from isingmontecarlo_tpu_torch.sse import ising as tising

from torch_port_utils import release_jax_executables  # noqa: F401  (autouse)

torch.set_num_threads(1)


def _assert_state_equal(got, want):
    assert_ops_equal(got.ops, want.ops)
    np.testing.assert_array_equal(np_(got.state), np.asarray(want.state))


@pytest.mark.parametrize("cutoff,caps", [(96, None), (512, (256, 256))])
def test_chained_sweeps_match_jax(cutoff, caps):
    """Cap-less sweeps label at full size; with caps and a large cutoff the
    cluster update takes the compact branch."""
    g = jax_graph(lattice.square(3, 3), transverse=1.0, replicas=8, seed=21,
                  nsweeps=4, cutoff=96)
    sse_j = g.sse._replace(ops=jops.grow(g.sse.ops, cutoff))
    tm = torch_model(g.model)
    sse_t = torch_sse(sse_j.ops, sse_j.state)
    src = JaxKeyDraws(sse_j.key)
    for _ in range(3):
        sse_j, _ = jising.sweep(sse_j, jnp.float32(1.0), g.model, cluster_caps=caps)
        sse_t, succ = tising.sweep(sse_t, 1.0, tm, src.next(), cluster_caps=caps)
        _assert_state_equal(sse_t, sse_j)
        assert not succ.any()  # RVB off
    assert bool(np.asarray(jops.verify(sse_j.ops, sse_j.state, g.model)).all())


def test_thinned_multi_sweep_matches_jax():
    g = jax_graph(lattice.chain(8), transverse=1.0, replicas=8, seed=22,
                  beta=1.5, nsweeps=4, cutoff=64)
    g._maybe_grow()
    caps = g._cluster_caps
    sse_j, ns_j, states_j, succ_j = jising.multi_sweep(
        g.sse, jnp.float32(1.5), g.model, 5, cluster_caps=caps,
        cluster_every=2, collect_states=True,
    )
    sse_t, ns_t, states_t, succ_t = tising.multi_sweep(
        torch_sse(g.sse.ops, g.sse.state), 1.5, torch_model(g.model), 5,
        JaxKeyDraws(g.sse.key).next, cluster_caps=caps, cluster_every=2,
        collect_states=True,
    )
    _assert_state_equal(sse_t, sse_j)
    np.testing.assert_array_equal(np_(ns_t), np.asarray(ns_j))
    np.testing.assert_array_equal(np_(states_t), np.asarray(states_j))
    np.testing.assert_array_equal(np_(succ_t), np.asarray(succ_j))


def test_resample_free_spins_matches_jax():
    g = jax_graph(lattice.chain(8), transverse=0.3, replicas=16, seed=23,
                  beta=0.3, nsweeps=3, cutoff=32)
    key = jax.random.key(4)
    want = jising.resample_free_spins(g.sse, key, g.model)
    R, N = g.sse.state.shape
    got = tising.resample_free_spins(
        torch_sse(g.sse.ops, g.sse.state), t_(jax.random.bernoulli(key, 0.5, (R, N))),
        torch_model(g.model),
    )
    np.testing.assert_array_equal(np_(got.state), np.asarray(want.state))
    assert not np.array_equal(np.asarray(want.state), np.asarray(g.sse.state))


def test_port_chain_matches_exact_diagonalization():
    edges = lattice.chain(8)
    beta, gamma = 1.0, 1.0
    g = tising.QmcIsingGraph(edges, gamma, replicas=128, seed=7, device="cpu")
    g.set_cluster_every(2)
    for _ in range(30):
        g.timestep(beta)
        assert g.verify()
    g.timesteps(20, beta)  # chunked, thinned
    assert g.verify()
    total_n = torch.zeros(128, dtype=torch.float64)
    steps = 150
    for _ in range(steps):
        g.timestep(beta)
        assert g.verify()
        total_n += g.get_n()
    e = g.get_energy_for_average_n(total_n / steps, beta).numpy()
    exact = exact_tfim_energy(edges, gamma, 0.0, beta, 8)
    se = e.std() / np.sqrt(len(e))
    assert abs(e.mean() - exact) < 5 * se, (e.mean(), exact, se)
    n_max = int(g.get_n().max())
    assert g.cutoff >= n_max + n_max // 2
