"""The port's classical engine (``isingmontecarlo_tpu_torch.classical``) on the
CPU against the JAX package: the same ``GraphTables`` (carried through
``convert``) and JAX's own uniforms, bit for bit where the arithmetic is
exact; statistical checks where the draws come from the port's generator."""

import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isingmontecarlo_tpu import lattice as jlat
from isingmontecarlo_tpu.classical import cluster as jcluster
from isingmontecarlo_tpu.classical import metropolis as jmetro
from isingmontecarlo_tpu_torch import GraphState, lattice
from isingmontecarlo_tpu_torch.classical import cluster as tcluster
from isingmontecarlo_tpu_torch.classical import make_random_spin_state
from isingmontecarlo_tpu_torch.classical import metropolis as tmetro
from isingmontecarlo_tpu_torch.classical import worm as tworm

from torch_port_utils import (
    assert_equal_where_decided,
    checkerboard_uniforms,
    decided_replicas,
    edge_flip_uniforms,
    np_,
    spin_flip_uniforms,
    swendsen_wang_draws,
    t_,
    torch_tables,
    wolff_draws,
)

from torch_port_utils import release_jax_executables  # noqa: F401  (autouse)

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _mixed_edges(L):
    """A periodic L x L lattice with couplings in {-1, -0.5, +1}: sums of
    them are exact in float32, so any summation order agrees."""
    rng = np.random.default_rng(L)
    return [(e, float(rng.choice([-1.0, -0.5, 1.0]))) for e, _ in lattice.square(L, L)]


GRAPHS = {
    "square4": (lattice.square(4, 4, j=-1.0), 0.0),
    "square6_h": (lattice.square(6, 6, j=-1.0), 0.5),
    "chain9_h": (lattice.chain(9, j=1.0), 0.5),
    "frustrated4": (lattice.frustrated_square(4, 4), 0.0),
    "mixed5_h": (_mixed_edges(5), 0.5),
}


def _both_tables(name):
    edges, h = GRAPHS[name]
    n = lattice.nvars_from_edges(edges)
    biases = [h if v % 3 else -h for v in range(n)]
    jt = jmetro.build_tables(edges, biases)
    return edges, biases, jt, torch_tables(jt)


def _spins(R, N, seed):
    return np.random.default_rng(seed).random((R, N)) < 0.5


def _assert_valid_colourings(t, nvars):
    ev = np_(t.edges)
    sc, ec = np_(t.site_color), np_(t.edge_color)
    assert (sc >= 0).all() and sc.max() + 1 == t.n_site_colors
    assert not (sc[ev[:, 0]] == sc[ev[:, 1]]).any(), "adjacent sites share a colour"
    for c in range(t.n_edge_colors):
        owner = np.full(nvars, -1)
        for e in np.flatnonzero(ec == c):
            for v in ev[e]:
                assert owner[v] < 0, "two edges of one colour share a vertex"
                owner[v] = e
        oa, ob = owner[ev[:, 0]], owner[ev[:, 1]]
        assert not ((oa >= 0) & (ob >= 0) & (oa != ob)).any(), \
            "edges of one colour are joined by an edge"
    assert [len(x) for x in t.site_classes] == np.bincount(sc).tolist()
    assert [len(x) for x in t.edge_classes] == np.bincount(ec).tolist()


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_build_tables_match_jax(name):
    edges, biases, jt, _ = _both_tables(name)
    t = tmetro.build_tables(edges, biases, device="cpu")
    for f in ("neigh", "nj", "biases", "edges", "ej"):
        np.testing.assert_array_equal(np_(getattr(t, f)), np.asarray(getattr(jt, f)), err_msg=f)
    assert t.has_bias == bool(np.any(np.asarray(biases) != 0))
    _assert_valid_colourings(t, len(biases))
    _assert_valid_colourings(torch_tables(jt), len(biases))


def test_colourings_of_the_256_lattice_are_valid():
    edges = lattice.square(256, 256, j=-1.0)
    t = tmetro.build_tables(edges, [0.0] * 256 ** 2, device="cpu")
    assert t.n_site_colors == 2
    _assert_valid_colourings(t, 256 ** 2)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_energy_and_local_field_match_jax(name):
    _, _, jt, t = _both_tables(name)
    s = _spins(6, len(np.asarray(jt.biases)), 3)
    np.testing.assert_array_equal(np_(tmetro.local_field(t_(s), t)),
                                  np.asarray(jmetro.local_field(jnp.asarray(s), jt)))
    np.testing.assert_array_equal(np_(tmetro.energy(t_(s), t)),
                                  np.asarray(jmetro.energy(jnp.asarray(s), jt)))
    np.testing.assert_array_equal(np_(tmetro.magnetization(t_(s))),
                                  np.asarray(jmetro.magnetization(jnp.asarray(s))))


def test_energy_matches_jax_with_random_couplings():
    rng = np.random.default_rng(4)
    edges = [(e, float(rng.normal())) for e, _ in lattice.square(5, 5)]
    biases = rng.normal(size=25).tolist()
    jt = jmetro.build_tables(edges, biases)
    s = _spins(8, 25, 5)
    # Summation order differs between XLA's einsum and torch's sum, so the
    # tolerance is 1e-6 of the magnitude of the summed terms (the totals
    # cancel to a few units).
    scale = np.abs(np.asarray(jt.nj)).sum(1)
    np.testing.assert_allclose(np_(tmetro.local_field(t_(s), torch_tables(jt))),
                               np.asarray(jmetro.local_field(jnp.asarray(s), jt)),
                               rtol=0, atol=1e-6 * scale.max())
    np.testing.assert_allclose(np_(tmetro.energy(t_(s), torch_tables(jt))),
                               np.asarray(jmetro.energy(jnp.asarray(s), jt)),
                               rtol=0, atol=1e-6 * (scale.sum() / 2 + np.abs(biases).sum()))


@pytest.mark.parametrize("j,h,tol", [(-1.0, 0.5, 0.0), (0.37, -1.3, 1e-6)])
def test_lattice_energy_matches_jax(j, h, tol):
    s = np.random.default_rng(6).random((5, 6, 6)) < 0.5
    np.testing.assert_allclose(np_(tmetro.lattice_energy(t_(s), j, h)),
                               np.asarray(jmetro.lattice_energy(jnp.asarray(s), j, h)),
                               rtol=tol)


@pytest.mark.parametrize("name", ["square4", "square6_h", "chain9_h", "mixed5_h"])
@pytest.mark.parametrize("per_replica_beta", [False, True])
def test_spin_flip_sweep_matches_jax(name, per_replica_beta):
    _, _, jt, t = _both_tables(name)
    R, N = 12, len(np.asarray(jt.biases))
    beta = np.linspace(0.1, 1.2, R).astype(np.float32) if per_replica_beta else 0.45
    s = _spins(R, N, 7)
    key = jax.random.key(len(name))
    u = spin_flip_uniforms(key, jt.n_site_colors, (R, N))
    want = jmetro.spin_flip_sweep(jnp.asarray(s), key, jnp.asarray(beta), jt)
    decided, got = decided_replicas(
        lambda uu: tmetro.spin_flip_sweep(t_(s), uu, t_(np.asarray(beta)), t), u)
    assert_equal_where_decided(got, want, decided)
    assert not np.array_equal(np_(got), s)


@pytest.mark.parametrize("name", ["square4", "square6_h", "chain9_h", "mixed5_h"])
@pytest.mark.parametrize("importance", [False, True])
def test_edge_flip_sweep_matches_jax(name, importance):
    _, _, jt, t = _both_tables(name)
    R, N, E = 12, len(np.asarray(jt.biases)), len(np.asarray(jt.ej))
    s = _spins(R, N, 8)
    key = jax.random.key(100 + len(name))
    attempt_p = None
    if importance:
        w = jnp.abs(jt.ej)
        attempt_p = w / jnp.max(w)
    want = jmetro.edge_flip_sweep(jnp.asarray(s), key, 0.3, jt, attempt_p=attempt_p)
    u, u_att = edge_flip_uniforms(key, jt.n_edge_colors, R, E, importance)
    p = None if attempt_p is None else t_(attempt_p)
    decided, got = decided_replicas(
        lambda uu, ua: tmetro.edge_flip_sweep(t_(s), uu, 0.3, t, attempt_p=p, u_attempt=ua),
        u, u_att if importance else torch.zeros(()))
    assert_equal_where_decided(got, want, decided)
    assert not np.array_equal(np_(got), s)


@pytest.mark.parametrize("h", [0.0, 0.5])
def test_checkerboard_sweep_matches_jax(h):
    R, L = 10, 6
    s = np.random.default_rng(9).random((R, L, L)) < 0.5
    key = jax.random.key(9)
    want = jmetro.checkerboard_sweep(jnp.asarray(s), key, jnp.float32(0.4),
                                     jnp.float32(-1.0), jnp.float32(h))
    decided, got = decided_replicas(
        lambda u: tmetro.checkerboard_sweep(t_(s), u, 0.4, -1.0, h),
        checkerboard_uniforms(key, (R, L, L)))
    assert_equal_where_decided(got, want, decided)


@pytest.mark.parametrize("p_active", [0.3, 0.6, 0.9])
def test_connected_components_match_jax(p_active):
    edges = lattice.square(7, 6)
    ev, _ = jlat.edge_arrays(edges)
    active = np.random.default_rng(int(10 * p_active)).random((8, len(edges))) < p_active
    want = jcluster._connected_components(jnp.asarray(active), jnp.asarray(ev), 42)
    got = tcluster._connected_components(t_(active), t_(ev), 42)
    np.testing.assert_array_equal(np_(got), np.asarray(want))


@pytest.mark.parametrize("name", ["square6_h", "frustrated4", "mixed5_h"])
def test_swendsen_wang_sweep_matches_jax(name):
    _, _, jt, t = _both_tables(name)
    R, N, E = 12, len(np.asarray(jt.biases)), len(np.asarray(jt.ej))
    s = _spins(R, N, 11)
    key = jax.random.key(11)
    want = jcluster.swendsen_wang_sweep(jnp.asarray(s), key, 0.5, jt)
    u_bond, coin, u_acc = swendsen_wang_draws(key, R, N, E)
    decided, got = decided_replicas(
        lambda ub, ua: tcluster.swendsen_wang_sweep(t_(s), ub, coin, ua, 0.5, t),
        u_bond, u_acc)
    assert_equal_where_decided(got, want, decided)


@pytest.mark.parametrize("name", ["square4", "frustrated4"])
def test_wolff_sweep_matches_jax(name):
    _, _, jt, t = _both_tables(name)
    R, N, E = 12, len(np.asarray(jt.biases)), len(np.asarray(jt.ej))
    s = _spins(R, N, 12)
    key = jax.random.key(12)
    want = jcluster.wolff_sweep(jnp.asarray(s), key, 0.6, jt)
    u_bond, seed_site = wolff_draws(key, R, N, E)
    decided, got = decided_replicas(
        lambda ub: tcluster.wolff_sweep(t_(s), ub, seed_site, 0.6, t), u_bond)
    assert_equal_where_decided(got, want, decided)
    assert not np.array_equal(np_(got), s)


def _draws(seed):
    return tmetro.GeneratorDraws(torch.Generator().manual_seed(seed))


def test_metropolis_and_swendsen_wang_runs_match_exact_chain_energy():
    """Open 16-site chain at beta=0.6: E = -(L-1) tanh(beta) per replica."""
    L, beta = 16, 0.6
    t = tmetro.build_tables(lattice.chain(L, j=1.0, periodic=False), [0.0] * L, device="cpu")
    exact = -(L - 1) * np.tanh(beta)
    s = _draws(0).coin((256, L))
    s, _ = tmetro.metropolis_run(s, _draws(1), beta, t, 100)
    _, es = tmetro.metropolis_run(s, _draws(2), beta, t, 150, measure=True)
    assert es.shape == (150, 256) and abs(float(es.mean()) - exact) < 0.3
    s, _ = tcluster.swendsen_wang_run(s, _draws(3), beta, t, 20)
    _, es = tcluster.swendsen_wang_run(s, _draws(4), beta, t, 100, measure=True)
    assert abs(float(es.mean()) - exact) < 0.3


def _coupling_energy(st, edges):
    e = np.zeros(st.shape[0])
    for (a, b), j in edges:
        e += j * (2.0 * st[:, a] - 1) * (2.0 * st[:, b] - 1)
    return e


@pytest.mark.parametrize("allow_doubles", [True, False])
def test_worm_preserves_coupling_energy_exactly(allow_doubles):
    """At h=0 a worm is a zero-dE walk closed by the move that cancels its
    first flip, or a full revert: the energy is unchanged exactly."""
    edges = lattice.frustrated_square(4, 4)
    t = tmetro.build_tables(edges, [0.0] * 16, device="cpu")
    draws = _draws(10)
    s = draws.coin((64, 16))
    moved = 0
    for _ in range(10):
        before = np_(s)
        s = tworm.worm_sweep(s, draws, 0.5, t, allow_doubles=allow_doubles)
        np.testing.assert_array_equal(np_(tmetro.energy(s, t)), np_(tmetro.energy(t_(before), t)))
        moved += int((np_(s) != before).any(axis=1).sum())
    assert moved > 0


def test_worm_keeps_coupling_energy_with_biases():
    """With biases the bias test gates whole net flips: the coupling energy
    stays exactly conserved by every worm sweep."""
    edges = [((0, 1), 1.0), ((1, 2), 1.0), ((2, 0), 1.0)]
    g = GraphState.new(edges, [0.4, 0.0, -0.3], replicas=64, seed=8, device="cpu")
    for _ in range(40):
        before = g.get_state()
        g.spins = tworm.worm_sweep(g.spins, g.draws, 1.0, g.tables)
        np.testing.assert_allclose(_coupling_energy(g.get_state(), edges),
                                   _coupling_energy(before, edges), atol=1e-5)


def test_worm_biased_matches_exact_enumeration():
    """The full move composition at h != 0 (worms on ~1/3 of steps) samples
    the exact Boltzmann distribution of a 3-site chain, as
    ``tests/test_classical.py::TestWormBiasConvention`` checks for JAX."""
    edges = [((0, 1), 1.0), ((1, 2), 1.0)]
    biases = [0.3, -0.2, 0.5]
    beta, R = 0.8, 512
    g = GraphState.new(edges, biases, replicas=R, seed=3, device="cpu")
    states = np.array([[bool(s >> v & 1) for v in range(3)] for s in range(8)])
    probe = GraphState.new_with_state(states, edges, biases, replicas=8, device="cpu")
    e_exact = np_(probe.get_energy()).astype(np.float64)
    w = np.exp(-beta * (e_exact - e_exact.min()))
    g.run_timesteps(60, beta)
    counts = np.zeros(8)
    for _ in range(240):
        g.do_time_step(beta)
        st = g.get_state()
        counts += np.bincount(st[:, 0] + 2 * st[:, 1] + 4 * st[:, 2], minlength=8)
    np.testing.assert_allclose(counts / counts.sum(), w / w.sum(), atol=0.02)


def test_should_flip():
    gen = torch.Generator().manual_seed(0)
    acc = GraphState.should_flip(gen, 1.0, [-1.0, 0.0, 1e9])
    assert acc.tolist() == [True, True, False]
    hits = GraphState.should_flip(gen, 1.0, torch.ones(4000)).float().mean()
    assert abs(float(hits) - np.exp(-1.0)) < 0.03


def test_graph_state_surface():
    L = 6
    edges = [((i, (i + 1) % L), -1.0) for i in range(L)]
    g = GraphState.new(edges, [0.0] * L, replicas=8, seed=3, device="cpu")
    e0 = float(g.get_energy().mean())
    for _ in range(30):
        g.do_spin_flip(3.0)
    assert float(g.get_energy().mean()) <= e0
    s = g.get_state()
    assert s.shape == (8, L) and s.dtype == bool
    assert np.array_equal(s, g.clone_state()) and g.state_ref().device.type == "cpu"
    g.enable_edge_importance_sampling(True)
    g.wolff_step(0.5)
    g.swendsen_wang_step(0.5)
    g.do_time_step(0.5, only_basic_moves=True)
    np.testing.assert_array_equal(np_(g.get_magnetization()), (2.0 * g.get_state() - 1).sum(1))
    g.set_state(np.ones(L, bool))
    assert np.allclose(np_(g.get_energy()), -L)

    lines = repr(GraphState.new([((0, 1), -1.0)], [0.0, 0.0], replicas=2, device="cpu")).splitlines()
    assert len(lines) == 2
    bits, energy = lines[0].split("\t")
    assert set(bits) <= {"0", "1"} and len(bits) == 2 and float(energy) in (-1.0, 1.0)

    gen = torch.Generator().manual_seed(4)
    st = make_random_spin_state(10, gen, replicas=3)
    assert st.shape == (3, 10) and st.dtype == torch.bool
    g2 = GraphState.new_with_state_and_rng(np.zeros(L, bool), edges, [0.0] * L, gen, replicas=2)
    assert g2.draws.generator is gen and not g2.get_state().any()


def test_graph_state_energy_matches_lattice_energy():
    """On a periodic square lattice the graph engine's energy equals the
    fast path's roll-based formula after each kind of move."""
    L = 6
    g = GraphState.new(lattice.square(L, L, j=-1.0), [0.0] * L * L, replicas=5,
                       seed=2, device="cpu")
    for step in (g.do_spin_flip, g.swendsen_wang_step, g.wolff_step):
        step(0.4)
        np.testing.assert_array_equal(
            np_(g.get_energy()), np_(tmetro.lattice_energy(g.spins.reshape(5, L, L), -1.0, 0.0)))


def test_port_never_imports_jax():
    """No file of the port, nor chip_smoke.py, imports jax or the JAX
    package, and the classical modules import with jax unavailable."""
    pat = re.compile(r"^\s*(import|from)\s+(jax|isingmontecarlo_tpu)(\.|\s|$)", re.M)
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "isingmontecarlo_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    offenders = [f for f in files if pat.search(open(f).read())]
    assert not offenders, offenders
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "from isingmontecarlo_tpu_torch import GraphState, LatticeIsing, convert\n"
        "from isingmontecarlo_tpu_torch.classical import cluster, graph_state, worm\n"
        "assert not [m for m in sys.modules if m.startswith('isingmontecarlo_tpu.')]\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)
