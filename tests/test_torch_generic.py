"""The port's generic engine against the JAX package's on the same inputs
and draws (tiny shapes, one shape family):

- ``generic_model``'s tables, ``new_from_ops``, ``leg_valid``,
  ``is_diagonal``, ``worldline_maps`` and ``into_qmc``: exact
  (``worldline_maps`` also against the brute-force oracle of
  ``tests/test_worldline_maps.py``);
- ``loop_update`` on JAX's draws, at the default cap and at 16 hops:
  ``ops``, ``state`` and ``reverted`` exact in every replica whose exit
  choices do not change when the exit uniforms move by 4 ulp (a tie
  against the running sum of the weights, whose last ulp may differ); at
  most one such replica, and none expected;
- ``generic_multi_sweep`` chained over three timesteps on JAX's key tree,
  loops and cluster on and off, Metropolis and heat-bath (JAX's tables
  carried across), caps unset and set, at K=2 and K=3: exact;
- ``Qmc``'s surface (``tests/test_api_surface.py:252-337``,
  ``tests/test_sse.py:312-325``), and the bond autocorrelation of the same
  sampled states to ``rtol=1e-5``, ``atol=1e-6`` (float32 FFTs round in
  other orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_worldline_maps import brute_maps
from torch_port_utils import (
    MODEL_LEAVES, JaxGenericKeyDraws, JaxLoopDraws, assert_ops_equal, jax_opstring, np_,
    port_chain_state, torch_model,
)

from isingmontecarlo_tpu import lattice
from isingmontecarlo_tpu.sse import diagonal as jdiag
from isingmontecarlo_tpu.sse import ising as jising
from isingmontecarlo_tpu.sse import loops as jloops
from isingmontecarlo_tpu.sse import model as jmodel
from isingmontecarlo_tpu.sse import opstring as jops
from isingmontecarlo_tpu.sse import runner as jrunner
from isingmontecarlo_tpu_torch import convert
from isingmontecarlo_tpu_torch.sse import ising as tising
from isingmontecarlo_tpu_torch.sse import loops as tloops
from isingmontecarlo_tpu_torch.sse import model as tmodel
from isingmontecarlo_tpu_torch.sse import opstring as tops
from isingmontecarlo_tpu_torch.sse import runner as trunner

from torch_port_utils import release_jax_executables  # noqa: F401  (autouse)

torch.set_num_threads(1)

# The XXZ exchange of tests/test_sse.py:219-226.
W_XXZ = np.array([[0.5, 0, 0, 0], [0, 1.0, 0.7, 0], [0, 0.7, 1.0, 0], [0, 0, 0, 0.5]])
# An Ising-symmetric diagonal 3-spin weight: entry i equals entry ~i.
W3 = np.array([1.5, 0.5, 1.0, 0.25, 0.25, 1.0, 0.5, 1.5])
NV, R = 6, 8


def build_tfim(q):
    """A 6-site ring as interactions: clusters and loops both apply."""
    for a in range(NV):
        q.make_diagonal_interaction_and_offset([1.0, 0.0, 0.0, 1.0], [a, (a + 1) % NV])
    for v in range(NV):
        q.make_interaction(np.full((2, 2), 0.7), [v])


def build_xxz(q):
    """The XXZ ring: no cluster edges, only loops make off-diagonal ops."""
    for a in range(NV):
        q.make_interaction(W_XXZ, [a, (a + 1) % NV])


def build_k3(q):
    """Three-spin diagonal terms around the ring and a transverse field."""
    for a in range(NV):
        q.make_diagonal_interaction_and_offset(W3, [a, (a + 1) % NV, (a + 2) % NV])
    for v in range(NV):
        q.make_interaction(np.full((2, 2), 0.6), [v])


BUILDS = {"tfim": build_tfim, "xxz": build_xxz, "k3": build_k3}


def port_qmc(name, seed=3, steps=8, beta=1.2):
    """A port Qmc on the CPU after ``steps`` timesteps with loops."""
    q = trunner.Qmc(NV, replicas=R, seed=seed, do_loop_updates=True, device="cpu")
    BUILDS[name](q)
    for _ in range(steps):
        q.timestep(beta)
    return q


def jax_qmc(q):
    """A JAX Qmc with the port Qmc's interactions, offset, string and state."""
    jq = jrunner.Qmc(q.nvars, replicas=q.replicas, do_loop_updates=q.do_loop_updates)
    for mat, vars in q._interactions:
        jq._interactions.append((mat, vars))
    jq.offset = q.offset
    jq.has_cluster_edges = q.has_cluster_edges
    jq.breaks_ising_symmetry = q.breaks_ising_symmetry
    ops = q.get_manager_ref()
    jq._sse = jising.SseState(ops=jax_opstring(np_(ops.bond), np_(ops.inputs),
                                               np_(ops.outputs)),
                              state=jnp.asarray(q.clone_state()), key=jax.random.key(9))
    return jq


def assert_models_equal(tm, jm):
    for name in MODEL_LEAVES:
        want = np.asarray(getattr(jm, name))
        got = np_(getattr(tm, name))
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert (tm.offset, tm.nvars, tm.nbonds, tm.max_legs) == (
        jm.offset, jm.nvars, jm.nbonds, jm.max_legs)
    np.testing.assert_array_equal(np_(tm.arity()), np.asarray(jm.arity()))


@pytest.mark.parametrize("interactions,offset", [
    ([(np.full((2, 2), 0.3), [0]), (np.array([0.0, 1.0]), [1])], 0.0),
    ([(np.array([1.0, 0.2, 0.2, 1.0]), [0, 1]), (W_XXZ, [1, 2]),
      (np.full((2, 2), 0.7), [2])], 1.5),
    ([(W3, [0, 1, 2]), (W_XXZ, [2, 3]), (np.full((2, 2), 0.4), [3]),
      (np.arange(64, dtype=float).reshape(8, 8) / 64, [3, 1, 0]),
      (np.array([0.5, 2.0]), [1])], -0.25),
])
def test_generic_model_tables_equal_jax(interactions, offset):
    """K = 1, 2 and 3; diagonal and full matrices; with and without offsets."""
    jm = jmodel.generic_model(4, interactions, offset=offset)
    tm = tmodel.generic_model(4, interactions, offset=offset, device="cpu")
    assert_models_equal(tm, jm)


@pytest.mark.parametrize("interactions", [
    [(np.array([1.0, 0.2, 0.2]), [0, 1])],
    [(np.ones((4, 2)), [0, 1])],
    [(np.array([1.0, -0.1]), [0])],
    [(-np.ones((2, 2)), [0])],
])
def test_generic_model_rejects_what_jax_rejects(interactions):
    with pytest.raises(ValueError):
        jmodel.generic_model(2, interactions)
    with pytest.raises(ValueError):
        tmodel.generic_model(2, interactions, device="cpu")


def test_new_from_ops_leg_valid_is_diagonal_equal_jax():
    jm = jmodel.generic_model(3, [(W3, [0, 1, 2]), (W_XXZ, [0, 1]),
                                  (np.full((2, 2), 0.5), [2])])
    tm = torch_model(jm)
    per_rep = [
        [(0, 0, [1, 0, 1], [1, 0, 1]), (2, 1, [0, 1], [1, 0]), (5, 2, [1], [0])],
        [(1, 2, [0], [1]), (3, 1, [1, 1], [1, 1])],
    ]
    one = [(4, 1, [1, 0], [0, 1])]
    for args, kw in (((6, per_rep), dict(replicas=2, max_legs=3)),
                     ((6, one), dict(max_legs=3))):
        jo = jops.new_from_ops(*args, **kw)
        to = tops.new_from_ops(*args, **kw, device="cpu")
        assert_ops_equal(to, jo)
        np.testing.assert_array_equal(np_(tops.leg_valid(to, tm)),
                                      np.asarray(jops.leg_valid(jo, jm)))
        np.testing.assert_array_equal(np_(tops.is_diagonal(to)),
                                      np.asarray(jops.is_diagonal(jo)))
    with pytest.raises(ValueError):
        tops.new_from_ops(6, per_rep, replicas=3, max_legs=3, device="cpu")


def _maps_equal(to, tm, jo, jm):
    got = tops.worldline_maps(to, tm)
    want = jax.jit(jops.worldline_maps)(jo, jm)
    flat = lambda maps: [maps[0], maps[1], maps[2], *maps[3]]  # noqa: E731
    for g, w in zip(flat(got), flat(want)):
        assert np_(g).dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(np_(g), np.asarray(w))
    M, R_ = to.bond.shape
    bond, bv = np_(to.bond), np_(tm.bond_vars)
    for r in range(R_):
        bn, bp = brute_maps(bond[:, r], bv, M, to.max_legs)
        np.testing.assert_array_equal(np_(got[0][:, r]), bn)
        np.testing.assert_array_equal(np_(got[1][:, r]), bp)


def test_worldline_maps_equal_jax_on_a_tfim_string():
    edges = lattice.square(3, 3)
    bond, inputs, outputs, _ = port_chain_state(edges, transverse=0.8, longitudinal=0.4,
                                                replicas=R, seed=5, nsweeps=6)
    jm = jmodel.tfim_model(edges, 0.8, 0.4)
    jo = jax_opstring(bond, inputs, outputs)
    assert (bond >= 0).sum() > 40
    _maps_equal(convert.sse_state_from_numpy(bond=bond, inputs=inputs, outputs=outputs,
                                             state=np.zeros((R, 9), bool), device="cpu").ops,
                torch_model(jm), jo, jm)


def test_worldline_maps_equal_jax_on_a_k3_string():
    q = port_qmc("k3")
    ops = q.get_manager_ref()
    assert ops.max_legs == 3 and int(q.get_n().sum()) > 30
    jm = jmodel.generic_model(NV, q._interactions, offset=q.offset)
    _maps_equal(ops, q.model, jax_opstring(np_(ops.bond), np_(ops.inputs), np_(ops.outputs)),
                jm)


@pytest.mark.parametrize("name,cap", [("xxz", None), ("xxz", 16), ("k3", None)])
def test_loop_update_matches_jax(name, cap):
    q = port_qmc(name, beta=2.0)  # walks long enough for a cap of 16 to fire
    ops, state = q._sse
    jq = jax_qmc(q)
    key = jax.random.key(17)
    jo, js, jrev = jloops.loop_update(jq._sse.ops, jq._sse.state, key, jq.model,
                                      cap_hops=cap, return_stats=True)
    runs = [tloops.loop_update(ops, state, JaxLoopDraws(key, scale), q.model, cap_hops=cap)
            for scale in (1.0, 1 - 4 * 2.0 ** -23, 1 + 4 * 2.0 ** -23)]

    def per_replica(run):
        o, s, rev = run
        return torch.cat([o.inputs.permute(2, 0, 1).reshape(R, -1),
                          o.outputs.permute(2, 0, 1).reshape(R, -1), s, rev[:, None]], 1)

    base = per_replica(runs[0])
    decided = torch.ones(R, dtype=torch.bool)
    for other in runs[1:]:
        decided &= (per_replica(other) == base).all(dim=1)
    n_ties = int((~decided).sum())
    print(f"{n_ties} replicas excluded for an exit-weight tie")
    assert n_ties <= 1, f"{n_ties} replicas tie an exit weight sum"
    want = torch.cat([torch.from_numpy(np.asarray(jo.inputs)).permute(2, 0, 1).reshape(R, -1),
                      torch.from_numpy(np.asarray(jo.outputs)).permute(2, 0, 1).reshape(R, -1),
                      torch.from_numpy(np.asarray(js)),
                      torch.from_numpy(np.asarray(jrev))[:, None]], 1)
    np.testing.assert_array_equal(np_(base[decided]), np_(want[decided]))
    np.testing.assert_array_equal(np_(runs[0][0].bond), np.asarray(jo.bond))
    assert bool(np.asarray(jops.verify(jo, js, jq.model)).all())
    if cap is not None:
        assert np_(runs[0][2]).any(), "the cap must revert some walk"
    else:
        assert not np_(runs[0][2]).any()


@pytest.mark.parametrize("name,loops,heatbath,caps,loop_cap", [
    ("tfim", True, False, None, None),
    ("tfim", True, True, (256, 256), 4),
    ("tfim", False, False, None, None),
    ("xxz", True, False, None, None),
    ("k3", True, False, None, None),
])
def test_generic_multi_sweep_matches_jax(name, loops, heatbath, caps, loop_cap):
    q = port_qmc(name)
    jq = jax_qmc(q)
    do_cluster = q.should_do_cluster_update()
    assert do_cluster == jq.should_do_cluster_update() == (name != "xxz")
    hb_j = jdiag.make_heatbath_tables(jq.model) if heatbath else None
    hb_t = (convert.heatbath_tables_from_numpy(np.asarray(hb_j.cum_max_w),
                                               np.asarray(hb_j.total), "cpu")
            if heatbath else None)
    sse_j, (ns_j, rev_j) = jrunner.generic_multi_sweep(
        jq._sse, jnp.float32(1.2), jq.model, 3, do_loops=loops, do_cluster=do_cluster,
        heatbath=heatbath, hb=hb_j, cluster_caps=caps, loop_cap=loop_cap)
    sse_t, ns_t, rev_t = trunner.generic_multi_sweep(
        q._sse, 1.2, q.model, 3, JaxGenericKeyDraws(jq._sse.key).next, do_loops=loops,
        do_cluster=do_cluster, heatbath=heatbath, hb=hb_t, cluster_caps=caps,
        loop_cap=loop_cap)
    assert_ops_equal(sse_t.ops, sse_j.ops)
    np.testing.assert_array_equal(np_(sse_t.state), np.asarray(sse_j.state))
    np.testing.assert_array_equal(np_(ns_t), np.asarray(ns_j))
    np.testing.assert_array_equal(np_(rev_t), np.asarray(rev_j))
    if loop_cap is not None:
        assert np_(rev_t).any()


@pytest.mark.parametrize("h", [0.0, 0.3])
def test_into_qmc_equals_jax(h):
    edges = lattice.chain(4, j=1.0)
    bond, inputs, outputs, state = port_chain_state(edges, longitudinal=h, replicas=R,
                                                    seed=21, nsweeps=10)
    gj = jising.QmcIsingGraph(edges, 1.0, longitudinal=h, replicas=R)
    gj.sse = gj.sse._replace(ops=jax_opstring(bond, inputs, outputs),
                             state=jnp.asarray(state))
    gt = tising.QmcIsingGraph(edges, 1.0, longitudinal=h, replicas=R, device="cpu")
    gt.sse = convert.sse_state_from_numpy(bond=bond, inputs=inputs, outputs=outputs,
                                          state=state, device="cpu")
    qj, qt = gj.into_qmc(), gt.into_qmc()
    assert_models_equal(qt.model, qj.model)
    assert qt.get_offset() == qj.get_offset()
    assert_ops_equal(qt.get_manager_ref(), qj.get_manager_ref())
    np.testing.assert_array_equal(qt.clone_state(), qj.clone_state())
    assert (qt.has_cluster_edges, qt.breaks_ising_symmetry, qt.device) == (
        qj.has_cluster_edges, qj.breaks_ising_symmetry, torch.device("cpu"))
    assert qt.verify()
    # The random stream carries over: the graph and its Qmc draw alike.
    np.testing.assert_array_equal(np_(gt.draws.diagonal((2, 3))), np_(qt.draws.diagonal((2, 3))))


def test_qmc_from_numpy_carries_a_jax_qmc():
    jq = jax_qmc(port_qmc("k3"))
    ops = jq._sse.ops
    qt = convert.qmc_from_numpy(jq.nvars, jq._interactions, jq.offset,
                                bond=np.asarray(ops.bond), inputs=np.asarray(ops.inputs),
                                outputs=np.asarray(ops.outputs),
                                state=np.asarray(jq._sse.state), device="cpu")
    assert_models_equal(qt.model, jq.model)
    assert_ops_equal(qt.get_manager_ref(), ops)
    assert (qt.has_cluster_edges, qt.breaks_ising_symmetry) == (
        jq.has_cluster_edges, jq.breaks_ising_symmetry)
    assert qt.verify()


def test_interaction_surface_equals_jax():
    """``tests/test_api_surface.py:307-337`` on both packages."""
    for pkg in (jrunner, trunner):
        q = (pkg.Qmc(3, replicas=2, seed=2) if pkg is jrunner
             else pkg.Qmc(3, replicas=2, seed=2, device="cpu"))
        q.make_diagonal_interaction(np.array([1.0, 0.25, 0.5, 1.0]), [0, 1])
        q.make_interaction(np.full((2, 2), 0.7), [2])
        diag, const = q.get_bonds()
        assert not diag.is_constant() and not diag.is_constant_diag()
        assert diag.at([True, False], [True, False]) == pytest.approx(0.5)
        assert diag.at([False, True], [False, True]) == pytest.approx(0.25)
        assert diag.at([True, False], [False, True]) == 0.0
        assert not diag.sym_under_ising()
        assert const.is_constant() and const.is_constant_diag()
        assert const.at([True], [False]) == pytest.approx(0.7)
        assert const.sym_under_ising()
        with pytest.raises(ValueError):
            diag.at([True], [True])
        sym = pkg.Interaction(np.array([1.0, 0.0, 0.0, 1.0]), [0, 1])
        assert sym.sym_under_ising() and sym.diagonal
    for mat, k in ((W3, 3), (W_XXZ, 2), (np.array([1.0, 2.0, 2.0, 3.0]), 2),
                   (np.arange(16.0).reshape(4, 4), 2)):
        assert trunner.sym_under_ising(mat, k) == jrunner._sym_under_ising(mat, k)


def test_detection_flags_and_errors_equal_jax():
    """``tests/test_sse.py:312-325`` and the ``ValueError``s."""
    def flags(q):
        return q.breaks_ising_symmetry, q.has_cluster_edges, q.should_do_cluster_update()

    cases = [
        lambda q: q.make_diagonal_interaction([1.0, 2.0, 2.0, 1.0], [0, 1]),
        lambda q: q.make_diagonal_interaction([1.0, 2.0, 2.0, 3.0], [0, 1]),
        lambda q: q.make_interaction(np.full((2, 2), 0.5), [0]),
        lambda q: (q.make_interaction(np.full((2, 2), 0.5), [0]),
                   q.make_diagonal_interaction_and_offset([-1.0, 1.0], [1])),
        lambda q: q.make_interaction_and_offset(W_XXZ + 0.2, [0, 1]),
    ]
    for build in cases:
        jq = jrunner.Qmc(2, replicas=2, seed=14)
        tq = trunner.Qmc(2, replicas=2, seed=14, device="cpu")
        build(jq)
        build(tq)
        assert flags(tq) == flags(jq)
        assert tq.get_offset() == jq.get_offset()
        for (mt, vt), (mj, vj) in zip(tq._interactions, jq._interactions):
            np.testing.assert_array_equal(mt, mj)
            assert vt == vj
    for bad in (lambda q: q.make_diagonal_interaction([1.0, 2.0, 3.0], [0, 1]),
                lambda q: q.make_interaction(np.ones((3, 3)), [0]),
                lambda q: q.make_interaction(-np.ones((2, 2)), [0]),
                lambda q: q.make_diagonal_interaction([1.0, 0.2, 0.2, 1.0], [0, 1])
                or q.cluster_update()):
        for q in (jrunner.Qmc(2, replicas=2), trunner.Qmc(2, replicas=2, device="cpu")):
            with pytest.raises(ValueError):
                bad(q)
    with pytest.raises(ValueError):
        trunner.Qmc(2, replicas=2, device="cpu").model


def test_qmc_accessors_cutoff_and_swap():
    """``tests/test_api_surface.py:252-301`` on the port."""
    q = trunner.Qmc(4, replicas=8, seed=5, do_loop_updates=True, device="cpu")
    for a, b in [(0, 1), (1, 2), (2, 3), (3, 0)]:
        q.make_diagonal_interaction_and_offset(np.array([1.0, 0.0, 0.0, 1.0]), [a, b])
    for v in range(4):
        q.make_interaction(np.full((2, 2), 0.7), [v])
    for _ in range(4):
        q.diagonal_update(1.5)
        assert q.verify()
    q.cluster_update()
    q.loop_update()
    q.flip_free_bits()
    assert q.verify()
    assert q.total_loop_updates == 8 and q.loop_revert_rate() == 0.0
    assert q.should_do_loop_update() and not q.should_do_heatbath()
    q.set_do_heatbath(True)
    assert q.should_do_heatbath()
    q.timestep(1.5)
    bonds = q.get_bonds()
    assert len(bonds) == 8 and bonds[0].vars == [0, 1]
    assert q.get_offset() == q.model.offset == 0.0
    m0 = q.get_cutoff()
    q.set_cutoff(m0 + 16)
    assert q.get_cutoff() == m0 + 16
    q.increase_cutoff_to(m0 + 32)
    assert q.get_cutoff() == m0 + 32 and q.verify()
    s = q.clone_state()
    assert s.shape == (8, 4) and s.dtype == bool
    assert np.array_equal(q.into_vec(), s)
    np.testing.assert_array_equal(np_(q.state_ref()), s)
    n = np_(q.get_n())
    counts = sum(np_(q.get_bond_count(b)) for b in range(q.model.nbonds))
    np.testing.assert_array_equal(counts, n)

    other = trunner.Qmc(4, replicas=8, seed=6, device="cpu")
    for a, b in [(0, 1), (1, 2), (2, 3), (3, 0)]:
        other.make_diagonal_interaction_and_offset(np.array([1.0, 0.0, 0.0, 1.0]), [a, b])
    for v in range(4):
        other.make_interaction(np.full((2, 2), 0.9), [v])
    assert q.can_swap_managers(other)
    ops_q = q.get_manager_ref()
    q.swap_manager_and_state(other)
    assert other.get_manager_ref() is ops_q and q.get_cutoff() == 8
    small = trunner.Qmc(3, replicas=8, device="cpu")
    small.make_interaction(np.full((2, 2), 0.5), [0])
    assert not q.can_swap_managers(small)
    with pytest.raises(ValueError):
        q.swap_manager_and_state(small)

    seen = []
    e = q.timesteps_sample_iter_zip(6, 1.0, 2, ["a", "b"], lambda z, st: seen.append(z))
    assert seen == ["a", "b"] and e.shape == (8,)
    states, e = q.timesteps_sample(4, 1.0, 2)
    assert states.shape == (2, 8, 4) and e.shape == (8,)
    total = q.imaginary_time_fold(lambda acc, st: acc + st.sum(), 0)
    assert int(total) == int(tops.itime_states(q.get_manager_ref(), q.state_ref(),
                                                q.model).sum())


def test_bond_autocorrelation_equals_jax_on_the_same_states():
    q = port_qmc("k3")
    jq = jax_qmc(q)
    states = np.random.default_rng(4).random((16, R, NV)) < 0.5
    jq.timesteps_sample = lambda t, beta, freq=None: (states, None)
    q.timesteps_sample = lambda t, beta, freq=None: (torch.from_numpy(states), None)
    want = jq.calculate_bond_autocorrelation(16, 1.0)
    got = q.calculate_bond_autocorrelation(16, 1.0)
    assert got.shape == (16,)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_verify_equals_jax_on_a_bond_that_names_a_variable_twice():
    """A bond on ``[0, 0]`` (``make_interaction(mat, [0, 0])`` builds one in
    both packages): every leg of a slot reads the value below the slot and
    the last leg's output carries on, as JAX's scan has it. Each replica
    holds one case, among them strings that JAX accepts and a leg-by-leg
    check rejects, and the other way round."""
    mat = np.full((4, 4), 0.5) + np.eye(4)  # off-diagonal, every element positive
    jm = jmodel.generic_model(2, [(mat, [0, 0]), (W_XXZ, [0, 1])])
    tm = torch_model(jm)
    cases = [  # (state of var 0 and var 1, ops)
        ((0, 0), [(0, 0, [0, 0], [1, 0])]),  # both legs read 0; the last writes 0
        ((0, 0), [(0, 0, [0, 0], [0, 1])]),  # ends at 1: not periodic
        ((0, 0), [(0, 0, [0, 1], [0, 0])]),  # leg 1 reads 1 below the slot
        ((0, 0), [(0, 0, [0, 1], [1, 0])]),  # leg 1 reads leg 0's output, not the state
        ((0, 1), [(0, 0, [0, 0], [1, 1]), (3, 0, [1, 1], [0, 0])]),
        ((0, 0), [(0, 0, [0, 0], [1, 0]), (2, 0, [0, 0], [0, 0])]),
        ((1, 0), [(1, 0, [1, 0], [1, 1])]),
        ((1, 0), [(0, 1, [1, 0], [0, 1]), (2, 0, [0, 0], [1, 0]), (4, 1, [0, 1], [1, 0])]),
    ]
    states = np.array([s for s, _ in cases], bool)
    ops = [o for _, o in cases]
    jo = jops.new_from_ops(6, ops, replicas=len(cases), max_legs=2)
    to = tops.new_from_ops(6, ops, replicas=len(cases), max_legs=2, device="cpu")
    want = np.asarray(jops.verify(jo, jnp.asarray(states), jm))
    got = np_(tops.verify(to, torch.from_numpy(states), tm))
    np.testing.assert_array_equal(got, want)
    assert want.tolist() == [True, False, False, False, True, True, False, True]


@pytest.mark.parametrize("name", list(BUILDS))
def test_verify_equals_jax_on_the_generic_strings(name):
    """The port's ``verify`` gives JAX's verdict per replica on each model's
    string and on copies broken in some replicas: an op's output leg, a
    p=0 spin or an input leg flipped."""
    q = port_qmc(name)
    jq = jax_qmc(q)
    ops = q.get_manager_ref()
    bond, inputs, outputs = (np_(a).copy() for a in ops)
    state = q.clone_state()
    rng = np.random.default_rng(len(name))
    occupied = np.argwhere(bond >= 0)  # (p, r)
    for r, arr in ((1, outputs), (3, inputs)):
        p = occupied[occupied[:, 1] == r][rng.integers(0, (occupied[:, 1] == r).sum())][0]
        arr[0, p, r] ^= True
    state[5, rng.integers(0, NV)] ^= True
    for b, i, o, s in ((*(np_(a) for a in ops), q.clone_state()), (bond, inputs, outputs, state)):
        want = np.asarray(jops.verify(jax_opstring(b, i, o), jnp.asarray(s), jq.model))
        got = np_(tops.verify(tops.OpString(*(torch.from_numpy(a) for a in (b, i, o))),
                              torch.from_numpy(s), q.model))
        np.testing.assert_array_equal(got, want)
    assert want.any() and not want.all()
