"""``QmcIsingGraph``'s entry points in the port against the JAX package's,
on the same carried op string and state (``lattice.square(3, 3)`` at Γ=1,
h=0: integer weights, so both packages' heat-bath tables agree exactly).

Counts, the debug text, ``hamiltonian``, ``HamInfo``, the imaginary-time
states and folds and every stepping call are exact; the stepping calls
replay JAX's draws from its key. Autocorrelations of the same sampled
states agree to ``rtol=1e-5``, ``atol=1e-6``: both are float32 FFTs, which
round in other orders, and the values near zero need the absolute part.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_utils import (
    MODEL_LEAVES, JaxChainDraws, JaxSweepDraws, assert_ops_equal, jax_opstring, np_,
    port_chain_state, torch_sse,
)

from isingmontecarlo_tpu import lattice
from isingmontecarlo_tpu.analysis import autocorr as jac
from isingmontecarlo_tpu.classical.graph_state import GraphState as JGraphState
from isingmontecarlo_tpu.sse import ising as jising
from isingmontecarlo_tpu_torch.analysis import autocorr as tac
from isingmontecarlo_tpu_torch.classical import GraphState as TGraphState
from isingmontecarlo_tpu_torch.sse import ising as tising

from torch_port_utils import release_jax_executables  # noqa: F401  (autouse)

torch.set_num_threads(1)

EDGES = lattice.square(3, 3)
R = 6


def _pair(seed=41):
    """A JAX and a port graph holding the same op string, state and caps."""
    bond, inputs, outputs, state = port_chain_state(EDGES, replicas=R, seed=seed,
                                                    nsweeps=8)
    gj = jising.QmcIsingGraph(EDGES, 1.0, replicas=R)
    gj.sse = jising.SseState(jax_opstring(bond, inputs, outputs), jnp.asarray(state),
                             jax.random.key(seed))
    gt = tising.QmcIsingGraph(EDGES, 1.0, replicas=R, device="cpu")
    gt.sse = torch_sse(gj.sse.ops, state)
    return gj, gt


def _assert_same(gj, gt):
    assert_ops_equal(gt.sse.ops, gj.sse.ops)
    np.testing.assert_array_equal(np_(gt.sse.state), np.asarray(gj.sse.state))


def _assert_same_model(gj, gt):
    for name in MODEL_LEAVES:
        np.testing.assert_array_equal(np_(getattr(gt.model, name)),
                                      np.asarray(getattr(gj.model, name)), err_msg=name)
    assert gt.model.offset == gj.model.offset


def test_constructors_match_jax():
    state = np.random.default_rng(0).random((R, 9)) < 0.5
    pairs = [
        (jising.new_qmc(EDGES, 0.8, 0.3, 40, replicas=R, state=state),
         tising.new_qmc(EDGES, 0.8, 0.3, 40, replicas=R, state=state, device="cpu")),
        (jising.QmcIsingGraph.new_with_rng(EDGES, 1.0, replicas=R, state=state[0]),
         tising.QmcIsingGraph.new_with_rng(EDGES, 1.0, replicas=R, state=state[0],
                                           device="cpu")),
        (jising.new_qmc_from_graph(JGraphState.new_with_state(state, EDGES, [0.0] * 9,
                                                              replicas=R), 0.5),
         tising.new_qmc_from_graph(TGraphState.new_with_state(state, EDGES, [0.0] * 9,
                                                              replicas=R, device="cpu"),
                                   0.5, device="cpu")),
        (jising.QmcIsingGraph.new_from_graph_state(
            JGraphState.new_with_state(state, EDGES, [0.0] * 9, replicas=R), 1.0, 0.2),
         tising.QmcIsingGraph.new_from_graph_state(
            TGraphState.new_with_state(state, EDGES, [0.0] * 9, replicas=R,
                                       device="cpu"), 1.0, 0.2, device="cpu")),
    ]
    for gj, gt in pairs:
        _assert_same(gj, gt)
        _assert_same_model(gj, gt)
        assert (gt.replicas, gt.nvars, gt.get_cutoff()) == (gj.replicas, gj.nvars,
                                                           gj.get_cutoff())
        assert gt.sse.state.device.type == "cpu"


def test_accessors_match_jax():
    gj, gt = _pair()
    assert gt.get_nvars() == gj.get_nvars() == 9
    assert gt.get_edges() == gj.get_edges()
    assert gt.get_transverse_field() == gj.get_transverse_field()
    assert gt.get_longitudinal_field() == gj.get_longitudinal_field()
    assert gt.get_offset() == gj.get_offset()
    assert gt.make_haminfo() == tising.HamInfo(*gj.make_haminfo())
    assert tuple(gt.make_haminfo()) == tuple(gj.make_haminfo())
    other = tising.QmcIsingGraph(EDGES, 1.0, 0.5, device="cpu").make_haminfo()
    assert gt.make_haminfo() == other  # edges and transverse field only
    assert gt.make_haminfo() != tising.QmcIsingGraph(EDGES, 0.5, device="cpu").make_haminfo()
    for b in range(gt.model.nbonds):
        for si in range(4):
            for so in range(4):
                legs_i = [si & 1, si >> 1]
                legs_o = [so & 1, so >> 1]
                assert gt.hamiltonian(b, legs_i, legs_o) == gj.hamiltonian(b, legs_i, legs_o)
    np.testing.assert_array_equal(np_(gt.get_n()), np.asarray(gj.get_n()))
    for b in (0, 5, 17, gt.model.nbonds - 1):
        np.testing.assert_array_equal(np_(gt.get_bond_count(b)),
                                      np.asarray(gj.get_bond_count(b)))
    for got, want in ((gt.clone_state(), gj.clone_state()),
                      (gt.into_vec(), gj.into_vec()),
                      (np_(gt.state_ref()), np.asarray(gj.state_ref()))):
        assert isinstance(got, np.ndarray)
        np.testing.assert_array_equal(got, want)
    assert_ops_equal(gt.get_manager_ref(), gj.get_manager_ref())
    assert gt.get_manager_mut() is gt.sse.ops

    gj.set_cutoff(gj.get_cutoff() + 21)
    gt.set_cutoff(gt.get_cutoff() + 21)
    gt.set_cutoff(8)  # shrinking is a no-op
    _assert_same(gj, gt)
    row = np.arange(9) % 2 == 0
    gj.set_state(row)
    gt.set_state(row)
    _assert_same(gj, gt)
    with gj.state_mut() as s:
        s[:, 3] = ~s[:, 3]
    with gt.state_mut() as s:
        s[:, 3] = ~s[:, 3]
    _assert_same(gj, gt)

    hj, ht = _pair(seed=42)
    assert gt.can_swap_managers(ht) and gj.can_swap_managers(hj)
    before = ht.sse
    gt.swap_manager_and_state(ht)
    gj.swap_manager_and_state(hj)
    _assert_same(gj, gt)
    _assert_same(hj, ht)
    assert gt.sse is before
    small = tising.QmcIsingGraph(lattice.chain(4), 1.0, replicas=R, device="cpu")
    assert not gt.can_swap_managers(small)
    with pytest.raises(ValueError):
        gt.swap_manager_and_state(small)


def test_debug_matches_jax(capsys):
    gj, gt = _pair()
    for got, want in zip(gt.count_diagonal_and_off(), gj.count_diagonal_and_off()):
        np.testing.assert_array_equal(np_(got), np.asarray(want))
    np.testing.assert_array_equal(np_(gt.count_constant_ops()),
                                  np.asarray(gj.count_constant_ops()))
    assert int(gt.count_diagonal_and_off()[1].sum()) > 0
    gt.print_debug(2)
    text_t = capsys.readouterr().out
    gj.print_debug(2)
    text_j = capsys.readouterr().out
    assert text_t == text_j
    assert text_t.count("\n") == gt.cutoff + 2


def test_imaginary_time_matches_jax():
    gj, gt = _pair()
    states = gt.imaginary_time_states()
    np.testing.assert_array_equal(np_(states), np.asarray(gj.imaginary_time_states()))
    assert states.shape == (gt.cutoff, R, 9)
    # Spins up per replica, summed over all slots; and every state handed to
    # the fold stays as it was handed.
    acc_j = gj.imaginary_time_fold(lambda acc, s: acc + s.sum(-1), jnp.zeros(R, jnp.int32))
    seen = []

    def fold(acc, s):
        seen.append(s)
        return acc + s.sum(-1)

    acc_t = gt.imaginary_time_fold(fold, torch.zeros(R, dtype=torch.int64))
    np.testing.assert_array_equal(np_(acc_t), np.asarray(acc_j))
    np.testing.assert_array_equal(np_(torch.stack(seen)), np_(states))


@pytest.mark.parametrize("heatbath", [False, True])
def test_single_steps_match_jax(heatbath):
    gj, gt = _pair()
    gj.set_enable_heatbath(heatbath)
    gt.set_enable_heatbath(heatbath)
    key, k_diag = jax.random.split(gj.sse.key)
    gt.draws = JaxSweepDraws(k_diag, None, None)
    gj.single_diagonal_step(1.3)
    gt.single_diagonal_step(1.3)
    _assert_same(gj, gt)
    assert gt.cutoff == gj.cutoff and gt._cluster_caps == gj._cluster_caps
    _, k_clust = jax.random.split(key)
    gt.draws = JaxSweepDraws(None, k_clust, None)
    before = gt.sse.state.clone()
    gj.single_cluster_step()
    gt.single_cluster_step()
    _assert_same(gj, gt)
    assert not torch.equal(before, gt.sse.state)
    assert gt.verify()


def test_sampling_and_autocorrelations_match_jax():
    """Every stepping call replays JAX's timesteps: the sampled states are
    equal, so the autocorrelations differ only by FFT rounding."""
    gj, gt = _pair()
    gj._maybe_grow()
    gt._maybe_grow()
    for g in (gj, gt):
        g._growth_pending, g._growth_stable = False, 2
    gt.draws = JaxChainDraws(gj.sse.key)
    T, freq = 8, 2

    states_j, e_j = gj.timesteps_sample(T, 1.0, freq)
    states_t, e_t = gt.timesteps_sample(T, 1.0, freq)
    assert states_t.shape == (T // freq, R, 9) and states_t.dtype == torch.bool
    np.testing.assert_array_equal(np_(states_t), states_j)
    np.testing.assert_allclose(np_(e_t), np.asarray(e_j), rtol=1e-6)
    _assert_same(gj, gt)

    calls_j, calls_t = [], []
    e_j = gj.timesteps_sample_iter(T, 1.0, freq, lambda s: calls_j.append(np.asarray(s)))
    e_t = gt.timesteps_sample_iter(T, 1.0, freq, lambda s: calls_t.append(np_(s)))
    assert len(calls_t) == len(calls_j) == T // freq
    np.testing.assert_array_equal(np.stack(calls_t), np.stack(calls_j))
    np.testing.assert_allclose(np_(e_t), np.asarray(e_j), rtol=1e-6)

    zipped_j, zipped_t = [], []
    gj.timesteps_sample_iter_zip(T, 1.0, freq, "ab",
                                 lambda z, s: zipped_j.append((z, np.asarray(s))))
    gt.timesteps_sample_iter_zip(T, 1.0, freq, "ab",
                                 lambda z, s: zipped_t.append((z, np_(s))))
    assert [z for z, _ in zipped_t] == [z for z, _ in zipped_j] == ["a", "b"]
    for (_, a), (_, b) in zip(zipped_t, zipped_j):
        np.testing.assert_array_equal(a, b)
    _assert_same(gj, gt)

    tol = dict(rtol=1e-5, atol=1e-6)
    mapper = lambda s: 2.0 * s[..., ::2] - 1.0  # noqa: E731
    products = [[0, 1], [2, 5, 7]]
    for name, args in (
        ("calculate_autocorrelation", (T, 1.0, 1, mapper)),
        ("calculate_variable_autocorrelation", (T, 1.0)),
        ("calculate_spin_product_autocorrelation", (T, 1.0, products)),
        ("calculate_bond_autocorrelation", (T, 1.0)),
    ):
        want = getattr(gj, name)(*args)
        got = getattr(gt, name)(*args)
        assert isinstance(got, np.ndarray) and got.shape == want.shape == (T,), name
        np.testing.assert_allclose(got, want, **tol, err_msg=name)
    _assert_same(gj, gt)

    # The analysis functions themselves on one set of states.
    s = np_(states_t)
    ev, ej = lattice.edge_arrays(EDGES)
    for got, want in (
        (tac.spin_autocorrelation(torch.from_numpy(s)), jac.spin_autocorrelation(s)),
        (tac.product_autocorrelation(s, products), jac.product_autocorrelation(s, products)),
        (tac.bond_autocorrelation(s, ev, ej), jac.bond_autocorrelation(s, ev, ej)),
        (tac.sample_autocorrelation(s, mapper), jac.sample_autocorrelation(jnp.asarray(s),
                                                                           mapper)),
        (tac.fft_autocorrelation(s[:, 0, 0] * 1.0),
         jac.fft_autocorrelation(jnp.asarray(s[:, 0, 0] * 1.0))),
    ):
        np.testing.assert_allclose(np_(got), np.asarray(want), **tol)
