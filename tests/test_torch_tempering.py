"""The port's parallel tempering and its signed-ladder SSE layer against the
JAX package's on the same inputs and draws (tiny shapes), and the JAX
package's tempering oracles run on the port's own chains:

- ``tempering_step`` and ``candidate_partner`` on the same uniforms:
  ``perm`` and the swap count equal, for unsigned, per-bond and signed
  pairs, both parities;
- ``log_relative_weight`` and ``log_weight_delta``: within 1e-5 relative
  (sums of float32 logs taken in other orders), the zero flags equal;
- ``op_weights`` and ``verify`` under ``bond_xor``: equal;
- ``sweep`` with ``bond_xor`` on JAX's draws, Metropolis and heat-bath:
  bit-equal;
- ``tempering_sweep_chunk`` on JAX's key chain (``k_next, k_swap =
  split(key)`` after each timestep): op strings, states, labels, heat-bath
  tables, parity, swap count and samples bit-equal, for a homogeneous, a
  heterogeneous heat-bath and a signed ladder;
- ``tempering_from_numpy`` carries a JAX container across;
- the oracles of ``tests/test_tempering_autocorr.py`` and
  ``tests/test_tempering_hetero.py`` (not the sharded one), with their
  tolerances.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_utils import (
    JaxKeyDraws, assert_ops_equal, jax_opstring, np_, t_, torch_model, torch_sse,
)

from isingmontecarlo_tpu import lattice
from isingmontecarlo_tpu.parallel import tempering as jpt
from isingmontecarlo_tpu.sse import diagonal as jdiag
from isingmontecarlo_tpu.sse import ising as jising
from isingmontecarlo_tpu.sse import model as jmodel
from isingmontecarlo_tpu.sse import opstring as jops
from isingmontecarlo_tpu_torch import convert
from isingmontecarlo_tpu_torch.analysis import (
    bond_autocorrelation, effective_sample_size, fft_autocorrelation,
    integrated_autocorrelation_time, spin_autocorrelation,
)
from isingmontecarlo_tpu_torch.parallel import TemperingContainer
from isingmontecarlo_tpu_torch.parallel import tempering as tpt
from isingmontecarlo_tpu_torch.sse import diagonal as tdiag
from isingmontecarlo_tpu_torch.sse import ising as tising
from isingmontecarlo_tpu_torch.sse import opstring as tops
from isingmontecarlo_tpu_torch.sse.model import tfim_model

from torch_port_utils import release_jax_executables  # noqa: F401  (autouse)

torch.set_num_threads(1)

R = 8
RING = lattice.chain(4, j=1.0)
# Sign patterns of the 4-site ring: a, and b with edges 0 and 2 flipped;
# with h != 0 pattern b also flips the field (bonds NE + N onward).
FLIP = (0, 2)


def disorder_edges(pattern):
    """The 4-site ring with a per-bond coupling pattern."""
    return [(e, j * p) for (e, j), p in zip(RING, pattern)]


def sign_patterns(nbonds: int, h: bool, flip=FLIP) -> np.ndarray:
    """``i32[R, NB]``: replicas alternate between patterns a and b."""
    x = np.zeros((R, nbonds), np.int32)
    x[1::2, list(flip)] = 1
    if h:
        x[1::2, 8:] = 1
    return x


def signed_string(longitudinal: float, xors: np.ndarray, beta=1.0, nsweeps=12, seed=4):
    """Numpy ``(bond, inputs, outputs, state)`` of the port's own chain on
    the ring with each replica under its sign pattern: a string that is
    valid under every replica's label, made without compiling JAX."""
    g = tising.QmcIsingGraph(RING, 1.0, longitudinal, replicas=R, seed=seed, device="cpu")
    x = torch.from_numpy(xors)
    for _ in range(nsweeps):
        g.sse, _ = tising.sweep(g.sse, beta, g.model, g.draws, bond_xor=x)
        g._maybe_grow()
    assert bool(tops.verify(g.sse.ops, g.sse.state, g.model, x).all())
    ops = g.sse.ops
    return tuple(np_(a) for a in (ops.bond, ops.inputs, ops.outputs, g.sse.state))


def jax_sse(arrays, seed: int):
    bond, inputs, outputs, state = arrays
    return jising.SseState(ops=jax_opstring(bond, inputs, outputs), state=jnp.asarray(state),
                           key=jax.random.key(seed))


# -- the swap ---------------------------------------------------------------------


@pytest.mark.parametrize("parity", [0, 1])
@pytest.mark.parametrize("kind", ["unsigned", "per_bond", "signed"])
def test_tempering_step_matches_jax(kind, parity):
    rng = np.random.default_rng(7 + parity)
    nb = 8
    betas = np.repeat(rng.uniform(0.5, 1.5, R // 2), 2).astype(np.float32)  # ties
    key = jax.random.key(11 + parity)
    u = t_(jax.random.uniform(key, (R,)))
    kw_j, kw_t = {}, {}
    if kind == "signed":
        xors = sign_patterns(nb, False)
        arrays = signed_string(0.0, xors)
        scales = rng.uniform(0.8, 1.2, (R, nb)).astype(np.float32)
        jm = jmodel.tfim_model(RING, 1.0)
        kw_j = dict(ops=jax_opstring(*arrays[:3]), model=jm, scales=jnp.asarray(scales),
                    xors=jnp.asarray(xors))
        kw_t = dict(ops=torch_sse(jax_opstring(*arrays[:3]), arrays[3]).ops,
                    model=torch_model(jm), scales=t_(scales), xors=t_(xors))
        n = (arrays[0] >= 0).sum(0).astype(np.int32)
    else:
        n = rng.integers(5, 40, R).astype(np.int32)
    args_j = [jnp.asarray(n), jnp.asarray(betas), key, parity]
    args_t = [t_(n), t_(betas), u, parity]
    if kind == "per_bond":
        n_class = rng.integers(0, 6, (R, nb)).astype(np.int32)
        log_c = np.log(rng.uniform(0.7, 1.4, (R, nb))).astype(np.float32)
        args_j += [jnp.asarray(n_class), jnp.asarray(log_c)]
        args_t += [t_(n_class), t_(log_c)]
    perm_j, sw_j = jpt.tempering_step(*args_j, **kw_j)
    perm_t, sw_t = tpt.tempering_step(*args_t, **kw_t)
    np.testing.assert_array_equal(np_(perm_t), np.asarray(perm_j))
    assert int(sw_t) == int(sw_j)
    assert perm_t.dtype == torch.int32 and sorted(np_(perm_t)) == list(range(R))
    np.testing.assert_array_equal(
        np_(tpt.candidate_partner(t_(betas), parity)),
        np.asarray(jpt.candidate_partner(jnp.asarray(betas), parity)))


@pytest.mark.parametrize("h", [0.0, 0.4])
def test_log_weights_under_labels_match_jax(h):
    xors = sign_patterns(12 if h else 8, bool(h))
    arrays = signed_string(h, xors)
    jm = jmodel.tfim_model(RING, 1.0, h)
    jm_b = jmodel.tfim_model([(e, 1.5 * j) for e, j in RING], 1.6, -h)
    jo = jax_opstring(*arrays[:3])
    to = torch_sse(jo, arrays[3]).ops
    tm, tm_b = torch_model(jm), torch_model(jm_b)
    want, wz = jops.log_relative_weight(jo, jm, jm_b)
    got, gz = tops.log_relative_weight(to, tm, tm_b)
    np.testing.assert_array_equal(np_(gz), np.asarray(wz))
    np.testing.assert_allclose(np_(got), np.asarray(want), rtol=1e-5, atol=1e-6)
    rng = np.random.default_rng(3)
    nb = jm.nbonds
    sa, sb = (rng.uniform(0.5, 2.0, (R, nb)).astype(np.float32) for _ in range(2))
    xb = xors.copy()
    xb[:R // 2] = xors[::-1][:R // 2]  # half the replicas under the other pattern
    want, wblk = jops.log_weight_delta(jo, jm, jnp.asarray(sa), jnp.asarray(xors),
                                       jnp.asarray(sb), jnp.asarray(xb))
    got, gblk = tops.log_weight_delta(to, tm, t_(sa), t_(xors), t_(sb), t_(xb))
    np.testing.assert_array_equal(np_(gblk), np.asarray(wblk))
    assert np.asarray(wblk).any() and not np.asarray(wblk).all()
    np.testing.assert_allclose(np_(got), np.asarray(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("h", [0.0, 0.4])
def test_op_weights_and_verify_under_bond_xor_match_jax(h):
    xors = sign_patterns(12 if h else 8, bool(h))
    arrays = signed_string(h, xors)
    jm = jmodel.tfim_model(RING, 1.0, h)
    jo = jax_opstring(*arrays[:3])
    tsse = torch_sse(jo, arrays[3])
    tm = torch_model(jm)
    mixed = xors.copy()
    mixed[:R // 2] = xors[::-1][:R // 2]  # half the replicas under the other pattern
    for x in (None, xors, mixed):
        want = jops.op_weights(jo, jm, None if x is None else jnp.asarray(x))
        got = tops.op_weights(tsse.ops, tm, None if x is None else t_(x))
        np.testing.assert_array_equal(np_(got), np.asarray(want))
        want = jops.verify(jo, jnp.asarray(arrays[3]), jm, None if x is None else jnp.asarray(x))
        got = tops.verify(tsse.ops, tsse.state, tm, None if x is None else t_(x))
        np.testing.assert_array_equal(np_(got), np.asarray(want))
    assert np_(got).any() and not np_(got).all()  # the other pattern rejects some


# -- the SSE timestep under sign patterns ------------------------------------------


@pytest.mark.parametrize("heatbath", [False, True])
def test_sweep_with_bond_xor_matches_jax(heatbath):
    h = 0.4
    xors = sign_patterns(12, True)
    arrays = signed_string(h, xors)
    jm = jmodel.tfim_model(RING, 1.0, h)
    sse = jax_sse(arrays, 9)
    betas = np.linspace(0.8, 1.6, R).astype(np.float32)
    hb_j = jdiag.make_heatbath_tables(jm) if heatbath else None
    hb_t = (convert.heatbath_tables_from_numpy(np.asarray(hb_j.cum_max_w),
                                               np.asarray(hb_j.total), device="cpu")
            if heatbath else None)
    out_j, _ = jising.sweep(sse, jnp.asarray(betas), jm, hb=hb_j, heatbath=heatbath,
                            bond_xor=jnp.asarray(xors))
    out_t, _ = tising.sweep(torch_sse(sse.ops, sse.state), t_(betas), torch_model(jm),
                            JaxKeyDraws(sse.key).next(), hb=hb_t, heatbath=heatbath,
                            bond_xor=t_(xors))
    assert_ops_equal(out_t.ops, out_j.ops)
    np.testing.assert_array_equal(np_(out_t.state), np.asarray(out_j.state))
    assert not np.array_equal(np.asarray(out_j.ops.bond), arrays[0])
    assert bool(tops.verify(out_t.ops, out_t.state, torch_model(jm), t_(xors)).all())


def test_sweep_refuses_rvb_under_bond_xor():
    g = tising.QmcIsingGraph(RING, 1.0, replicas=R, device="cpu")
    with pytest.raises(ValueError, match="sign patterns"):
        tising.sweep(g.sse, 1.0, g.model, g.draws, n_rvb=2, rvb_tables=object(),
                     bond_xor=torch.zeros((R, 8), dtype=torch.int32))


# -- the fused chunk ---------------------------------------------------------------


CHUNK_T = 4
DO_SWAP = [True, False, True, True]


@pytest.mark.parametrize("kind", ["homogeneous", "hetero_heatbath", "signed"])
def test_tempering_sweep_chunk_matches_jax(kind):
    h = 0.4 if kind == "signed" else 0.0
    nb = 12 if h else 8
    # One flipped edge at small beta: few ops, so some signed swaps accept.
    xors = sign_patterns(nb, False, flip=(0,)) if kind == "signed" else None
    arrays = signed_string(h, xors if xors is not None else np.zeros((R, nb), np.int32),
                           beta=0.4 if xors is not None else 1.0)
    jm = jmodel.tfim_model(RING, 1.0, h)
    tm = torch_model(jm)
    sse = jax_sse(arrays, 21)
    hetero = kind == "hetero_heatbath"
    heatbath = hetero
    betas = (np.full(R, 1.0, np.float32) if hetero
             else np.repeat(np.linspace(0.6, 1.4, R // 2), 2).astype(np.float32))
    if kind == "signed":
        betas = np.repeat(np.linspace(0.3, 0.5, R // 2), 2).astype(np.float32)
    scales = np.ones((R, nb), np.float32)
    if hetero:
        cls = jpt.tfim_bond_classes(4, 4, nb)
        per_class = np.stack([np.ones(R), np.linspace(0.5, 1.5, R), np.ones(R)], 1)
        scales = per_class[:, np.asarray(cls)].astype(np.float32)
    hb_j = jdiag.make_heatbath_tables(jm, jnp.asarray(scales)) if heatbath else None
    hb_t = (convert.heatbath_tables_from_numpy(np.asarray(hb_j.cum_max_w),
                                               np.asarray(hb_j.total), device="cpu")
            if heatbath else None)
    kw = dict(heatbath=heatbath, hetero=hetero, collect_states=True)
    out_j = jpt.tempering_sweep_chunk(
        sse, jnp.asarray(betas), jnp.asarray(scales), 1, jnp.asarray(DO_SWAP), jm, CHUNK_T,
        hb=hb_j, xors=None if xors is None else jnp.asarray(xors), **kw)
    out_t = tpt.tempering_sweep_chunk(
        torch_sse(sse.ops, sse.state), t_(betas), t_(scales), 1, DO_SWAP, tm, CHUNK_T,
        JaxKeyDraws(sse.key, tempering=True).next, hb=hb_t,
        xors=None if xors is None else t_(xors), **kw)
    sse_j, *rest_j = out_j
    sse_t, *rest_t = out_t
    assert_ops_equal(sse_t.ops, sse_j.ops)
    np.testing.assert_array_equal(np_(sse_t.state), np.asarray(sse_j.state))
    names = ("betas", "scales", "xors", "hb", "parity", "nswaps", "ns", "states", "betas_t")
    for name, g, w in zip(names, rest_t, rest_j):
        if name == "hb":
            g, w = (None, None) if w is None else (g.cum_max_w, w.cum_max_w)
        if w is None:
            assert g is None, name
        else:
            np.testing.assert_array_equal(np_(g), np.asarray(w), err_msg=name)
    assert int(rest_t[5]) > 0, "no swap was accepted: the case tests nothing"
    x = None if xors is None else t_(np.asarray(rest_j[2]))
    assert bool(tops.verify(sse_t.ops, sse_t.state, tm, x).all())


def test_tempering_from_numpy_carries_a_jax_container():
    base = RING
    flip = disorder_edges([-1.0, 1.0, 1.0, 1.0])
    tc = jpt.new_with_rng(seed=6)
    tc.add_qmc_stepper(jising.QmcIsingGraph(base, 1.0, replicas=4, seed=1), 1.0)
    tc.add_qmc_stepper(jising.QmcIsingGraph(flip, 0.8, replicas=4, seed=2), 1.5)
    tc._finalize()
    tc._parity, tc.total_swaps = 1, 7
    ops = tc.graph.sse.ops
    got = convert.tempering_from_numpy(
        base, 1.0, bond=np.asarray(ops.bond), inputs=np.asarray(ops.inputs),
        outputs=np.asarray(ops.outputs), state=np.asarray(tc.graph.sse.state),
        betas=np.asarray(tc.betas), scales=np.asarray(tc.scales), xors=np.asarray(tc.xors),
        parity=tc._parity, total_swaps=tc.total_swaps, device="cpu")
    assert_ops_equal(got.graph.sse.ops, ops)
    for name in ("betas", "scales", "xors"):
        np.testing.assert_array_equal(np_(getattr(got, name)), np.asarray(getattr(tc, name)))
    assert (got._parity, got.total_swaps, got.hetero, got.replicas) == (1, 7, True, 8)
    np.testing.assert_array_equal(got.class_scales, tc.class_scales)
    assert got.verify()


def test_tempering_from_numpy_round_trips_a_port_container():
    """A port container's arrays through numpy give the same container,
    which then steps the same chain on the same generator state."""
    tc = TemperingContainer(RING, 1.0, betas=[0.5, 1.0, 2.0], replicas_per_beta=2,
                            coupling_scales=[1.0, 1.2, 0.8], seed=4, device="cpu")
    tc.timesteps(6)
    tc.tempering_step()
    ops = tc.graph.sse.ops
    got = convert.tempering_from_numpy(
        RING, 1.0, bond=np_(ops.bond), inputs=np_(ops.inputs), outputs=np_(ops.outputs),
        state=np_(tc.graph.sse.state), betas=np_(tc.betas), scales=np_(tc.scales),
        parity=tc._parity, total_swaps=tc.total_swaps, device="cpu")
    got.graph.draws.generator.set_state(tc.graph.draws.generator.get_state())
    got.graph._cluster_caps = tc.graph._cluster_caps
    got.graph._growth_pending, got.graph._growth_stable = False, 2
    tc.graph._growth_pending, tc.graph._growth_stable = False, 2
    for c in (tc, got):
        c.timesteps_sample(6, chunk=3)
    assert_ops_equal(got.graph.sse.ops, tc.graph.sse.ops)
    for name in ("betas", "scales"):
        assert torch.equal(getattr(got, name), getattr(tc, name))
    assert (got.xors, got._parity, got.total_swaps, got.hetero) == (
        None, tc._parity, tc.total_swaps, True)


# -- the JAX package's oracles on the port's chains ------------------------------------
# tests/test_tempering_autocorr.py


def _u(seed: int, R_: int) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed).random(R_, dtype=np.float32))


def test_preserves_beta_multiset():
    betas = torch.from_numpy(np.random.RandomState(0).uniform(0.1, 2.0, 16).astype(np.float32))
    n = torch.from_numpy(np.random.RandomState(1).randint(0, 50, 16).astype(np.int32))
    perm, _ = tpt.tempering_step(n, betas, _u(0, 16), 0)
    assert sorted(betas[perm.long()].tolist()) == sorted(betas.tolist())


@pytest.mark.parametrize("parity,swaps,want", [(0, 2, [1.0, 0.5, 2.0, 1.5]),
                                               (1, 1, [0.5, 1.5, 1.0, 2.0])])
def test_equal_n_always_swaps_by_parity(parity, swaps, want):
    betas = torch.tensor([0.5, 1.0, 1.5, 2.0])
    perm, sw = tpt.tempering_step(torch.zeros(4, dtype=torch.int32), betas, _u(parity, 4),
                                  parity)
    assert int(sw) == swaps
    np.testing.assert_allclose(np_(betas[perm.long()]), want)


def test_large_n_gap_blocks_swap():
    betas = torch.tensor([0.1, 10.0])
    n = torch.tensor([0, 200], dtype=torch.int32)
    assert sum(int(tpt.tempering_step(n, betas, _u(s, 2), 0)[1]) for s in range(20)) == 0


def test_ensemble_runs_and_orders():
    tc = TemperingContainer(lattice.frustrated_square(4, 4), transverse=1.0,
                            betas=[0.2, 0.5, 1.0, 2.0], replicas_per_beta=2, seed=0,
                            device="cpu")
    states, betas = tc.timesteps_sample(20, swap_freq=2, sampling_freq=5)
    assert states.shape == (4, 8, 16) and betas.shape == (4, 8)
    assert tc.verify()
    by_t, bs = tc.states_by_temperature()
    assert torch.equal(bs, torch.sort(tc.betas).values) and by_t.shape == (8, 16)
    n = np_(tc.graph.get_n())
    n_sorted = n[np.argsort(np_(tc.betas), kind="stable")]
    assert n_sorted[-2:].mean() > n_sorted[:2].mean()


def test_swaps_happen():
    tc = TemperingContainer(lattice.chain(6, j=1.0), transverse=1.0,
                            betas=[0.8, 0.9, 1.0, 1.1], seed=1, device="cpu")
    tc.timesteps(10)
    for _ in range(10):
        tc.tempering_step()
    assert tc.total_swaps > 0


def test_white_noise_decorrelates():
    ac = np_(fft_autocorrelation(np.random.RandomState(0).randn(256, 8)))
    assert abs(ac[0] - 1.0) < 1e-5
    assert np.all(np.abs(ac[5:50]) < 0.2)


def test_ess_white_noise_and_correlated_series():
    x = np.random.RandomState(1).randn(512, 4)
    assert 0.6 * 512 * 4 < effective_sample_size(x) <= 1.3 * 512 * 4
    rng = np.random.RandomState(2)
    T = 4096
    x = np.zeros(T)
    for t in range(1, T):
        x[t] = 0.9 * x[t - 1] + rng.randn()
    assert 10 < integrated_autocorrelation_time(x) < 30
    assert effective_sample_size(x) < T / 8


def test_slow_signal_and_shapes():
    t = np.arange(128)
    x = np.sin(2 * np.pi * t / 128.0)[:, None] + 0.01 * np.random.RandomState(1).randn(128, 4)
    assert np_(fft_autocorrelation(x))[1] > 0.9
    states = np.random.RandomState(2).rand(64, 4, 6) > 0.5
    assert np_(spin_autocorrelation(states)).shape == (64,)
    acb = np_(bond_autocorrelation(states, np.array([[0, 1], [1, 2], [2, 3]]),
                                   np.array([1.0, -1.0, 1.0])))
    assert acb.shape == (64,) and abs(acb[0] - 1.0) < 1e-4


def test_container_accessors():
    tc = TemperingContainer(lattice.chain(4, j=1.0), 1.0, betas=[0.5, 1.0, 2.0], seed=4,
                            device="cpu")
    tc.timesteps(4)
    assert tc.num_graphs() == 3
    seen = []
    tc.iter_over_states(lambda s, b: seen.append((s.shape, b)))
    assert len(seen) == 3 and seen[0][0] == (4,)
    assert {b for _, b in seen} == {0.5, 1.0, 2.0}
    g, betas = tc.graph_ref()
    assert g is tc.graph and len(betas) == 3 and tc.graph_mut()[0] is g
    before = tc.get_total_swaps()
    tc.tempering_step()
    assert tc.get_total_swaps() >= before


# tests/test_tempering_hetero.py


def test_identical_params_always_swap():
    perm, sw = tpt.tempering_step(torch.tensor([5, 9, 3, 7], dtype=torch.int32),
                                  torch.ones(4), _u(0, 4), 0)
    assert int(sw) == 2 and sorted(np_(perm).tolist()) == [0, 1, 2, 3]


def test_class_term_blocks_bad_swaps():
    n_class = torch.tensor([[0, 0, 0], [0, 10, 0]], dtype=torch.int32)
    log_c = torch.log(torch.tensor([[1.0, 1e-6, 1.0], [1.0, 1.0, 1.0]]))
    perm, sw = tpt.tempering_step(torch.tensor([10, 10], dtype=torch.int32), torch.ones(2),
                                  _u(0, 2), 0, n_class, log_c)
    assert int(sw) == 0 and np_(perm).tolist() == [0, 1]


@pytest.mark.parametrize("heatbath", [False, True])
def test_transverse_ladder_runs_and_swaps(heatbath):
    scales = [0.6, 0.9, 1.2, 1.5] if not heatbath else [0.7, 1.0, 1.4]
    tc = TemperingContainer(lattice.chain(6, j=1.0), transverse=1.0,
                            betas=[1.0] * len(scales), transverse_scales=scales,
                            seed=5 if not heatbath else 11, device="cpu")
    tc.set_enable_heatbath(heatbath)
    tc.timesteps(10)
    total = 0
    for _ in range(6):
        tc.timesteps(3)
        total += tc.tempering_step()
    assert tc.verify()
    if not heatbath:
        assert total > 0, "field ladder should exchange sometimes"
    got = sorted(tc.class_scales[:, 1].astype(np.float64).tolist())
    np.testing.assert_allclose(got, scales, rtol=1e-6)
    if heatbath:  # the per-replica tables followed their labels
        want = tdiag.make_heatbath_tables(tc.graph.model, tc.scales)
        assert torch.equal(tc._hb.cum_max_w, want.cum_max_w)


def _ed_energy(edges, g: float, beta: float, L: int = 4) -> float:
    H = np.zeros((2**L, 2**L))
    for s in range(2**L):
        for (a, b), j in edges:
            H[s, s] += j * (1 - 2 * ((s >> a) & 1)) * (1 - 2 * ((s >> b) & 1))
        for i in range(L):
            H[s ^ (1 << i), s] += -g
    w = np.linalg.eigvalsh(H)
    z = np.exp(-beta * (w - w[0]))
    return float((w * z).sum() / z.sum())


def test_heatbath_hetero_matches_ed():
    """Per-replica heat-bath tables sample each replica's own Hamiltonian:
    <E> per rung against ED with swaps off."""
    L, beta, scales = 4, 1.5, [0.5, 1.5]
    edges = lattice.chain(L, j=1.0)
    tc = TemperingContainer(edges, transverse=1.0, betas=[beta, beta], replicas_per_beta=24,
                            transverse_scales=scales, seed=21, device="cpu")
    tc.set_enable_heatbath(True)
    tc.timesteps(60)
    scale_per_rep = tc.class_scales[:, 1].astype(np.float64)
    offset_r = sum(abs(j) for _, j in edges) + L * 1.0 * scale_per_rep
    es = []
    for _ in range(80):
        tc.timesteps(1)
        es.append(-np_(tc.graph.get_n()).astype(np.float64) / beta + offset_r)
    e = np.mean(es, axis=0)
    for g in scales:
        got = float(np.mean(e[np.isclose(scale_per_rep, g)]))
        assert abs(got - _ed_energy(edges, g, beta)) < 0.25, (g, got)


def test_homogeneous_path_unchanged():
    tc = TemperingContainer(lattice.chain(4, j=1.0), 1.0, betas=[0.5, 1.0, 2.0], seed=3,
                            device="cpu")
    tc.timesteps(5)
    tc.tempering_step()
    assert tc.verify()
    assert sorted(np.round(np_(tc.betas), 4).tolist()) == [0.5, 1.0, 2.0]


@pytest.mark.parametrize("kind", ["variable", "bond"])
def test_per_replica_autocorrelations(kind):
    tc = TemperingContainer(lattice.chain(4, j=1.0), 1.0, betas=[0.5, 2.0], seed=9,
                            device="cpu")
    if kind == "variable":
        ac = tc.calculate_variable_autocorrelations(12, swap_freq=3)
    else:
        ac = tc.calculate_bond_autocorrelations(12, swap_freq=3)
    assert ac.shape == (2, 12)
    assert ac[0, 0] == pytest.approx(1.0, abs=2e-2)


def _two_graph_ladder(e_a, e_b, seed, replicas=24, beta=1.0):
    tc = tpt.new_with_rng(seed=seed, device="cpu")
    tc.add_qmc_stepper(tising.QmcIsingGraph(e_a, 1.0, replicas=replicas, seed=1,
                                            device="cpu"), beta)
    tc.add_qmc_stepper(tising.QmcIsingGraph(e_b, 1.0, replicas=replicas, seed=2,
                                            device="cpu"), beta)
    return tc


@pytest.mark.parametrize("signed", [False, True])
def test_disordered_and_signed_ladders_accepted_and_stationary(signed):
    """Two disorder realizations (|J| patterns, or signs) temper in one
    container: per-label mean energies lie within 0.15 of dense ED."""
    beta = 1.0
    if signed:
        e_a, e_b = disorder_edges([1.0] * 4), disorder_edges([-1.0, 1.0, 1.0, 1.0])
    else:
        e_a, e_b = disorder_edges([0.7, 1.3, 1.0, 1.0]), disorder_edges([1.3, 0.7, 1.0, 1.0])
    tc = _two_graph_ladder(e_a, e_b, seed=8 if signed else 4)
    tc.timesteps(50)
    assert (tc.xors is not None) == signed and tc.hetero != signed
    es, labels = [], []
    for i in range(150):
        tc.timesteps(1)
        if i % 2 == 0:
            tc.tempering_step()
        es.append(-np_(tc.graph.get_n()).astype(np.float64) / beta + tc.graph.model.offset)
        labels.append(np_(tc.xors[:, 0] == 0) if signed else
                      np.isclose(np_(tc.scales[:, 0]), 1.0))
    assert tc.get_total_swaps() > 0
    assert tc.verify()
    es, is_a = np.stack(es), np.stack(labels)
    assert float(es[is_a].mean()) == pytest.approx(_ed_energy(e_a, 1.0, beta), abs=0.15)
    assert float(es[~is_a].mean()) == pytest.approx(_ed_energy(e_b, 1.0, beta), abs=0.15)


def test_edge_listing_order_canonicalized():
    e1 = [((0, 1), 1.0), ((1, 2), 0.5), ((2, 0), 1.0)]
    e2 = [((2, 1), 0.75), ((1, 0), 1.5), ((0, 2), 1.5)]
    tc = tpt.new_with_rng(seed=0, device="cpu")
    tc.add_qmc_stepper(tising.QmcIsingGraph(e1, 1.0, seed=0, device="cpu"), 1.0)
    tc.add_qmc_stepper(tising.QmcIsingGraph(e2, 1.0, seed=1, device="cpu"), 1.0)
    tc.timesteps(3)
    assert tc.hetero
    np.testing.assert_allclose(np_(tc.scales)[1, 1], 1.5, rtol=1e-6)


def test_sign_flips_rejected_where_no_label_represents_them():
    g1 = tising.QmcIsingGraph(disorder_edges([1.0] * 4), 1.0, seed=0, device="cpu")
    g2 = tising.QmcIsingGraph(disorder_edges([-1.0, 1, 1, 1]), 1.0, seed=1, device="cpu")
    _, xor = tpt._relative_bond_params(g1, g2)
    np.testing.assert_array_equal(xor, [1, 0, 0, 0] + [0] * (len(xor) - 4))
    with pytest.raises(ValueError, match="sign"):
        tpt._relative_bond_params(g1, tising.QmcIsingGraph(disorder_edges([1.0] * 4), -1.0,
                                                           seed=1, device="cpu"))
    tc = tpt.new_with_rng(seed=0, device="cpu")
    tc.add_qmc_stepper(g1, 1.0)
    with pytest.raises(ValueError):
        tc.add_qmc_stepper(tising.QmcIsingGraph(disorder_edges([1.0] * 4), -1.0, seed=1,
                                                device="cpu"), 1.0)


def test_log_relative_weight_matches_bond_count_formula():
    g = tising.QmcIsingGraph(RING, 0.8, replicas=8, seed=3, device="cpu")
    g.timesteps(20, 1.0)
    model_b = tfim_model([(e, 1.5 * j) for e, j in RING], 1.6, device="cpu")
    logw, is_zero = tops.log_relative_weight(g.sse.ops, g.model, model_b)
    bc = np_(tops.bond_counts(g.sse.ops, g.model.nbonds)).astype(np.float64)
    log_c = np.concatenate([np.full(4, np.log(1.5)), np.full(4, np.log(2.0))])
    np.testing.assert_allclose(np_(logw).astype(np.float64), bc @ log_c, rtol=1e-4, atol=1e-4)
    assert not np_(is_zero).any()


def test_log_weight_delta_matches_op_walk():
    e_b = disorder_edges([-1.0, 1.0, -1.0, 1.0])
    g = tising.QmcIsingGraph(RING, 1.0, replicas=8, seed=3, device="cpu")
    g.timesteps(20, 1.0)
    want, want_zero = tops.log_relative_weight(g.sse.ops, g.model,
                                               tfim_model(e_b, 1.0, device="cpu"))
    nb = g.model.nbonds
    ones = torch.ones((8, nb))
    zeros = torch.zeros((8, nb), dtype=torch.int32)
    xor_b = zeros.clone()
    xor_b[:, [0, 2]] = 1
    got, blocked = tops.log_weight_delta(g.sse.ops, g.model, ones, zeros, ones, xor_b)
    np.testing.assert_array_equal(np_(blocked), np_(want_zero))
    ok = ~np_(blocked)
    np.testing.assert_allclose(np_(got)[ok], np_(want)[ok], rtol=1e-4, atol=1e-4)


def test_swap_qmc_steppers_stationary_vs_ed():
    """As the JAX package's test, with 48 replicas and 240 sweeps in place
    of 24 and 120: its 0.15 is about 2 standard errors of the shorter
    series (0.07 at 24 x 120 on these chains), 3.7 of this one."""
    beta = 1.0
    e_a, e_b = disorder_edges([1.0] * 4), disorder_edges([-1.0, 1.0, 1.0, 1.0])
    g_a = tising.QmcIsingGraph(e_a, 1.0, replicas=48, seed=5, device="cpu")
    g_b = tising.QmcIsingGraph(e_b, 1.0, replicas=48, seed=6, device="cpu")
    g_a.timesteps(40, beta)
    g_b.timesteps(40, beta)
    swaps = 0
    es_a, es_b = [], []
    for i in range(240):
        g_a.timesteps(1, beta)
        g_b.timesteps(1, beta)
        if i % 2 == 0:
            swaps += tpt.swap_qmc_steppers(g_a, beta, g_b, beta, _u(i, 48))
        es_a.append(-np_(g_a.get_n()).astype(np.float64) / beta + g_a.model.offset)
        es_b.append(-np_(g_b.get_n()).astype(np.float64) / beta + g_b.model.offset)
    assert swaps > 0
    assert g_a.verify() and g_b.verify()
    assert float(np.mean(es_a)) == pytest.approx(_ed_energy(e_a, 1.0, beta), abs=0.15)
    assert float(np.mean(es_b)) == pytest.approx(_ed_energy(e_b, 1.0, beta), abs=0.15)


def test_signed_ladder_fused_chunk_sampling():
    tc = _two_graph_ladder(disorder_edges([1.0] * 4), disorder_edges([-1.0, 1.0, 1.0, 1.0]),
                           seed=13, replicas=8)
    states, bet = tc.timesteps_sample(24, swap_freq=2, chunk=8)
    assert states.shape[:2] == (24, 16) and bet.shape == (24, 16)
    assert tc.verify()
    np.testing.assert_array_equal(np.sort(np_(tc.xors[:, 0])), np.r_[np.zeros(8), np.ones(8)])
