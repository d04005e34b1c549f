"""Checkpoints across the two packages and within the port: a file that the
JAX package saved with ``strip_rng=True`` loads into the port with the same
op string, state and labels, a file that the port saved loads into the JAX
package, for ``QmcIsingGraph``, ``Qmc`` and ``TemperingContainer``; a
resumed port chain equals the one that went on (the generator state, the
cluster caps and the growth phase are saved); and the oracles of
``tests/test_api_surface.py:59-117, 394-417``. The JAX objects get their
strings from the port's chains, so no JAX chain is compiled."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_utils import assert_ops_equal, jax_opstring, np_, port_chain_state

from isingmontecarlo_tpu import checkpoint as jckpt
from isingmontecarlo_tpu import lattice
from isingmontecarlo_tpu.parallel import tempering as jpt
from isingmontecarlo_tpu.sse import ising as jising
from isingmontecarlo_tpu.sse import runner as jrunner
from isingmontecarlo_tpu_torch import checkpoint as tckpt
from isingmontecarlo_tpu_torch.parallel import TemperingContainer
from isingmontecarlo_tpu_torch.parallel import tempering as tpt
from isingmontecarlo_tpu_torch.sse import ising as tising
from isingmontecarlo_tpu_torch.sse import runner as trunner

from torch_port_utils import release_jax_executables  # noqa: F401  (autouse)

torch.set_num_threads(1)

RING = lattice.chain(4, j=1.0)
FLIPPED = [(e, -j if i == 0 else j) for i, (e, j) in enumerate(RING)]


def small_graph(replicas=4, seed=11):
    return tising.QmcIsingGraph(lattice.chain(6, j=1.0), 1.0, 0.3, replicas=replicas,
                                seed=seed, device="cpu")


def build_qmc(seed, qmc_cls=trunner.Qmc, **kw):
    """``tests/test_api_surface.py:370-383``'s 4-site ring with loops."""
    q = qmc_cls(4, replicas=4, seed=seed, do_loop_updates=True, **kw)
    for a in range(4):
        q.make_diagonal_interaction_and_offset(np.array([1.0, 0.0, 0.0, 1.0]), [a, (a + 1) % 4])
    for v in range(4):
        q.make_interaction(np.full((2, 2), 0.8), [v])
    return q


def signed_container(seed=6):
    tc = tpt.new_with_rng(seed=seed, device="cpu")
    tc.add_qmc_stepper(tising.QmcIsingGraph(RING, 1.0, replicas=4, seed=1, device="cpu"), 1.0)
    tc.add_qmc_stepper(tising.QmcIsingGraph(FLIPPED, 1.0, replicas=4, seed=2, device="cpu"),
                       1.5)
    return tc


def assert_sse_equal(t_sse, j_sse):
    assert_ops_equal(t_sse.ops, j_sse.ops)
    np.testing.assert_array_equal(np_(t_sse.state), np.asarray(j_sse.state))


def as_jax_sse(j_sse, t_sse):
    """The JAX SseState ``j_sse`` with the port's string and state."""
    ops, state = t_sse
    return j_sse._replace(ops=jax_opstring(np_(ops.bond), np_(ops.inputs), np_(ops.outputs)),
                          state=jnp.asarray(np_(state)))


# -- JAX -> port and port -> JAX ---------------------------------------------------


def test_qmc_ising_files_load_both_ways(tmp_path):
    edges = lattice.chain(6, j=1.0)
    bond, inputs, outputs, state = port_chain_state(edges, longitudinal=0.3, replicas=4,
                                                    nsweeps=8)
    jg = jising.QmcIsingGraph(edges, 1.0, 0.3, cutoff=bond.shape[0], replicas=4, seed=2)
    jg.sse = jg.sse._replace(ops=jax_opstring(bond, inputs, outputs), state=jnp.asarray(state))
    jpath = str(tmp_path / "jax.npz")
    jg.save(jpath, strip_rng=True)
    tg = tising.QmcIsingGraph.load(jpath, device="cpu")
    assert_sse_equal(tg.sse, jg.sse)
    assert (tg.edges, tg.transverse, tg.longitudinal, tg.replicas) == (
        jg.edges, jg.transverse, jg.longitudinal, jg.replicas)
    assert tg.verify()
    tg.timesteps(3, 1.0)
    tpath = str(tmp_path / "port.npz")
    tg.save(tpath)
    jg2 = jising.QmcIsingGraph.load(tpath)
    assert_sse_equal(tg.sse, jg2.sse)
    assert (jg2.edges, jg2.transverse, jg2.longitudinal) == (edges, 1.0, 0.3)


def test_qmc_files_load_both_ways(tmp_path):
    tq = build_qmc(13, device="cpu")
    tq.timesteps(10, 1.2)
    jq = build_qmc(13, jrunner.Qmc)
    jq._sse = as_jax_sse(jq._ensure_sse(), tq._ensure_sse())
    jpath = str(tmp_path / "jax.npz")
    jq.save(jpath, strip_rng=True)
    tq2 = trunner.Qmc.load(jpath, device="cpu")
    assert_sse_equal(tq2._ensure_sse(), jq._sse)
    assert tq2.get_offset() == pytest.approx(jq.get_offset())
    assert tq2.do_loop_updates and tq2.nvars == 4
    for (m1, v1), (m2, v2) in zip(tq2._interactions, jq._interactions):
        np.testing.assert_array_equal(m1, m2)
        assert list(v1) == list(v2)
    assert tq2.verify()
    tpath = str(tmp_path / "port.npz")
    tq.save(tpath)
    jq2 = jrunner.Qmc.load(tpath)
    assert_sse_equal(tq._ensure_sse(), jq2._sse)
    assert jq2.get_offset() == pytest.approx(tq.get_offset())


@pytest.mark.parametrize("signed", [False, True])
def test_tempering_files_load_both_ways(tmp_path, signed):
    if signed:
        tc = signed_container()
    else:
        tc = TemperingContainer(RING, 1.0, betas=[0.5, 1.0, 2.0], replicas_per_beta=2,
                                transverse_scales=[0.8, 1.0, 1.2], seed=3, device="cpu")
    tc.timesteps(5)
    tc.tempering_step()
    tc.tempering_step()
    # The JAX container with the port's arrays, saved without its key.
    if signed:
        jc = jpt.new_with_rng(seed=6)
        jc.add_qmc_stepper(jising.QmcIsingGraph(RING, 1.0, replicas=4, seed=1), 1.0)
        jc.add_qmc_stepper(jising.QmcIsingGraph(FLIPPED, 1.0, replicas=4, seed=2), 1.5)
        jc._finalize()
    else:
        jc = jpt.TemperingContainer(RING, 1.0, betas=[0.5, 1.0, 2.0], replicas_per_beta=2,
                                    transverse_scales=[0.8, 1.0, 1.2], seed=3)
    jc.graph.sse = as_jax_sse(jc.graph.sse, tc.graph.sse)
    jc.betas = jnp.asarray(np_(tc.betas))
    jc.scales = jnp.asarray(np_(tc.scales))
    jc.xors = None if tc.xors is None else jnp.asarray(np_(tc.xors))
    jc._parity, jc.total_swaps = tc._parity, tc.total_swaps
    jpath = str(tmp_path / "jax.npz")
    jckpt.save_tempering(jpath, jc, strip_rng=True)
    tc2 = tckpt.load_tempering(jpath, device="cpu")
    tpath = str(tmp_path / "port.npz")
    tckpt.save_tempering(tpath, tc)
    jc2 = jckpt.load_tempering(tpath)
    for a, b in ((tc2, jc), (tc, jc2)):
        assert_sse_equal(a.graph.sse, b.graph.sse)
        for name in ("betas", "scales"):
            np.testing.assert_array_equal(np_(getattr(a, name)), np.asarray(getattr(b, name)))
        assert (a.xors is None) == (b.xors is None) == (not signed)
        if signed:
            np.testing.assert_array_equal(np_(a.xors), np.asarray(b.xors))
        assert (a._parity, a.total_swaps, a.hetero) == (b._parity, b.total_swaps, b.hetero)
    assert tc2.verify()


# -- resume within the port ----------------------------------------------------------


@pytest.mark.parametrize("kind", ["graph", "qmc", "tempering"])
def test_resume_equals_the_chain_that_went_on(tmp_path, kind):
    path = str(tmp_path / "ckpt.npz")
    if kind == "graph":
        a = small_graph()
        a.timesteps(12, 1.0)
        a.save(path)
        b = tising.QmcIsingGraph.load(path, device="cpu")
        run = lambda g: g.timesteps(6, 1.0)  # noqa: E731
        parts = lambda g: (*g.sse.ops, g.sse.state)  # noqa: E731
    elif kind == "qmc":
        a = build_qmc(5, device="cpu")
        a.timesteps(12, 1.0)
        a.save(path)
        b = trunner.Qmc.load(path, device="cpu")
        run = lambda q: q.timesteps(6, 1.0)  # noqa: E731
        parts = lambda q: (*q._ensure_sse().ops, q._ensure_sse().state)  # noqa: E731
    else:
        a = signed_container()
        a.set_enable_heatbath(True)
        a.timesteps(6)
        a.timesteps_sample(6, chunk=4)
        tckpt.save_tempering(path, a)
        b = tckpt.load_tempering(path, device="cpu")
        run = lambda c: c.timesteps_sample(10, swap_freq=1, chunk=4)  # noqa: E731
        parts = lambda c: (*c.graph.sse.ops, c.graph.sse.state, c.betas, c.xors,  # noqa: E731
                           torch.tensor([c._parity, c.total_swaps]))
    run(a)
    run(b)
    for x, y in zip(parts(a), parts(b)):
        assert torch.equal(x, y)


def test_strip_rng_reseeds_and_other_devices_need_a_seed(tmp_path):
    g = small_graph()
    g.timesteps(5, 1.0)
    path = str(tmp_path / "ckpt.npz")
    g.save(path, strip_rng=True)
    a = tising.QmcIsingGraph.load(path, seed=99, device="cpu")
    b = tising.QmcIsingGraph.load(path, seed=99, device="cpu")
    assert torch.equal(a.draws.diagonal((3, 2)), b.draws.diagonal((3, 2)))
    g.save(path)
    with np.load(path) as data:
        assert data["key4"].dtype == np.uint32 and not data["key4"].any()
        assert str(data["meta_torch_rng_device"]) == "cpu"
    with np.load(path) as data:
        meta = dict(data)
    meta["meta_torch_rng_device"] = np.asarray("cuda")
    np.savez(path, **meta)
    with pytest.raises(ValueError, match="seed="):
        tising.QmcIsingGraph.load(path, device="cpu")
    assert tising.QmcIsingGraph.load(path, seed=1, device="cpu").verify()


# -- tests/test_api_surface.py's oracles on the port -------------------------------------


def test_roundtrip_resume_deterministic(tmp_path):
    g = small_graph(replicas=4, seed=11)
    for _ in range(8):
        g.timestep(1.2)
    path = str(tmp_path / "ckpt.npz")
    g.save(path)
    g2 = tising.QmcIsingGraph.load(path, device="cpu")
    assert torch.equal(g.sse.state, g2.sse.state)
    assert torch.equal(g.sse.ops.bond, g2.sse.ops.bond)
    for _ in range(4):
        g.timestep(1.2)
        g2.timestep(1.2)
    assert torch.equal(g.sse.state, g2.sse.state)
    assert g2.verify()


@pytest.mark.parametrize("kind", ["graph", "qmc"])
def test_strip_rng_reseeds(tmp_path, kind):
    path = str(tmp_path / "ckpt.npz")
    if kind == "graph":
        g = small_graph(replicas=4, seed=11)
        for _ in range(5):
            g.timestep(1.0)
        g.save(path, strip_rng=True)
        g2 = tising.QmcIsingGraph.load(path, seed=99, device="cpu")
        assert g2.verify()
        g2.timestep(1.0)
    else:
        q = trunner.Qmc(3, replicas=4, seed=2, device="cpu")
        q.make_diagonal_interaction_and_offset([1.0, 0.0, 0.0, 1.0], [0, 1])
        q.make_interaction(np.full((2, 2), 0.5), [2])
        q.timesteps(8, 1.0)
        q.save(path, strip_rng=True)
        g2 = trunner.Qmc.load(path, seed=77, device="cpu")
        assert g2.verify()
        g2.timesteps(4, 1.0)
    assert g2.verify()


def test_tempering_roundtrip(tmp_path):
    tc = TemperingContainer(lattice.chain(4, j=1.0), 1.0, betas=[0.5, 1.0, 2.0], seed=3,
                            device="cpu")
    tc.timesteps(5)
    tc.tempering_step()
    path = str(tmp_path / "temper.npz")
    tckpt.save_tempering(path, tc)
    tc2 = tckpt.load_tempering(path, device="cpu")
    assert torch.allclose(tc.betas, tc2.betas)
    assert tc2.total_swaps == tc.total_swaps
    assert tc2.verify()
    tc2.timesteps(2)
    tc2.tempering_step()


def test_signed_tempering_roundtrip(tmp_path):
    tc = signed_container()
    tc.timesteps(5)
    tc.tempering_step()
    path = str(tmp_path / "signed.npz")
    tckpt.save_tempering(path, tc)
    tc2 = tckpt.load_tempering(path, device="cpu")
    assert tc2.xors is not None
    assert torch.equal(tc.xors, tc2.xors)
    assert tc2.verify()


def test_qmc_roundtrip(tmp_path):
    q = build_qmc(13, device="cpu")
    q.timesteps(15, 1.2)
    path = str(tmp_path / "qmc.npz")
    q.save(path)
    q2 = trunner.Qmc.load(path, device="cpu")
    assert q2.nvars == 4 and q2.do_loop_updates
    assert q2.get_offset() == pytest.approx(q.get_offset())
    assert np.array_equal(q2.clone_state(), q.clone_state())
    assert torch.equal(q2._sse.ops.bond, q._sse.ops.bond)
    q.timesteps(5, 1.2)
    q2.timesteps(5, 1.2)
    assert np.array_equal(q.clone_state(), q2.clone_state())
    assert q2.verify()
