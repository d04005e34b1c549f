"""The port's heat-bath diagonal update against the JAX package's.

- K3-hb's plain version against the Pallas carry (``heatbath=True``, in
  interpret mode) and ``searchsorted_left`` against JAX's: exact (identical
  f32 comparisons and integer counts; ties included).
- ``make_heatbath_tables`` against JAX's: ``rtol=1e-6``, since
  ``torch.cumsum`` and XLA's CPU cumsum may round non-integer weights
  differently in the last ulps; exact on integer weights.
- ``diagonal_update(heatbath=True)`` and a chained heat-bath ``multi_sweep``
  with JAX's uniforms and JAX's tables carried across: exact on ``bond``,
  ``inputs`` and ``outputs`` (h = 0 for the chain, where cluster flip
  ratios are exactly 1).
- The port's own heat-bath chain on the 4-site periodic chain against exact
  diagonalization within ``max(4 SE, 0.08)``, as ``tests/test_sse.py``
  holds the JAX chain.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_sse import exact_tfim_energy
from torch_port_utils import (
    JaxKeyDraws, assert_ops_equal, jax_opstring, np_, port_chain_state, t_,
    torch_model, torch_sse,
)

from isingmontecarlo_tpu import lattice
from isingmontecarlo_tpu.ops.diag_carry import carry_decisions as jax_carry
from isingmontecarlo_tpu.sse import diagonal as jdiag
from isingmontecarlo_tpu.sse import ising as jising
from isingmontecarlo_tpu.sse import model as jmodel
from isingmontecarlo_tpu.sse import tables as jtables
from isingmontecarlo_tpu_torch import convert, ops
from isingmontecarlo_tpu_torch.ops.diag_carry import tie_heavy_carry_inputs
from isingmontecarlo_tpu_torch.sse import diagonal as tdiag
from isingmontecarlo_tpu_torch.sse import ising as tising
from isingmontecarlo_tpu_torch.sse import model as tmodel
from isingmontecarlo_tpu_torch.sse import opstring as tops
from isingmontecarlo_tpu_torch.sse import tables as ttables

from torch_port_utils import release_jax_executables  # noqa: F401  (autouse)

torch.set_num_threads(1)


def _carry_inputs(M, R, seed):
    rng = np.random.default_rng(seed)
    n0 = rng.integers(0, M // 2, size=R).astype(np.int32)
    u0 = rng.random((M, R), dtype=np.float32)
    idp = rng.random((M, R)) < 0.5
    dgp = ~idp & (rng.random((M, R)) < 0.8)
    insw = rng.random((M, R)) < 0.7
    # bwt on the scale of M - n, so both outcomes occur.
    bwt = rng.uniform(0.2 * M, M, R).astype(np.float32)
    return n0, u0, idp, dgp, insw, bwt


@pytest.mark.parametrize("M,R,ties", [
    pytest.param(700, 5, False, id="700-5"),
    pytest.param(200, 16, False, id="200-16"),
    # Slots on or within an ulp of the comparisons' edge, R a multiple of
    # neither 16 nor 32, M not of the kernel's 64-slot tile.
    pytest.param(300, 7, True, id="ties-300-7"),
])
def test_carry_heatbath_matches_pallas(M, R, ties):
    n0, u0, idp, dgp, insw, bwt = (tie_heavy_carry_inputs(M, R, M + R, heatbath=True) if ties
                                   else _carry_inputs(M, R, M + R))
    j = jnp.asarray
    ins_j, rem_j = jax_carry(j(n0), j(u0), j(idp), j(dgp), j(insw), j(insw), j(bwt),
                             M=M, heatbath=True, interpret=True)
    t = torch.from_numpy
    ins, rem = ops.carry_decisions_heatbath(t(n0), t(u0), t(idp), t(dgp), t(insw), t(bwt))
    np.testing.assert_array_equal(ins.numpy(), np.asarray(ins_j))
    np.testing.assert_array_equal(rem.numpy(), np.asarray(rem_j))
    assert ins.any() and rem.any()
    assert ops.carry_decisions_heatbath.launches == 0


@pytest.mark.cuda
def test_cuda_carry_heatbath_equals_plain():
    """K3-hb against its plain version on the card: R a multiple of neither
    32 nor 16 and M of no 64-slot tile; R a multiple of 16 but not of 32;
    planes off 16-byte alignment (the element-wise path); random and
    tie-heavy inputs. M >= 2^24 is refused before any launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc")
    for M, R in ((37, 5), (300, 48), (700, 64), (1000, 100)):
        for args in (_carry_inputs(M, R, 1), tie_heavy_carry_inputs(M, R, 2, heatbath=True)):
            args = [torch.from_numpy(a).cuda() for a in args]
            before = ops.carry_decisions_heatbath.launches
            got = ops.carry_decisions_heatbath(*args)
            want = ops.carry_decisions_heatbath_plain(*args)
            torch.cuda.synchronize()
            assert ops.carry_decisions_heatbath.launches == before + 1
            for g, w in zip(got, want):
                assert torch.equal(g, w)
    args = [torch.from_numpy(a).cuda()
            for a in tie_heavy_carry_inputs(300, 64, 3, heatbath=True)]
    shifted = []
    for a in args:  # every [M, R] plane one element past a 16-byte boundary
        if a.dim() == 2:
            buf = torch.empty(a.numel() + 1, dtype=a.dtype, device=a.device)
            a = buf[1:].view(a.shape).copy_(a)
        shifted.append(a)
    for g, w in zip(ops.carry_decisions_heatbath(*shifted),
                    ops.carry_decisions_heatbath_plain(*args)):
        assert torch.equal(g, w)
    mask = torch.empty((2**24, 1), dtype=torch.bool, device="cuda")
    big = (torch.zeros(1, dtype=torch.int32, device="cuda"),
           torch.empty((2**24, 1), dtype=torch.float32, device="cuda"), mask, mask, mask,
           torch.zeros(1, device="cuda"))
    before = ops.carry_decisions_heatbath.launches
    with pytest.raises(ValueError, match="2\\^24"):
        ops.carry_decisions_heatbath(*big)
    assert ops.carry_decisions_heatbath.launches == before


@pytest.mark.parametrize("on_tpu", [False, True])
def test_searchsorted_left_matches_jax_with_ties(on_tpu):
    """Zero weights repeat table entries, and half the queries equal an
    entry; ``side='left'`` counts ``table < q``. ``on_tpu=True`` is JAX's
    two-level compare-count (and its ``[M, R, NB]`` grid per replica)."""
    rng = np.random.default_rng(2)
    NB, M, R = 100, 40, 6
    w = rng.integers(0, 4, size=(R, NB)).astype(np.float32)
    tab2 = np.cumsum(w, axis=1, dtype=np.float32)
    tab1 = tab2[0]
    for tab in (tab1, tab2):
        q = rng.uniform(0, tab[..., -1].min(), (M, R)).astype(np.float32)
        pick = rng.integers(0, NB, (M, R))
        exact = tab[pick] if tab.ndim == 1 else tab[np.arange(R)[None, :], pick]
        q = np.where(rng.random((M, R)) < 0.5, exact, q).astype(np.float32)
        want = np.asarray(jtables.searchsorted_left(jnp.asarray(tab), jnp.asarray(q),
                                                    on_tpu=on_tpu))
        got = ttables.searchsorted_left(torch.from_numpy(tab), torch.from_numpy(q))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize(
    "edges,G,h,exact",
    [
        (lattice.square(3, 3), 1.0, 0.0, True),
        (lattice.frustrated_square(3, 3), 0.7, 0.4, False),
    ],
)
def test_heatbath_tables_match_jax(edges, G, h, exact):
    jm = jmodel.tfim_model(edges, G, h)
    tm = tmodel.tfim_model(edges, G, h, device="cpu")
    np.testing.assert_array_equal(np_(tm.max_diag_w()), np.asarray(jm.max_diag_w()))
    bs = np.random.default_rng(1).uniform(0.5, 1.5, (4, jm.nbonds)).astype(np.float32)
    for scale in (None, bs):
        want = jdiag.make_heatbath_tables(jm, None if scale is None else jnp.asarray(scale))
        got = tdiag.make_heatbath_tables(tm, None if scale is None else torch.from_numpy(scale))
        for g, w in zip(got, want):
            assert g.shape == w.shape and g.dtype == torch.float32
            if exact and scale is None:
                np.testing.assert_array_equal(np_(g), np.asarray(w))
            else:
                np.testing.assert_allclose(np_(g), np.asarray(w), rtol=1e-6)


def _compare_diagonal(L, G, h, beta, heatbath, scaled, seed=3):
    edges = lattice.frustrated_square(L, L)
    bond, inputs, outputs, state = port_chain_state(
        edges, transverse=G, longitudinal=h, replicas=8, seed=seed, beta=beta)
    jm = jmodel.tfim_model(edges, G, h)
    jops = jax_opstring(bond, inputs, outputs)
    M, R = bond.shape
    bs = (jax.random.uniform(jax.random.key(L), (R, jm.nbonds), minval=0.5, maxval=1.5)
          if scaled else None)
    hbt = jdiag.make_heatbath_tables(jm, bs) if heatbath else None
    key = jax.random.key(42)
    want = jdiag._diagonal_update_fast(jops, jnp.asarray(state), jnp.float32(beta), key,
                                       jm, hb=hbt, heatbath=heatbath, bond_scale=bs)
    u = t_(jax.random.uniform(key, (3, M, R)))
    tm = torch_model(jm)
    sse = torch_sse(jops, state)
    hb_t = (convert.heatbath_tables_from_numpy(np.asarray(hbt.cum_max_w),
                                               np.asarray(hbt.total), "cpu")
            if heatbath else None)
    got = tdiag.diagonal_update(sse.ops, sse.state, beta, u, tm, hb=hb_t,
                                heatbath=heatbath, bond_scale=None if bs is None else t_(bs))
    assert_ops_equal(got, want)
    assert not np.array_equal(np.asarray(want.bond), bond)
    assert bool(tops.verify(got, sse.state, tm).all())


@pytest.mark.parametrize(
    "L,G,h,beta,heatbath,scaled",
    [
        (4, 1.2, 0.0, 0.8, True, False),
        (3, 1.0, 0.3, 1.0, True, False),
        (3, 1.0, 0.2, 1.0, True, True),
        (3, 1.0, 0.0, 1.0, False, True),  # Metropolis with bond scales
    ],
)
def test_diagonal_update_matches_jax(L, G, h, beta, heatbath, scaled):
    _compare_diagonal(L, G, h, beta, heatbath, scaled)


def test_heatbath_diagonal_update_matches_jax_kernel_branch(monkeypatch):
    """JAX's Pallas parity and carry kernels forced on (interpret mode): its
    heat-bath carry then runs ``_kernel_heatbath``, which the port's K3-hb
    follows."""
    monkeypatch.setattr(jdiag, "_FORCE_PARITY_KERNEL", True)
    monkeypatch.setattr(jdiag, "_FORCE_CARRY_KERNEL", True)
    jdiag._diagonal_update_fast.clear_cache()
    try:
        _compare_diagonal(3, 1.0, 0.3, 1.0, True, False)
    finally:
        jdiag._diagonal_update_fast.clear_cache()


def test_heatbath_with_scales_needs_per_replica_tables():
    tm = tmodel.tfim_model(lattice.chain(4), 1.0, device="cpu")
    sse = tising.QmcIsingGraph(lattice.chain(4), 1.0, replicas=2, device="cpu").sse
    u = torch.rand((3, sse.ops.cutoff, 2))
    with pytest.raises(ValueError, match="per-replica"):
        tdiag.diagonal_update(sse.ops, sse.state, 1.0, u, tm,
                              hb=tdiag.make_heatbath_tables(tm), heatbath=True,
                              bond_scale=torch.ones((2, tm.nbonds)))
    with pytest.raises(ValueError, match="tables"):
        tdiag.diagonal_update(sse.ops, sse.state, 1.0, u, tm, heatbath=True)


def test_heatbath_multi_sweep_matches_jax():
    edges = lattice.square(3, 3)
    bond, inputs, outputs, state = port_chain_state(edges, replicas=8, seed=31)
    jm = jmodel.tfim_model(edges, 1.0)
    hbt = jdiag.make_heatbath_tables(jm)
    sse_j = jising.SseState(ops=jax_opstring(bond, inputs, outputs),
                            state=jnp.asarray(state), key=jax.random.key(5))
    sse_j2, ns_j, _, _ = jising.multi_sweep(sse_j, jnp.float32(1.0), jm, 4, hb=hbt,
                                            heatbath=True)
    hb_t = convert.heatbath_tables_from_numpy(np.asarray(hbt.cum_max_w),
                                              np.asarray(hbt.total), "cpu")
    sse_t, ns_t, _, _ = tising.multi_sweep(torch_sse(sse_j.ops, state), 1.0, torch_model(jm),
                                        4, JaxKeyDraws(sse_j.key).next, hb=hb_t,
                                        heatbath=True)
    assert_ops_equal(sse_t.ops, sse_j2.ops)
    np.testing.assert_array_equal(np_(sse_t.state), np.asarray(sse_j2.state))
    np.testing.assert_array_equal(np_(ns_t), np.asarray(ns_j))


def test_port_heatbath_chain_matches_exact_diagonalization():
    L, beta, gamma = 4, 1.0, 1.0
    edges = lattice.chain(L, j=1.0, periodic=True)
    exact = exact_tfim_energy(edges, gamma, 0.0, beta, L)
    g = tising.QmcIsingGraph(edges, gamma, replicas=256, seed=9, device="cpu")
    g.set_enable_heatbath(True)
    g.timesteps(60, beta)
    assert g.verify()
    e = g.timesteps(200, beta).numpy()
    se = e.std() / np.sqrt(len(e))
    assert abs(e.mean() - exact) < max(4 * se, 0.08), (e.mean(), exact, se)
    assert g.verify()
