"""The port's RVB update (``isingmontecarlo_tpu_torch/sse/rvb.py``) against
the JAX package's (``isingmontecarlo_tpu/sse/rvb.py``) on the same inputs
and draws, on the CPU.

- ``make_rvb_tables`` and the constant-op inventory: exact.
- Cluster growth, its masks and candidate edges on JAX's draws from one
  key: exact in decided replicas (no draw within 4 ulp of a decision).
- The acceptance-and-mutation pass, one-shot and chunked, with and without
  candidate edges, on the same injected Gumbels: the candidate string
  exact, ``p_acc`` within ``rtol=1e-5`` (the log-weight sums run in
  another order, as JAX's own vectorized and scan paths do).
- Compaction round trips, and overflowing lanes left as they were.
- One ``rvb_sweep`` (U = 3) and one RVB ``sweep``, driven by JAX's key
  tree: exact in decided replicas; the sweep's build batching and chunked
  pass leave its outputs unchanged.

Op strings come from the port's own chain (``port_chain_state``), so no
JAX chain is compiled; of JAX's sweeps, two programs are (``rvb_sweep``
and ``sweep``), besides the jitted fused pass at each test shape.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_utils import (
    JaxKeyDraws, JaxRvbDraws, assert_equal_where_decided, assert_ops_equal, decided_replicas,
    jax_opstring, np_, port_chain_state, t_, torch_model, torch_rvb_tables, torch_sse,
)

from isingmontecarlo_tpu import lattice
from isingmontecarlo_tpu.sse import ising as jising
from isingmontecarlo_tpu.sse import rvb as jrvb
from isingmontecarlo_tpu.sse.model import tfim_model as jtfim_model
from isingmontecarlo_tpu_torch.sse import ising as tising
from isingmontecarlo_tpu_torch.sse import rvb as trvb
from isingmontecarlo_tpu_torch.sse.diagonal import diagonal_update

from torch_port_utils import release_jax_executables  # noqa: F401  (autouse)

torch.set_num_threads(1)

RTOL = 1e-5  # p_acc: f32 log-weight sums in another order

# One compiled program per shape instead of an eager dispatch per operation.
jax_fused = jax.jit(jrvb._fused_vectorized, static_argnames=("want_carry",))


def _setup(edges, *, h=0.0, replicas=8, seed=3, beta=2.0, nsweeps=10, transverse=1.0):
    """JAX and port models, RVB tables and one op string (the port's chain)."""
    bond, inputs, outputs, state = port_chain_state(
        edges, transverse=transverse, longitudinal=h, replicas=replicas, seed=seed,
        beta=beta, nsweeps=nsweeps)
    jm = jtfim_model(edges, transverse, h)
    jt = jrvb.make_rvb_tables(edges, jm)
    tm = torch_model(jm)
    return (jm, jt, jax_opstring(bond, inputs, outputs), jnp.asarray(state),
            tm, torch_rvb_tables(jt), torch_sse(jax_opstring(bond, inputs, outputs), state))


@pytest.mark.parametrize("edges", [lattice.chain(4), lattice.square(3, 3),
                                   lattice.bench_two_d_periodic(4)],
                         ids=["chain4", "square3", "bench4"])
def test_make_rvb_tables_matches_jax(edges):
    jm = jtfim_model(edges, 1.0)
    want = jrvb.make_rvb_tables(edges, jm)
    got = trvb.make_rvb_tables(edges, torch_model(jm))
    assert got.nedges == want.nedges
    for name in ("neigh_bond", "neigh_var", "bond_mag"):
        np.testing.assert_array_equal(np_(getattr(got, name)),
                                      np.asarray(getattr(want, name)), err_msg=name)


@pytest.mark.parametrize("h", [0.0, 0.3])
def test_const_inventory_matches_jax(h):
    jm, _, jops, _, tm, _, sse = _setup(lattice.chain(4), h=h, replicas=8)
    want = jrvb._const_inventory(jops, jm)
    got = trvb.const_inventory(sse.ops, tm)
    assert int(np.asarray(want[4]).min()) > 0  # the string holds constant ops
    for name, a, b in zip(trvb.Inventory._fields, got, want):
        np.testing.assert_array_equal(np_(a), np.asarray(b), err_msg=name)


def test_cluster_build_masks_and_candidates_match_jax():
    """Two updates' builds in one batch, each against JAX's from its key."""
    jm, jt, jops, _, tm, tt, sse = _setup(lattice.square(6, 6), h=0.3, seed=5)
    M, R = jops.bond.shape
    N = jm.nvars
    inv_j = jrvb._const_inventory(jops, jm)
    inv = trvb.const_inventory(sse.ops, tm)
    U = 2
    draws = JaxRvbDraws(jax.random.key(640), U)
    us = (draws.seed(0, (U, R)), draws.size(0, (U, R)),
          torch.stack([draws.pop(0, i, (U, R, M + N)) for i in range(trvb.MAX_POPS)]))

    def build(u_seed, u_size, g):  # replicas first, for decided_replicas
        return trvb.build_clusters(inv, tt, u_seed, u_size, lambda i: g[i]).transpose(0, 1)

    decided, popped = decided_replicas(build, *us)
    popped = popped.transpose(0, 1)
    in0, tog = trvb.cluster_masks(popped, inv)
    cand, _ = trvb.update_columns(popped, inv, tt, tm, use_cand=True)
    assert cand.shape == (U, trvb.cand_width(M, N, tt), R)
    for u in range(U):
        pj = jrvb._build_cluster(draws.k_build[u], jops, jm, jt, *inv_j)
        assert_equal_where_decided(popped[u], np.asarray(pj), decided)
        in0_j, tog_j = jrvb._cluster_masks(pj, jops, jm, *inv_j[:4])
        cand_j = jrvb._cluster_cand_edges(pj, jops, jm, jt, inv_j[0], inv_j[3])
        assert_equal_where_decided(in0[u], np.asarray(in0_j), decided)
        assert_equal_where_decided(tog[u].T, np.asarray(tog_j).T, decided)
        assert_equal_where_decided(cand[u].T, np.asarray(cand_j).T, decided)
    assert int(np_(popped).sum()) > U * R  # clusters of more than one element


@functools.lru_cache(maxsize=None)
def _one_update(seed, h):
    """One update's masks and candidates on a 6x6 square lattice (NE = 72,
    candidate width 64), from JAX."""
    jm, jt, jops, jstate, tm, tt, sse = _setup(lattice.square(6, 6), h=h, seed=seed)
    inv_j = jrvb._const_inventory(jops, jm)
    k_build, _, k_mut = jax.random.split(jax.random.key(seed), 3)
    pj = jrvb._build_cluster(k_build, jops, jm, jt, *inv_j)
    in0, tog = jrvb._cluster_masks(pj, jops, jm, *inv_j[:4])
    cand = jrvb._cluster_cand_edges(pj, jops, jm, jt, inv_j[0], inv_j[3])
    inv = trvb.const_inventory(sse.ops, tm)
    cols = {}
    for use_cand in (False, True):
        c, cc = trvb.update_columns(t_(pj)[None], inv, tt, tm, use_cand)
        cols[use_cand] = trvb.Columns(*(x[0] for x in cc))
    np.testing.assert_array_equal(np_(c[0]), np.asarray(cand))
    return jm, jt, jops, jstate, tm, tt, sse, in0, tog, cand, k_mut, cols


def _bases(sse, in0, cols):
    return trvb.at_columns(sse.state, cols), trvb.at_columns(t_(in0), cols)


def _assert_pass_equal(got, want):
    np.testing.assert_allclose(np_(got[0]), np.asarray(want[0]), rtol=RTOL, atol=1e-7)
    for name, a, b in zip(("bond", "inputs", "outputs"), got[1:4], want[1:4]):
        np.testing.assert_array_equal(np_(a), np.asarray(b), err_msg=name)


@pytest.mark.parametrize("use_cand", [False, True], ids=["all_edges", "cand"])
@pytest.mark.parametrize("seed,h", [(51, 0.0), (53, 0.3)])
def test_fused_pass_matches_jax(seed, h, use_cand):
    jm, jt, jops, jstate, tm, tt, sse, in0, tog, cand, k_mut, cols = _one_update(seed, h)
    M, R = jops.bond.shape
    c = cand if use_cand else None
    ew = cand.shape[0] if use_cand else jt.nedges
    assert cand.shape[0] < jt.nedges
    g = jax.random.gumbel(k_mut, (M, R, ew))
    want = jax_fused(jops, jstate, jm, jt, in0, tog, k_mut, gumbels=g, cand=c)
    got = trvb.fused_pass(sse.ops, *_bases(sse, in0, cols[use_cand]), tm, tt, cols[use_cand],
                          t_(tog), t_(g))
    _assert_pass_equal(got, want)
    assert 0.0 < float(np.asarray(want[0]).max())  # some replica can accept


@pytest.mark.parametrize("use_cand", [False, True], ids=["all_edges", "cand"])
@pytest.mark.parametrize("mc", [16, 100])
def test_fused_chunked_matches_one_shot_and_jax(mc, use_cand):
    """Chunks of ``mc`` slots (with 100 the last one short): the carry of
    substate, cluster mask and log acceptance across chunk boundaries gives
    the one-shot pass's candidate string on the same noise, and JAX's
    chunked pass's."""
    jm, jt, jops, jstate, tm, tt, sse, in0, tog, cand, k_mut, cols = _one_update(53, 0.3)
    M, R = jops.bond.shape
    c = cand if use_cand else None
    ew = cand.shape[0] if use_cand else jt.nedges
    C = -(-M // mc)
    assert C > 2
    g = t_(jax.random.gumbel(k_mut, (C * mc, R, ew)))
    cols = cols[use_cand]
    args = (sse.ops, *_bases(sse, in0, cols), tm, tt, cols, t_(tog))
    got = trvb.fused_chunked(*args, lambda k, shape: g[k * mc:(k + 1) * mc], mc)
    one_shot = trvb.fused_pass(*args, g[:M])
    want = jrvb._fused_chunked(jops, jstate, jm, jt, in0, tog, k_mut, mc=mc,
                               gumbels=jnp.asarray(np_(g[:M])), cand=c)
    _assert_pass_equal(got, want)
    _assert_pass_equal(got, [np_(x) for x in one_shot])


def test_update_columns_cover_the_cluster():
    """Every popped variable and every end of a candidate edge has a column
    of its own; variables off the set map to column W, pad edges to W + 1
    at both ends."""
    jm, jt, jops, jstate, tm, tt, sse, in0, tog, cand, k_mut, cols = _one_update(51, 0.0)
    N, W = tm.nvars, trvb.set_width(tm.nvars, tt)
    c = cols[True]
    cand = np_(c.edge_id)  # [R, A]
    ends = np_(c.ends)
    lvars = np_(c.lvars)
    bv = np_(tm.bond_vars)
    for r in range(cand.shape[0]):
        inset = lvars[r][lvars[r] < N]
        assert len(set(inset.tolist())) == len(inset) <= W
        np.testing.assert_array_equal(np_(c.col)[r][inset], np.arange(len(inset)))
        off = np.setdiff1d(np.arange(N + 1), inset)
        assert (np_(c.col)[r][off] == W).all()
        assert set(np.nonzero(np.asarray(in0)[r])[0]) <= set(inset.tolist())
        A = cand.shape[1]
        for a in range(A):
            if cand[r, a] < tt.nedges:
                assert lvars[r][ends[r, a]] == bv[cand[r, a], 0]
                assert lvars[r][ends[r, A + a]] == bv[cand[r, a], 1]
            else:
                assert ends[r, a] == ends[r, A + a] == W + 1


def test_compact_round_trip_matches_jax():
    jm, _, jops, _, tm, _, sse = _setup(lattice.frustrated_square(4, 4), h=0.3, seed=6,
                                        replicas=16, beta=2.0)
    M = jops.cutoff
    counts = np_((sse.ops.bond >= 0).sum(dim=0))
    n_max = int(counts.max())
    assert 0 < n_max < M
    for mc in (n_max, min(M - 1, n_max + 7), M):
        got_c, got_tail, got_sk = trvb.compact_ops(sse.ops, mc)
        want_c, want_tail, want_sk = jrvb.compact_ops(jops, mc)
        assert_ops_equal(got_c, want_c)
        np.testing.assert_array_equal(np_(got_sk), np.asarray(want_sk))
        for a, b in zip(got_tail, want_tail):
            np.testing.assert_array_equal(np_(a), np.asarray(b))
        assert_ops_equal(trvb.uncompact_ops(got_c, got_tail, got_sk), sse.ops)
        assert int((got_c.bond >= 0).sum(dim=0).max()) == n_max


def test_overflow_lanes_keep_their_ops():
    """Replicas with more ops than the compaction cutoff keep string and
    state, with 0 successes; the others run the sweep (op count unchanged)."""
    edges = lattice.frustrated_square(4, 4)
    jm, jt, _, _, tm, tt, sse = _setup(edges, seed=9, replicas=32)
    counts = np_((sse.ops.bond >= 0).sum(dim=0))
    mc = int((counts.min() + counts.max()) // 2)
    over, fit = counts > mc, counts <= mc
    assert over.any() and fit.any()
    gen = torch.Generator().manual_seed(3)
    ops, state, succ = trvb.rvb_sweep(sse.ops, sse.state, trvb.GeneratorRvbDraws(gen), tm,
                                      tt, 5, compact_cutoff=mc)
    for name in ("bond", "inputs", "outputs"):
        np.testing.assert_array_equal(np_(getattr(ops, name))[..., over],
                                      np_(getattr(sse.ops, name))[..., over])
    np.testing.assert_array_equal(np_(state)[over], np_(sse.state)[over])
    assert (np_(succ)[over] == 0).all() and np_(succ)[fit].sum() > 0
    np.testing.assert_array_equal(np_((ops.bond >= 0).sum(dim=0)), counts)


class TensorRvbDraws:
    """RVB draws held as tensors: ``pops [16, U, R, M+N]``, ``rot [U, M, R, EW]``."""

    def __init__(self, seed, size, pops, accept, rot):
        self.s, self.z, self.p, self.a, self.r = seed, size, pops, accept, rot

    def seed(self, u0, shape):
        return self.s[u0:u0 + shape[0]]

    def size(self, u0, shape):
        return self.z[u0:u0 + shape[0]]

    def pop(self, u0, i, shape):
        return self.p[i, u0:u0 + shape[0]]

    def accept(self, u0, shape):
        return self.a[u0:u0 + shape[0]]

    def rotation(self, u, chunk, shape):
        assert chunk is None
        return self.r[u]


def _sweep_draws(draws, U, M, R, N, ew):
    return (draws.seed(0, (U, R)), draws.size(0, (U, R)),
            torch.stack([draws.pop(0, i, (U, R, M + N)) for i in range(trvb.MAX_POPS)]),
            draws.accept(0, (U, R)),
            torch.stack([draws.rotation(u, None, (M, R, ew)) for u in range(U)]))


def _replica_rows(ops, state, succ):
    """One row per replica of everything a sweep returns."""
    R = state.shape[0]
    return torch.cat([ops.bond.T, ops.inputs.permute(2, 0, 1).reshape(R, -1).int(),
                      ops.outputs.permute(2, 0, 1).reshape(R, -1).int(), state.int(),
                      succ[:, None].int()], dim=1)


def _decided_rvb_sweep(ops, state, tm, tt, key, U):
    """The port's rvb_sweep on JAX's draws, and its decided replicas."""
    M, R = ops.bond.shape
    N = tm.nvars
    ew = min(trvb.cand_width(M, N, tt), tt.nedges)
    us = _sweep_draws(JaxRvbDraws(key, U), U, M, R, N, ew)

    def run(*u):
        return _replica_rows(*trvb.rvb_sweep(ops, state, TensorRvbDraws(*u), tm, tt, U))

    return decided_replicas(run, *us)


def test_rvb_sweep_matches_jax():
    """Three updates on a 6x6 square lattice at h = 0.3 (candidate edges),
    builds batched, against the jitted JAX sweep."""
    jm, jt, jops, jstate, tm, tt, sse = _setup(lattice.square(6, 6), h=0.3, seed=11)
    key = jax.random.key(12)
    ops_j, state_j, succ_j = jrvb.rvb_sweep(jops, jstate, key, jm, jt, 3)
    decided, got = _decided_rvb_sweep(sse.ops, sse.state, tm, tt, key, 3)
    want = _replica_rows(torch_sse(ops_j, state_j).ops, t_(state_j), t_(succ_j))
    assert_equal_where_decided(got, want, decided)
    assert int(np.asarray(succ_j).sum()) > 0


def test_rvb_timestep_matches_jax():
    """A whole timestep with 3 RVB updates on a frustrated 3x3 lattice, the
    draws split from JAX's key as its sweep splits them."""
    edges = lattice.frustrated_square(3, 3)
    jm, jt, jops, jstate, tm, tt, sse = _setup(edges, seed=13, beta=3.0, replicas=16)
    key = jax.random.key(14)
    sse_j, succ_j = jising.sweep(jising.SseState(jops, jstate, key), jnp.float32(3.0), jm,
                                 rvb_tables=jt, n_rvb=3)
    draws = JaxKeyDraws(key).next()
    # The RVB stage's decided replicas, on the diagonal update's string.
    M, R = jops.bond.shape
    ops_d = diagonal_update(sse.ops, sse.state, 3.0, draws.diagonal((3, M, R)), tm)
    decided, _ = _decided_rvb_sweep(ops_d, sse.state, tm, tt, draws.k_rvb, 3)
    got, succ = tising.sweep(sse, 3.0, tm, draws, rvb_tables=tt, n_rvb=3)
    assert_equal_where_decided(_replica_rows(got.ops, got.state, succ),
                               _replica_rows(torch_sse(sse_j.ops, sse_j.state).ops,
                                             t_(sse_j.state), t_(succ_j)), decided)
    assert int(np_(succ).sum()) > 0


class SharedNoiseDraws(TensorRvbDraws):
    """:class:`TensorRvbDraws` whose rotation noise for chunk ``c`` of
    ``mc`` slots is rows ``[c mc, (c + 1) mc)`` of the one-shot pass's."""

    def rotation(self, u, chunk, shape):
        lo = 0 if chunk is None else chunk * shape[0]
        return self.r[u][lo:lo + shape[0]]


def test_build_batches_and_chunks_keep_the_sweep(monkeypatch):
    """Builds one update at a time and the pass in chunks of 128 slots (both
    gates forced) give the default sweep's string, state and successes on
    the same draws."""
    jm, jt, jops, jstate, tm, tt, sse = _setup(lattice.square(6, 6), h=0.3, seed=11)
    M, R = jops.bond.shape
    U, mc = 3, 128
    ew = trvb.cand_width(M, tm.nvars, tt)
    assert M > 2 * mc and trvb.use_candidates(M, tm.nvars, tt)
    draws = JaxRvbDraws(jax.random.key(12), U)
    us = _sweep_draws(draws, U, M, R, tm.nvars, ew)
    rot = torch.stack([draws.rotation(u, None, (-(-M // mc) * mc, R, ew)) for u in range(U)])
    want = trvb.rvb_sweep(sse.ops, sse.state, SharedNoiseDraws(*us[:4], rot), tm, tt, U)
    monkeypatch.setattr(trvb, "BUILD_MAX_ELEMS", 1)
    monkeypatch.setattr(trvb, "VEC_MAX_ELEMS", 1)
    assert trvb.fused_chunk_size(M, R, ew, 2, trvb.set_width(tm.nvars, tt)) == mc
    got = trvb.rvb_sweep(sse.ops, sse.state, SharedNoiseDraws(*us[:4], rot), tm, tt, U)
    torch.testing.assert_close(_replica_rows(*got), _replica_rows(*want), rtol=0, atol=0)
    assert int(want[2].sum()) > 0


def test_sweep_refuses_rvb_without_tables():
    edges = lattice.chain(4)
    g = tising.QmcIsingGraph(edges, 1.0, replicas=2, device="cpu")
    with pytest.raises(ValueError):
        tising.sweep(g.sse, 1.0, g.model, g.draws, n_rvb=2)
