"""The port's remaining public surface against the JAX package's:

- ``multi_sweep(cluster_flags=...)``: bit-identical to ``cluster_every=k``
  for ``(k, ns)`` in {(1, 6), (3, 7)} (the oracle of
  ``tests/test_thinning.py:60``), and bit-equal to JAX's ``cluster_flags``
  on JAX's draws;
- ``sse.cluster.cluster_labels``: the same partition of the op sides as
  JAX's (label values are segment ids, so partitions are compared), on the
  full and the compact branch;
- ``checkpoint.save_pytree``/``load_pytree``: nested tuples, lists and
  dicts round-trip, and a file either package writes loads in the other;
- ``new_thread_rng`` and the container's ``rng_key`` (its generator);
- ``rvb.contiguous_bits`` on JAX's uniforms, ``rvb.rvb_update_once`` on
  JAX's draws (in the replicas no acceptance sits within 4 ulp of its
  threshold, as ``tests/test_torch_rvb.py``), ``is_valid_cluster_edge``;
- ``profiling``: a trace file, a positive time, an ``annotate`` span in the
  profile's events;
- ``examples/torch/*.py`` import neither ``jax`` nor ``isingmontecarlo_tpu``
  (read as syntax trees, not run).
"""

import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_utils import (
    JaxKeyDraws, JaxRvbDraws, assert_equal_where_decided, assert_ops_equal, decided_replicas,
    jax_graph, np_, t_, torch_model, torch_sse,
)

from isingmontecarlo_tpu import checkpoint as jckpt
from isingmontecarlo_tpu import lattice
from isingmontecarlo_tpu.sse import cluster as jcl
from isingmontecarlo_tpu.sse import ising as jising
from isingmontecarlo_tpu.sse import rvb as jrvb
from isingmontecarlo_tpu_torch import checkpoint as tckpt
from isingmontecarlo_tpu_torch import profiling
from isingmontecarlo_tpu_torch.parallel import TemperingContainer, new_thread_rng
from isingmontecarlo_tpu_torch.sse import cluster as tcl
from isingmontecarlo_tpu_torch.sse import ising as tising
from isingmontecarlo_tpu_torch.sse import rvb as trvb

from torch_port_utils import release_jax_executables  # noqa: F401  (autouse)

torch.set_num_threads(1)

EXAMPLES = Path(__file__).resolve().parent.parent / "examples" / "torch"


# -- multi_sweep(cluster_flags=...) ---------------------------------------------------


@pytest.mark.parametrize("k,ns", [(1, 6), (3, 7)])
def test_cluster_flags_bit_identical_to_cluster_every(k, ns):
    g = tising.QmcIsingGraph(lattice.square(4, 4, j=1.0), 1.0, cutoff=96, replicas=4, seed=3,
                             device="cpu")
    for _ in range(6):
        g.timestep(1.0)
    state = g.draws.generator.get_state()
    outs = []
    for kw in (dict(cluster_every=k),
               dict(cluster_flags=[i % k == k - 1 for i in range(ns)]),
               dict(cluster_flags=torch.arange(ns) % k == k - 1)):
        g.draws.generator.set_state(state)
        outs.append(tising.multi_sweep(g.sse, 1.0, g.model, ns, lambda: g.draws,
                                       cluster_caps=g._cluster_caps, **kw))
    for sse, ns_, _, succ in outs[1:]:
        assert_ops_equal(sse.ops, outs[0][0].ops)
        assert torch.equal(sse.state, outs[0][0].state)
        assert torch.equal(ns_, outs[0][1]) and torch.equal(succ, outs[0][3])
    with pytest.raises(ValueError, match="cluster_flags"):
        tising.multi_sweep(g.sse, 1.0, g.model, ns, lambda: g.draws, cluster_flags=[True])


def test_cluster_flags_match_jax():
    g = jax_graph(lattice.chain(8), transverse=1.0, replicas=8, seed=22, beta=1.5,
                  nsweeps=4, cutoff=64)
    g._maybe_grow()
    flags = [False, True, True, False, True]
    sse_j, ns_j, states_j, _ = jising.multi_sweep(
        g.sse, jnp.float32(1.5), g.model, 5, cluster_caps=g._cluster_caps,
        collect_states=True, cluster_flags=jnp.asarray(flags))
    sse_t, ns_t, states_t, _ = tising.multi_sweep(
        torch_sse(g.sse.ops, g.sse.state), 1.5, torch_model(g.model), 5,
        JaxKeyDraws(g.sse.key).next, cluster_caps=g._cluster_caps, collect_states=True,
        cluster_flags=torch.tensor(flags))
    assert_ops_equal(sse_t.ops, sse_j.ops)
    np.testing.assert_array_equal(np_(sse_t.state), np.asarray(sse_j.state))
    np.testing.assert_array_equal(np_(ns_t), np.asarray(ns_j))
    np.testing.assert_array_equal(np_(states_t), np.asarray(states_j))


# -- cluster_labels ------------------------------------------------------------------


def _partition(labels: np.ndarray) -> np.ndarray:
    """Each column's labels renumbered by first appearance: equal arrays
    mean equal partitions."""
    out = np.empty_like(labels)
    for r in range(labels.shape[1]):
        _, first, inv = np.unique(labels[:, r], return_index=True, return_inverse=True)
        out[:, r] = np.argsort(np.argsort(first))[inv]
    return out


@pytest.mark.parametrize("caps", [None, (256, 256)])
def test_cluster_labels_match_jax_partition(caps):
    g = jax_graph(lattice.square(4, 4, j=1.0), transverse=0.7, replicas=6, seed=5,
                  beta=1.2, nsweeps=6, cutoff=None)
    ops = g.sse.ops
    if caps is not None:  # a cutoff large enough for the compact branch
        from isingmontecarlo_tpu.sse import opstring as jops

        ops = jops.grow(ops, 512)
    lc, ec = caps or (None, None)
    want = np.asarray(jcl.cluster_labels(ops, g.model, label_cap=lc, edge_cap=ec))
    tops = torch_sse(ops, g.sse.state).ops
    got = tcl.cluster_labels(tops, torch_model(g.model), label_cap=lc, edge_cap=ec)
    assert tuple(got.shape) == want.shape == (2 * ops.bond.shape[0], 6)
    np.testing.assert_array_equal(_partition(np_(got)), _partition(want))
    assert len(np.unique(want[:, 0])) > 2  # more than the dump and one cluster


# -- save_pytree / load_pytree -----------------------------------------------------------


def _tree():
    return ({"b": torch.arange(6, dtype=torch.int32).reshape(2, 3), "a": torch.ones(3)},
            [torch.tensor([True, False]), (torch.full((2, 2), 7, dtype=torch.uint8),)])


def _assert_tree_equal(got, want):
    lg, lw = tckpt._leaves(got), tckpt._leaves(want)
    assert len(lg) == len(lw)
    for a, b in zip(lg, lw):
        np.testing.assert_array_equal(np_(a), np_(b))
        assert np_(a).dtype == np_(b).dtype


def test_pytree_round_trip_and_layout(tmp_path):
    path = tmp_path / "tree.npz"
    tree = _tree()
    tckpt.save_pytree(str(path), tree, step=7, name="x")
    got, meta = tckpt.load_pytree(str(path), tree, device="cpu")
    _assert_tree_equal(got, tree)
    assert isinstance(got, tuple) and isinstance(got[0], dict) and isinstance(got[1], list)
    assert int(meta["step"]) == 7 and str(meta["name"]) == "x"
    # JAX's leaf order: dicts by sorted key.
    with np.load(path) as data:
        assert sorted(data.files) == ["leaf0", "leaf1", "leaf2", "leaf3", "meta_name",
                                      "meta_step"]
        np.testing.assert_array_equal(data["leaf0"], np.ones(3, np.float32))


def test_pytree_files_load_across_packages(tmp_path):
    tree = _tree()
    like_j = jax.tree_util.tree_map(lambda t: jnp.asarray(np_(t)), tree)
    tckpt.save_pytree(str(tmp_path / "port.npz"), tree, seed=3)
    got_j, meta = jckpt.load_pytree(str(tmp_path / "port.npz"), like_j)
    _assert_tree_equal(got_j, tree)
    assert int(meta["seed"]) == 3
    key_tree = {"key": jax.random.key(5), "x": jnp.arange(4)}
    jckpt.save_pytree(str(tmp_path / "jax.npz"), (like_j, key_tree), seed=4)
    got, meta = tckpt.load_pytree(str(tmp_path / "jax.npz"), (tree, {"key": 0, "x": 0}),
                                  device="cpu")
    _assert_tree_equal(got[0], tree)
    np.testing.assert_array_equal(np_(got[1]["key"]),
                                  np.asarray(jax.random.key_data(jax.random.key(5))))
    np.testing.assert_array_equal(np_(got[1]["x"]), np.arange(4))
    assert int(meta["seed"]) == 4


# -- new_thread_rng, rng_key ---------------------------------------------------------------


def test_new_thread_rng_and_rng_key():
    a, b = new_thread_rng(device="cpu"), new_thread_rng(device="cpu")
    assert a.graph is None and a._pending == []
    assert (a._seed, b._seed) != (0, 0)
    tc, twin = (TemperingContainer(lattice.chain(4), 1.0, betas=[0.5, 1.0], seed=4,
                                   device="cpu") for _ in range(2))
    gen = tc.rng_key
    assert isinstance(gen, torch.Generator) and gen is tc.graph.draws.generator
    gen.manual_seed(77)
    fresh = torch.Generator().manual_seed(77)
    twin.rng_key = fresh
    assert twin.rng_key is fresh and twin.graph.draws.generator is fresh
    for c in (tc, twin):
        c.timesteps(5)
        c.tempering_step()
    assert_ops_equal(twin.graph.sse.ops, tc.graph.sse.ops)
    assert torch.equal(twin.betas, tc.betas)


# -- rvb.contiguous_bits, rvb.rvb_update_once, cluster.is_valid_cluster_edge ----------


def test_contiguous_bits_match_jax():
    key = jax.random.key(31)
    u = jax.random.uniform(key, (512,), minval=1e-19, maxval=1.0)
    got = trvb.contiguous_bits(t_(u))
    np.testing.assert_array_equal(np_(got), np.asarray(jrvb.contiguous_bits(key, (512,))))
    assert got.dtype == torch.int32 and int(got.max()) >= 4


def test_rvb_update_once_matches_jax():
    from test_torch_rvb import TensorRvbDraws, _replica_rows, _setup, _sweep_draws

    jm, jt, jops, jstate, tm, tt, sse = _setup(lattice.square(4, 4), h=0.3, seed=11)
    key = jax.random.key(13)
    # rvb_sweep's one update draws from split(key, 1)[0] (rvb.py:1534).
    ops_j, state_j, acc_j = jrvb.rvb_update_once(jops, jstate, jax.random.split(key, 1)[0],
                                                 jm, jt)
    M, R = sse.ops.bond.shape
    ew = min(trvb.cand_width(M, tm.nvars, tt), tt.nedges)
    us = _sweep_draws(JaxRvbDraws(key, 1), 1, M, R, tm.nvars, ew)

    def run(*u):
        ops, state, acc = trvb.rvb_update_once(sse.ops, sse.state, TensorRvbDraws(*u), tm, tt)
        assert acc.dtype == torch.bool
        return _replica_rows(ops, state, acc)

    decided, got = decided_replicas(run, *us)
    want = _replica_rows(torch_sse(ops_j, state_j).ops, t_(state_j), t_(acc_j))
    assert_equal_where_decided(got, want, decided)
    assert bool(np.asarray(acc_j).any())


def test_is_valid_cluster_edge_matches_jax():
    const = np.array([True, True, False, False])
    nv = np.array([1, 2, 1, 2])
    np.testing.assert_array_equal(np_(tcl.is_valid_cluster_edge(torch.from_numpy(const),
                                                                torch.from_numpy(nv))),
                                  np.asarray(jcl.is_valid_cluster_edge(const, nv)))
    assert bool(tcl.is_valid_cluster_edge(True, 1)) and not bool(
        tcl.is_valid_cluster_edge(True, 2))


# -- profiling --------------------------------------------------------------------------


def test_profiling_trace_time_and_annotate(tmp_path):
    x = torch.randn(64, 64)
    with profiling.trace(str(tmp_path)) as prof:
        with profiling.annotate("port_span"):
            (x @ x).sum()
    assert list(tmp_path.glob("trace.*.json"))
    assert any(e.name == "port_span" for e in prof.events())
    ms = profiling.time_fn(lambda: x @ x, iters=2, warmup=1)
    assert isinstance(ms, float) and ms > 0


# -- examples/torch ----------------------------------------------------------------------


def test_torch_examples_import_no_jax():
    files = sorted(EXAMPLES.glob("*.py"))
    assert [f.name for f in files] == sorted(
        f.name for f in (EXAMPLES.parent).glob("*.py")), "an example is not ported"
    for f in files:
        tree = ast.parse(f.read_text(), filename=str(f))
        names = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names.update(a.name for a in node.names)
            elif isinstance(node, ast.ImportFrom) and node.module:
                names.add(node.module)
        bad = {n for n in names if n.split(".")[0] in ("jax", "isingmontecarlo_tpu")}
        assert not bad, f"{f.name} imports {sorted(bad)}"
        assert any(n.startswith("isingmontecarlo_tpu_torch") for n in names), f.name
        assert "--device" in f.read_text(), f"{f.name} takes no --device"
