"""The port's segment graph, hook labels and cluster update against the JAX
package on the same op strings and the same per-root uniforms.

- ``segment_graph`` and the hook-and-compress labels: exact (integer work;
  ``torch.sort(stable=True)`` as ``lax.sort`` is stable, and the hook
  schedule is kept, so even the root ids agree).
- The cluster update at h = 0: exact. Every weight ratio is 1, so
  ``exp(0) = 1`` and every flip probability is exactly 0.5.
- At h != 0: exact except at ulp ties, where ``|u_root - flip_prob| <
  1e-6``, since ``log``/``exp`` may differ in the last ulp between XLA and
  PyTorch; the count of ties is reported.
"""

from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from torch_port_utils import (
    JaxSweepDraws, assert_ops_equal, jax_graph, np_, torch_model, torch_sse,
)

from isingmontecarlo_tpu import lattice
from isingmontecarlo_tpu.sse import cluster as jcl
from isingmontecarlo_tpu.sse import opstring as jops
from isingmontecarlo_tpu_torch.sse import cluster as tcl
from isingmontecarlo_tpu_torch.sse import opstring as tops

from torch_port_utils import release_jax_executables  # noqa: F401  (autouse)

torch.set_num_threads(1)

CASES = {
    "square_h0": dict(edges=lattice.square(3, 3), transverse=1.0, replicas=8, seed=3),
    "frustrated_h": dict(edges=lattice.frustrated_square(3, 3), transverse=0.8,
                         longitudinal=0.4, replicas=8, seed=4, beta=1.5),
    "chain_h0": dict(edges=lattice.chain(8), transverse=1.0, replicas=16, seed=5,
                     beta=2.0),
}
_GRAPHS = {}


def _graph(name, cutoff=96):
    """A JAX graph of case ``name``, its op string padded to ``cutoff``."""
    if name not in _GRAPHS:
        _GRAPHS[name] = jax_graph(**CASES[name], nsweeps=6, cutoff=96)
    g = _GRAPHS[name]
    return SimpleNamespace(sse=g.sse._replace(ops=jops.grow(g.sse.ops, cutoff)),
                           model=g.model)


@pytest.mark.parametrize("name", list(CASES))
def test_segment_graph_and_labels_match_jax(name):
    g = _graph(name)
    sg_j = jcl.segment_graph(g.sse.ops, g.model)
    sse = torch_sse(g.sse.ops, g.sse.state)
    sg_t = tcl.segment_graph(sse.ops, torch_model(g.model))
    assert sg_t.S == sg_j.S
    for field in ("seg_in", "seg_out", "u", "v", "nseg", "head_f"):
        got, want = np_(getattr(sg_t, field)), np.asarray(getattr(sg_j, field))
        assert got.dtype == want.dtype, field
        np.testing.assert_array_equal(got, want, err_msg=field)
    P_j = jcl._hook_compress_labels(sg_j.u, sg_j.v, sg_j.S)
    P_t = tcl.hook_compress_labels(sg_t.u, sg_t.v, sg_t.S)
    np.testing.assert_array_equal(np_(P_t), np.asarray(P_j))
    assert len(np.unique(np.asarray(P_j))) > 2


def _cluster_both(g, caps, key, monkeypatch):
    """Run both cluster updates; returns (jax result, port result, the
    port's u_root and per-root (flip_prob, frozen) of that run)."""
    ops, state, model = g.sse.ops, g.sse.state, g.model
    M = ops.bond.shape[0]
    lc, ec = caps if caps is not None else (M + model.nvars + 1, None)
    sg_j = jcl.segment_graph(ops, model)
    want = jcl._cluster_update_impl(ops, state, key, model, 0.5, lc, ec, sg_j)

    seen = {}
    real = tcl.root_flip_prob

    def spy(*args):
        seen["fp"], seen["frozen"] = real(*args)
        return seen["fp"], seen["frozen"]

    monkeypatch.setattr(tcl, "root_flip_prob", spy)
    tm = torch_model(model)
    sse = torch_sse(ops, state)
    d = JaxSweepDraws(None, key, None)
    sg_t = tcl.segment_graph(sse.ops, tm)
    got = tcl.cluster_update_impl(sse.ops, sse.state, d.cluster, tm, 0.5, lc, ec, sg_t)
    assert bool(tops.verify(got[0], got[1], tm).all())
    shapes = list(d.cluster_shapes)
    u_root = d.cluster(shapes[0]) if shapes else None
    return want, got, shapes, u_root, seen


@pytest.mark.parametrize(
    "name,caps,cutoff,branch",
    [
        ("square_h0", None, 96, "full"),       # cap-less: full label space S
        ("chain_h0", None, 96, "full"),
        ("square_h0", (256, 256), 512, "compact"),  # S = 522 > 256 + 64
        ("square_h0", (16, 16), 512, "skip"),  # caps overflow: no update
    ],
)
def test_cluster_update_h0_matches_jax(name, caps, cutoff, branch, monkeypatch):
    g = _graph(name, cutoff)
    want, got, shapes, _, _ = _cluster_both(g, caps, jax.random.key(11), monkeypatch)
    assert_ops_equal(got[0], want[0])
    np.testing.assert_array_equal(np_(got[1]), np.asarray(want[1]))
    M, R = g.sse.ops.bond.shape
    flipped = not np.array_equal(np.asarray(want[0].inputs), np.asarray(g.sse.ops.inputs))
    if branch == "skip":
        assert shapes == [] and not flipped
    else:
        SL = M + g.model.nvars + 1 if branch == "full" else caps[0]
        assert shapes == [(SL, R)] and flipped


def test_cluster_update_longitudinal_matches_jax_except_ties(monkeypatch, record_property):
    g = _graph("frustrated_h")
    want, got, shapes, u_root, seen = _cluster_both(g, None, jax.random.key(12), monkeypatch)
    ties = ((u_root - seen["fp"]).abs() < 1e-6) & ~seen["frozen"]
    n_ties = int(ties.sum())
    record_property("ulp_ties", n_ties)
    print(f"ulp ties: {n_ties} of {ties.numel()} roots")
    ok = ~ties.any(dim=0).numpy()  # replicas whose decisions hold no tie
    assert ok.sum() >= len(ok) - 1
    for name in ("bond", "inputs", "outputs"):
        np.testing.assert_array_equal(np_(getattr(got[0], name))[..., ok],
                                      np.asarray(getattr(want[0], name))[..., ok])
    np.testing.assert_array_equal(np_(got[1])[ok], np.asarray(want[1])[ok])
    assert seen["frozen"].any()  # the longitudinal ops freeze some clusters
