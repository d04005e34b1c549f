"""The port's Metropolis diagonal update against the JAX package's
``_diagonal_update_fast`` with the same uniforms ``u[3, M, R]``: exact on
``bond``, ``inputs`` and ``outputs``. Both evaluate the same f32 expressions
in the same order (``num = (beta * NB) * w``, then ``u0 * (M - n) < num``),
so a differing bit would mean a differing evaluation order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_utils import assert_ops_equal, jax_graph, t_, torch_model, torch_sse

from isingmontecarlo_tpu import lattice
from isingmontecarlo_tpu.sse import diagonal as jdiag
from isingmontecarlo_tpu_torch.sse import diagonal as tdiag
from isingmontecarlo_tpu_torch.sse import opstring as tops

from torch_port_utils import release_jax_executables  # noqa: F401  (autouse)

torch.set_num_threads(1)


def _compare(g, beta, key):
    ops, state, model = g.sse.ops, g.sse.state, g.model
    M, R = ops.bond.shape
    want = jdiag._diagonal_update_fast(ops, state, jnp.float32(beta), key, model)
    u = t_(jax.random.uniform(key, (3, M, R)))
    sse = torch_sse(ops, state)
    tm = torch_model(model)
    got = tdiag.diagonal_update(sse.ops, sse.state, beta, u, tm)
    assert_ops_equal(got, want)
    assert not np.array_equal(np.asarray(want.bond), np.asarray(ops.bond))
    assert bool(tops.verify(got, sse.state, tm).all())


@pytest.mark.parametrize(
    "edges,G,h,beta,R,seed",
    [
        (lattice.square(3, 3), 1.0, 0.0, 1.0, 8, 3),
        (lattice.frustrated_square(3, 3), 0.7, 0.4, 1.5, 8, 4),
        (lattice.chain(8), 1.0, 0.0, 2.0, 16, 5),
    ],
)
def test_diagonal_update_matches_jax(edges, G, h, beta, R, seed):
    g = jax_graph(edges, transverse=G, longitudinal=h, replicas=R, seed=seed,
                  beta=beta, nsweeps=6, cutoff=96)
    _compare(g, beta, jax.random.key(seed + 100))


def test_diagonal_update_matches_jax_kernel_branch(monkeypatch):
    """With the JAX package's Pallas parity and carry kernels forced on (in
    interpret mode, as its own tests run them) its diagonal update takes the
    branch the port follows; the port must match that too."""
    g = jax_graph(lattice.square(3, 3), transverse=1.0, replicas=8, seed=3,
                  beta=1.0, nsweeps=6, cutoff=96)
    monkeypatch.setattr(jdiag, "_FORCE_PARITY_KERNEL", True)
    monkeypatch.setattr(jdiag, "_FORCE_CARRY_KERNEL", True)
    jdiag._diagonal_update_fast.clear_cache()
    try:
        _compare(g, 1.0, jax.random.key(7))
    finally:
        jdiag._diagonal_update_fast.clear_cache()
