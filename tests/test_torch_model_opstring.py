"""The port's model tables, op-string helpers, lattices and ESS against the
JAX package: exact (the same numpy construction; integer and table work),
ESS to relative 1e-9 (float64 numpy on both sides)."""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_utils import MODEL_LEAVES, jax_graph, np_, torch_model, torch_sse

from isingmontecarlo_tpu import lattice as jlat
from isingmontecarlo_tpu.analysis import autocorr as jac
from isingmontecarlo_tpu.sse import model as jmodel
from isingmontecarlo_tpu.sse import opstring as jops
from isingmontecarlo_tpu_torch import lattice as tlat
from isingmontecarlo_tpu_torch.analysis import autocorr as tac
from isingmontecarlo_tpu_torch.sse import model as tmodel
from isingmontecarlo_tpu_torch.sse import opstring as tops

from torch_port_utils import release_jax_executables  # noqa: F401  (autouse)

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize(
    "edges,G,h",
    [
        (jlat.chain(8), 1.0, 0.0),
        (jlat.square(3, 3), 0.7, 0.3),
        (jlat.bench_two_d_periodic(4), 1.0, 0.0),
    ],
)
def test_tfim_model_tables_equal_jax(edges, G, h):
    jm = jmodel.tfim_model(edges, G, h)
    tm = tmodel.tfim_model(edges, G, h, device="cpu")
    for name in MODEL_LEAVES:
        want = np.asarray(getattr(jm, name))
        got = np_(getattr(tm, name))
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert (tm.offset, tm.nvars, tm.nbonds, tm.max_legs) == (
        jm.offset, jm.nvars, jm.nbonds, jm.max_legs)
    np.testing.assert_array_equal(np_(tm.arity()), np.asarray(jm.arity()))
    assert {n for n, _ in tm.named_buffers()} == set(MODEL_LEAVES)


@pytest.mark.parametrize("name,args", [
    ("chain", (8,)), ("chain", (5, -1.0, False)), ("square", (3, 4)),
    ("square", (2, 2, 1.0, True)), ("bench_two_d_periodic", (6,)),
])
def test_lattice_copies_equal_jax(name, args):
    edges = getattr(tlat, name)(*args)
    assert edges == getattr(jlat, name)(*args)
    assert tlat.nvars_from_edges(edges) == jlat.nvars_from_edges(edges)
    for a, b in zip(tlat.edge_arrays(edges), jlat.edge_arrays(edges)):
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def jax_state():
    return jax_graph(jlat.square(3, 3), transverse=0.8, longitudinal=0.4,
                     replicas=8, seed=11, beta=1.5, nsweeps=6, cutoff=64)


def test_opstring_helpers_equal_jax(jax_state):
    g = jax_state
    sse = torch_sse(g.sse.ops, g.sse.state)
    tm = torch_model(g.model)
    ops = sse.ops
    np.testing.assert_array_equal(np_(tops.op_count(ops)), np.asarray(jops.op_count(g.sse.ops)))
    np.testing.assert_array_equal(np_(tops.op_vars(ops, tm)),
                                  np.asarray(jops.op_vars(g.sse.ops, g.model)))
    np.testing.assert_array_equal(np_(tops.substate_index(ops.inputs)),
                                  np.asarray(jops.substate_index(g.sse.ops.inputs)))
    np.testing.assert_array_equal(np_(tops.op_weights(ops, tm)),
                                  np.asarray(jops.op_weights(g.sse.ops, g.model)))
    assert tops.op_count(ops).dtype == torch.int32
    grown_j = jops.grow(g.sse.ops, 80)
    grown_t = tops.grow(ops, 80)
    for name in ("bond", "inputs", "outputs"):
        np.testing.assert_array_equal(np_(getattr(grown_t, name)),
                                      np.asarray(getattr(grown_j, name)))
    empty_j = jops.empty_opstring(10, 3, 2)
    empty_t = tops.empty_opstring(10, 3, 2, device="cpu")
    for name in ("bond", "inputs", "outputs"):
        np.testing.assert_array_equal(np_(getattr(empty_t, name)),
                                      np.asarray(getattr(empty_j, name)))


def test_verify_agrees_with_jax(jax_state):
    g = jax_state
    tm = torch_model(g.model)
    bond = np.asarray(g.sse.ops.bond)
    inputs = np.asarray(g.sse.ops.inputs)
    outputs = np.asarray(g.sse.ops.outputs)
    state = np.asarray(g.sse.state)
    assert (bond >= 0).sum() > 20

    def both(bond, inputs, outputs, state):
        jo = jops.OpString(jnp.asarray(bond), jnp.asarray(inputs), jnp.asarray(outputs))
        want = np.asarray(jops.verify(jo, jnp.asarray(state), g.model))
        got = np_(tops.verify(torch_sse(jo, state).ops, torch.from_numpy(state.copy()), tm))
        np.testing.assert_array_equal(got, want)
        return got

    assert both(bond, inputs, outputs, state).all()
    # Corrupt one replica's string: flip the input of an occupied leg ...
    m, r = np.argwhere(bond >= 0)[3]
    bad_in = inputs.copy()
    bad_in[0, m, r] ^= True
    assert not both(bond, bad_in, outputs, state)[r]
    # ... or its output, or every p=0 spin of the replica.
    bad_out = outputs.copy()
    bad_out[0, m, r] ^= True
    assert not both(bond, inputs, bad_out, state)[r]
    bad_state = state.copy()
    bad_state[r, :] ^= True
    assert not both(bond, inputs, outputs, bad_state)[r]


@pytest.mark.parametrize("shape,seed", [((400,), 0), ((300, 6), 1)])
def test_effective_sample_size_matches_jax(shape, seed):
    rng = np.random.default_rng(seed)
    x = np.cumsum(rng.normal(size=shape), axis=0) * 0.05 + rng.normal(size=shape)
    for series in (x, torch.from_numpy(x)):
        np.testing.assert_allclose(tac.effective_sample_size(series),
                                   jac.effective_sample_size(x), rtol=1e-9)
        np.testing.assert_allclose(tac.integrated_autocorrelation_time(series),
                                   jac.integrated_autocorrelation_time(x), rtol=1e-9)


def test_port_imports_without_jax():
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import isingmontecarlo_tpu_torch as p\n"
        "from isingmontecarlo_tpu_torch import convert, lattice, ops\n"
        "from isingmontecarlo_tpu_torch.sse import cluster, diagonal, ising, model, opstring, tables\n"
        "from isingmontecarlo_tpu_torch.sse import loops, runner\n"
        "from isingmontecarlo_tpu_torch.analysis import autocorr, observables\n"
        "from isingmontecarlo_tpu_torch import checkpoint, parallel\n"
        "from isingmontecarlo_tpu_torch.parallel import tempering\n"
        "bad = [m for m in sys.modules if m.startswith(('jax', 'isingmontecarlo_tpu.'))"
        " or m == 'isingmontecarlo_tpu']\n"
        "assert not [m for m in bad if sys.modules[m] is not None], bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)
