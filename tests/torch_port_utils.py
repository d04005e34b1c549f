"""Shared helpers of the ``test_torch_*`` files: move JAX models, tables and
states into the PyTorch port through numpy, and reproduce the JAX sweeps'
random draws from their keys so both packages run the same chain."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isingmontecarlo_tpu.sse.ising import QmcIsingGraph, multi_sweep
from isingmontecarlo_tpu_torch import convert

MODEL_LEAVES = ("bond_vars", "is_constant", "diag_w", "full_w", "cls", "wtab",
                "cls_full", "wtab_full")


@pytest.fixture(autouse=True, scope="module")
def release_jax_executables():
    """Drop JAX's compiled executables before and after each ``test_torch_*``
    module that imports this fixture. XLA:CPU maps three memory regions for
    every kernel it compiles and keeps them while a jit cache holds the
    executable; a pytest-xdist worker that runs many modules otherwise
    reaches the kernel's limit on mappings a process (``vm.max_map_count``,
    65,530 by default) and dies in the next compile or cache load."""
    jax.clear_caches()
    yield
    jax.clear_caches()


def np_(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def t_(x) -> torch.Tensor:
    """A CPU tensor holding a copy of a JAX or numpy array."""
    return torch.from_numpy(np.array(x))


def torch_model(jm):
    """The port's BondModel from a JAX BondModel, on the CPU."""
    return convert.model_from_numpy(
        **{k: np.asarray(getattr(jm, k)) for k in MODEL_LEAVES},
        offset=jm.offset, nvars=jm.nvars, device="cpu",
    )


def torch_sse(ops, state):
    """The port's SseState from a JAX op string and state, on the CPU."""
    return convert.sse_state_from_numpy(
        bond=np.asarray(ops.bond), inputs=np.asarray(ops.inputs),
        outputs=np.asarray(ops.outputs), state=np.asarray(state), device="cpu",
    )


def jax_graph(edges, *, transverse=1.0, longitudinal=0.0, replicas=8, seed=3,
              beta=1.0, nsweeps=6, cutoff=None):
    """A JAX QmcIsingGraph after ``nsweeps`` timesteps and a cutoff refresh."""
    g = QmcIsingGraph(edges, transverse=transverse, longitudinal=longitudinal,
                      cutoff=cutoff, replicas=replicas, seed=seed)
    g.sse, _, _, _ = multi_sweep(g.sse, jnp.float32(beta), g.model, nsweeps)
    g._maybe_grow()
    return g


def assert_ops_equal(a, b) -> None:
    for name in ("bond", "inputs", "outputs"):
        np.testing.assert_array_equal(np_(getattr(a, name)), np_(getattr(b, name)),
                                      err_msg=name)


class JaxRvbDraws:
    """``rvb_sweep``'s draws replayed from its key as port tensors: one key
    per update (``rvb.py:1534``), split into build, accept and mutation
    keys (``:1344``); the build key into seed, size and pop keys
    (``:260``), the pop key split once per pop (``:298``); the mutation
    key's Gumbels one-shot (``:1153``) or folded in per chunk (``:1262``)."""

    def __init__(self, key, n_updates: int):
        self.n = n_updates
        ks = jax.random.split(key, n_updates)
        self.k_build, self.k_acc, self.k_mut = zip(*(jax.random.split(k, 3) for k in ks))
        self.k_seed, self.k_size, k_pops = zip(*(jax.random.split(k, 3) for k in self.k_build))
        self.k_pop = []  # [u][i]
        for k in k_pops:
            chain = []
            for _ in range(16):
                k, k_g = jax.random.split(k)
                chain.append(k_g)
            self.k_pop.append(chain)

    def _rows(self, u0, shape, draw):
        return t_(np.stack([np.asarray(draw(u)) for u in range(u0, u0 + shape[0])]))

    def seed(self, u0, shape):
        return self._rows(u0, shape, lambda u: jax.random.uniform(self.k_seed[u], shape[1:]))

    def size(self, u0, shape):
        return self._rows(u0, shape, lambda u: jax.random.uniform(
            self.k_size[u], shape[1:], minval=1e-9, maxval=1.0))

    def pop(self, u0, i, shape):
        return self._rows(u0, shape, lambda u: jax.random.gumbel(self.k_pop[u][i], shape[1:]))

    def accept(self, u0, shape):
        return self._rows(u0, shape, lambda u: jax.random.uniform(self.k_acc[u], shape[1:]))

    def rotation(self, u, chunk, shape):
        k = self.k_mut[u] if chunk is None else jax.random.fold_in(self.k_mut[u], chunk)
        return t_(jax.random.gumbel(k, shape))


class JaxLoopDraws:
    """``loops.loop_update``'s draws replayed from its key as port tensors:
    ``split(key, 4)`` into the start index, leg and side keys and the walk
    key (``loops.py:101``), then one ``split`` of the walk key per hop, whose
    second half draws the hop's exit uniform (``loops.py:130, 137``).
    ``scale`` multiplies every exit uniform (a test's perturbation)."""

    def __init__(self, key, scale: float = 1.0):
        self.k_n, self.k_leg, self.k_side, self.k_walk = jax.random.split(key, 4)
        self.exit_keys = []
        self.scale = scale

    def start_index(self, hi):
        return t_(jax.random.randint(self.k_n, hi.shape, 0, jnp.asarray(np_(hi))))

    def start_leg(self, hi):
        return t_(jax.random.randint(self.k_leg, hi.shape, 0, jnp.asarray(np_(hi))))

    def start_side(self, replicas):
        return t_(jax.random.randint(self.k_side, (replicas,), 0, 2))

    def exits(self, hop0, count, replicas):
        while len(self.exit_keys) < hop0 + count:
            self.k_walk, k_exit = jax.random.split(self.k_walk)
            self.exit_keys.append(k_exit)
        keys = jnp.stack(self.exit_keys[hop0:hop0 + count])
        u = jax.vmap(lambda k: jax.random.uniform(k, (replicas,)))(keys)
        return t_(u) * self.scale


class JaxSweepDraws:
    """One JAX timestep's draws (``ising.py:146``, ``diagonal.py:558``,
    ``rvb.py:1534``, ``cluster.py:654, 720``, ``ising.py:87``; the generic
    timestep's ``runner.py:54``) as port tensors."""

    def __init__(self, k_diag, k_clust, k_free, k_rvb=None, k_loops=None, k_swap=None):
        self.k_diag, self.k_clust, self.k_free = k_diag, k_clust, k_free
        self.k_rvb, self.k_loops, self.k_swap = k_rvb, k_loops, k_swap
        self.cluster_shapes = []

    def swap(self, shape):
        return t_(jax.random.uniform(self.k_swap, shape))

    def rvb(self, n_updates):
        return JaxRvbDraws(self.k_rvb, n_updates)

    def loops(self):
        return JaxLoopDraws(self.k_loops)

    def diagonal(self, shape):
        return t_(jax.random.uniform(self.k_diag, shape))

    def cluster(self, shape):
        self.cluster_shapes.append(tuple(shape))
        k_u = jax.random.fold_in(self.k_clust, 0)
        return t_(jax.random.uniform(k_u, shape))

    def free_spins(self, shape):
        return t_(jax.random.bernoulli(self.k_free, 0.5, shape))


class JaxKeyDraws:
    """Per-timestep draws split from a JAX key as ``_sweep_impl`` splits it;
    pass ``.next`` as ``multi_sweep``'s ``next_draws``. With
    ``tempering=True`` each timestep's key is split once more for the swap
    uniforms, ``k_next, k_swap = split(key)``, as
    ``tempering_sweep_chunk`` does (``parallel/tempering.py:389``)."""

    def __init__(self, key, tempering: bool = False):
        self.key = key
        self.tempering = tempering

    def next(self) -> JaxSweepDraws:
        self.key, k_diag, k_rvb, k_clust, k_free = jax.random.split(self.key, 5)
        k_swap = None
        if self.tempering:
            self.key, k_swap = jax.random.split(self.key)
        return JaxSweepDraws(k_diag, k_clust, k_free, k_rvb, k_swap=k_swap)


class JaxGenericKeyDraws:
    """Per-timestep draws split from a JAX key as ``generic_multi_sweep``
    splits it (``key, k_d, k_l, k_c, k_f = split(key, 5)``,
    ``runner.py:54``); pass ``.next`` as its ``next_draws``."""

    def __init__(self, key):
        self.key = key

    def next(self) -> JaxSweepDraws:
        self.key, k_d, k_l, k_c, k_f = jax.random.split(self.key, 5)
        return JaxSweepDraws(k_d, k_c, k_f, k_loops=k_l)


class JaxChainDraws:
    """A port graph's ``draws`` replaying a JAX graph's timesteps from its
    key: each ``diagonal`` call starts the next timestep's split."""

    def __init__(self, key):
        self.src = JaxKeyDraws(key)
        self.cur = None

    def diagonal(self, shape):
        self.cur = self.src.next()
        return self.cur.diagonal(shape)

    def cluster(self, shape):
        return self.cur.cluster(shape)

    def free_spins(self, shape):
        return self.cur.free_spins(shape)

    def rvb(self, n_updates):
        return self.cur.rvb(n_updates)


def port_chain_state(edges, *, transverse=1.0, longitudinal=0.0, replicas=8,
                     seed=3, beta=1.0, nsweeps=10):
    """Numpy ``(bond, inputs, outputs, state)`` after ``nsweeps`` timesteps
    of the port's own chain on the CPU: a string to feed both packages
    without compiling a JAX chain."""
    from isingmontecarlo_tpu_torch.sse import ising as tising

    g = tising.QmcIsingGraph(edges, transverse, longitudinal, replicas=replicas,
                             seed=seed, device="cpu")
    for _ in range(nsweeps):
        g.timestep(beta)
    ops = g.sse.ops
    return tuple(np_(a) for a in (ops.bond, ops.inputs, ops.outputs, g.sse.state))


def torch_rvb_tables(jt):
    """The port's RvbTables from a JAX RvbTables, on the CPU."""
    return convert.rvb_tables_from_numpy(
        np.asarray(jt.neigh_bond), np.asarray(jt.neigh_var), np.asarray(jt.bond_mag),
        jt.nedges, device="cpu")


def jax_opstring(bond, inputs, outputs):
    from isingmontecarlo_tpu.sse.opstring import OpString

    return OpString(jnp.asarray(bond), jnp.asarray(inputs), jnp.asarray(outputs))


# -- classical engine ---------------------------------------------------------

GRAPH_TABLE_FIELDS = ("neigh", "nj", "biases", "site_color", "n_site_colors",
                      "edges", "ej", "edge_color", "n_edge_colors")


def torch_tables(jt):
    """The port's GraphTables from a JAX GraphTables, on the CPU."""
    return convert.graph_tables_from_numpy(
        **{k: (getattr(jt, k) if k.startswith("n_") else np.asarray(getattr(jt, k)))
           for k in GRAPH_TABLE_FIELDS},
        device="cpu",
    )


def spin_flip_uniforms(key, n_colors, shape):
    """``u[n_colors, R, N]`` as ``metropolis._spin_flip_sweep`` draws them."""
    us = []
    for _ in range(n_colors):
        key, sub = jax.random.split(key)
        us.append(np.asarray(jax.random.uniform(sub, shape)))
    return t_(np.stack(us))


def edge_flip_uniforms(key, n_colors, R, E, importance: bool):
    """``(u[C, R, E], u_attempt[C, E] or None)`` as
    ``metropolis._edge_flip_sweep`` draws them."""
    us, ua = [], []
    for _ in range(n_colors):
        key, sub = jax.random.split(key)
        if importance:
            key, ka = jax.random.split(key)
            ua.append(np.asarray(jax.random.uniform(ka, (E,))))
        us.append(np.asarray(jax.random.uniform(sub, (R, E))))
    return t_(np.stack(us)), (t_(np.stack(ua)) if importance else None)


def checkerboard_uniforms(key, shape):
    """``u[2, R, L, L]`` as ``metropolis.checkerboard_sweep`` draws them."""
    return spin_flip_uniforms(key, 2, shape)


def swendsen_wang_draws(key, R, N, E):
    """``(u_bond, coin, u_acc)`` as ``cluster.swendsen_wang_sweep`` draws them."""
    k_bond, k_flip, k_acc = jax.random.split(key, 3)
    return (t_(jax.random.uniform(k_bond, (R, E))),
            t_(jax.random.bernoulli(k_flip, 0.5, (R, N))),
            t_(jax.random.uniform(k_acc, (R, N))))


def wolff_draws(key, R, N, E):
    """``(u_bond, seed_site)`` as ``cluster.wolff_sweep`` draws them."""
    k_bond, k_seed = jax.random.split(key)
    return (t_(jax.random.uniform(k_bond, (R, E))),
            t_(jax.random.randint(k_seed, (R,), 0, N)).long())


def decided_replicas(run, *us, rel=4 * 2.0 ** -23):
    """``bool[R]``: replicas whose result ``run(*us)`` does not change when
    every float draw moves by ``rel`` relative (about 4 ulp) either way.
    In those replicas no acceptance test sat within that margin of its
    threshold, so a one-ulp difference of ``exp`` between XLA and PyTorch
    cannot change the outcome; the rest are excluded from exact
    comparisons. Also returns ``run(*us)``."""
    def moved(f):
        return [u * f if torch.is_floating_point(u) else u for u in us]

    base = run(*us)
    lo, hi = run(*moved(1 - rel)), run(*moved(1 + rel))
    dims = tuple(range(1, base.dim()))
    same = (base == lo).all(dim=dims) & (base == hi).all(dim=dims)
    return same, base


def assert_equal_where_decided(got, want, decided, max_excluded: int = 1):
    """``got == want`` in every decided replica; at most ``max_excluded``
    replicas undecided."""
    n_out = int((~decided).sum())
    assert n_out <= max_excluded, f"{n_out} replicas within 4 ulp of a threshold"
    np.testing.assert_array_equal(np_(got)[np_(decided)], np_(want)[np_(decided)])
