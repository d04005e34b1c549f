"""Shared helpers of the ``test_torch_*`` files: move JAX models and states
into the PyTorch port through numpy, and reproduce the JAX sweep's random
draws from its key so both packages run the same chain."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from isingmontecarlo_tpu.sse.ising import QmcIsingGraph, multi_sweep
from isingmontecarlo_tpu_torch import convert

MODEL_LEAVES = ("bond_vars", "is_constant", "diag_w", "full_w", "cls", "wtab",
                "cls_full", "wtab_full")


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


class JaxSweepDraws:
    """One JAX timestep's draws (``ising.py:146``, ``diagonal.py:558``,
    ``cluster.py:654, 720``, ``ising.py:87``) as port tensors."""

    def __init__(self, k_diag, k_clust, k_free):
        self.k_diag, self.k_clust, self.k_free = k_diag, k_clust, k_free
        self.cluster_shapes = []

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
    pass ``.next`` as ``multi_sweep``'s ``next_draws``."""

    def __init__(self, key):
        self.key = key

    def next(self) -> JaxSweepDraws:
        self.key, k_diag, _k_rvb, k_clust, k_free = jax.random.split(self.key, 5)
        return JaxSweepDraws(k_diag, k_clust, k_free)
