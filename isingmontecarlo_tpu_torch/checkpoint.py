"""Checkpoint and resume (port of ``isingmontecarlo_tpu/checkpoint.py``; the
reference's ``serialize`` feature, with the RNG-less snapshots
``SerializeQmcGraph``, ``qmc_ising.rs:1000-1159``, and
``SerializeTemperingContainer``, ``tempering_container.rs:670-793``).

A file is the JAX package's ``.npz`` layout (its ``save_pytree``,
``isingmontecarlo_tpu/checkpoint.py:32-68``), so that either package loads
the other's files:

- ``leaf0`` .. ``leaf3``: the op string's ``bond``, ``inputs`` and
  ``outputs`` and the p=0 ``state``, in ``SseState``'s leaf order;
- ``key4``: the raw data of the JAX key, here that of ``key(0)`` (two zero
  ``uint32`` words), since the port draws from a ``torch.Generator``;
- ``leaf5``: the betas of a tempering container;
- ``meta_*``: the model description and bookkeeping.

The port adds keys that the JAX package does not read: the generator's
state (``meta_torch_rng``, with its device type, unless ``strip_rng``), and
what the host tracks and the chain depends on (the cluster label caps, the
growth phase, the heat-bath switch, the loop cap), so that a resumed chain
draws what the original would have drawn. ``load_*(seed=...)`` or a file
without a generator state (``strip_rng``, or one the JAX package wrote)
reseeds the generator.

:func:`save_pytree` and :func:`load_pytree` write and read any nested
tuple, list or dict of tensors in the same layout (JAX's leaf order: dicts
by sorted key). A sharded tempering container is gathered and written by
rank 0 in the same layout, with every rank's generator state
(``meta_torch_rng_ranks``) and the swap generator's
(``meta_torch_swap_rng``); loaded and sharded again over as many ranks, it
resumes the same chains.
"""

from __future__ import annotations

import numpy as np
import torch

# jax.random.key_data(jax.random.key(0)): the key a JAX loader finds.
_JAX_KEY0 = np.zeros(2, np.uint32)


def _leaves(tree) -> list:
    """The leaves of a nested tuple, list or dict (dicts by sorted key, as
    JAX's ``tree_leaves``; ``None`` holds no leaf)."""
    if tree is None:
        return []
    if isinstance(tree, (tuple, list)):
        return [leaf for sub in tree for leaf in _leaves(sub)]
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    return [tree]


def _rebuild(like, leaves: list):
    """``like``'s structure with its leaves taken in order from ``leaves``."""
    if like is None:
        return None
    if isinstance(like, (tuple, list)):
        parts = [_rebuild(sub, leaves) for sub in like]
        if isinstance(like, tuple) and hasattr(like, "_fields"):  # a NamedTuple
            return type(like)(*parts)
        return type(like)(parts)
    if isinstance(like, dict):
        return {k: _rebuild(like[k], leaves) for k in sorted(like)}
    return leaves.pop(0)


def save_pytree(path: str, tree, **metadata) -> None:
    """Write a nested tuple, list or dict of tensors (or arrays or numbers)
    as ``.npz``: leaves ``leaf{i}`` in :func:`_leaves` order, each
    ``metadata`` entry as ``meta_{name}`` (the JAX package's
    ``save_pytree``, ``isingmontecarlo_tpu/checkpoint.py:32-48``), so that
    either package loads the file."""
    payload = {f"leaf{i}": (leaf.detach().cpu().numpy() if isinstance(leaf, torch.Tensor)
                            else np.asarray(leaf))
               for i, leaf in enumerate(_leaves(tree))}
    payload.update({f"meta_{k}": np.asarray(v) for k, v in metadata.items()})
    np.savez(path, **payload)


def load_pytree(path: str, like, device: torch.device | str = "cuda"):
    """A tree saved by :func:`save_pytree` or by the JAX package's: ``like``
    gives the structure (its leaf values are ignored); the leaves come back
    as tensors on ``device``, a JAX key (``key{i}``) as its raw ``uint32``
    data. Returns ``(tree, metadata)``, the metadata as numpy arrays."""
    with np.load(path) as data:
        n = len(_leaves(like))
        leaves = [torch.from_numpy(np.array(data[f"key{i}"] if f"key{i}" in data.files
                                            else data[f"leaf{i}"])).to(device)
                  for i in range(n)]
        meta = {k[5:]: data[k] for k in data.files if k.startswith("meta_")}
    return _rebuild(like, leaves), meta


def _save(path: str, sse, *extra_leaves, **meta) -> None:
    ops = sse.ops
    payload = {f"leaf{i}": t.cpu().numpy()
               for i, t in enumerate((ops.bond, ops.inputs, ops.outputs, sse.state))}
    payload["key4"] = _JAX_KEY0
    for i, leaf in enumerate(extra_leaves, start=5):
        payload[f"leaf{i}"] = leaf.cpu().numpy()
    payload.update({f"meta_{k}": np.asarray(v) for k, v in meta.items()})
    np.savez(path, **payload)


def _load(path: str):
    """``(leaves, meta)`` of a file: the ``leaf{i}`` arrays by index and
    the ``meta_*`` entries by name."""
    with np.load(path) as data:
        leaves = {int(k[4:]): data[k] for k in data.files if k.startswith("leaf")}
        meta = {k[5:]: data[k] for k in data.files if k.startswith("meta_")}
    return leaves, meta


def _edges_meta(edges) -> dict:
    return {"edges_v": np.asarray([[a, b] for (a, b), _ in edges], np.int64).reshape(-1, 2),
            "edges_j": np.asarray([j for _, j in edges], np.float64)}


def _edges(meta) -> list:
    return [((int(a), int(b)), float(j)) for (a, b), j in zip(meta["edges_v"], meta["edges_j"])]


def _rng_meta(generator: torch.Generator, strip_rng: bool) -> dict:
    if strip_rng:
        return {}
    return {"torch_rng": generator.get_state().numpy(), "torch_rng_device": generator.device.type}


def _restore_rng(generator: torch.Generator, meta, seed: int | None) -> None:
    if seed is not None or bool(meta["strip_rng"]) or "torch_rng" not in meta:
        generator.manual_seed(seed or 0)
        return
    if str(meta["torch_rng_device"]) != generator.device.type:
        raise ValueError(f"the file's generator state is for a {meta['torch_rng_device']} "
                         f"generator, not {generator.device.type}: pass seed= to reseed")
    generator.set_state(torch.from_numpy(np.array(meta["torch_rng"], np.uint8)))


def _host_meta(obj) -> dict:
    """The host-tracked state a chain's next draws depend on."""
    caps = obj._cluster_caps
    return {"cluster_caps": np.asarray(caps if caps is not None else [], np.int64),
            "growth_pending": obj._growth_pending, "growth_stable": obj._growth_stable}


def _restore_host(obj, meta) -> None:
    if "cluster_caps" in meta:
        caps = meta["cluster_caps"]
        obj._cluster_caps = tuple(int(c) for c in caps) if caps.size else None
        obj._growth_pending = bool(meta["growth_pending"])
        obj._growth_stable = int(meta["growth_stable"])


def _sse(leaves, device):
    from isingmontecarlo_tpu_torch.convert import sse_state_from_numpy

    return sse_state_from_numpy(bond=leaves[0], inputs=leaves[1], outputs=leaves[2],
                                state=leaves[3], device=device)


# -- QmcIsingGraph (SerializeQmcGraph, qmc_ising.rs:1000-1159) ---------------


def save_qmc_ising(path: str, graph, *, strip_rng: bool = False) -> None:
    """Checkpoint a :class:`~isingmontecarlo_tpu_torch.sse.ising.QmcIsingGraph`
    with its Hamiltonian, so that :func:`load_qmc_ising` rebuilds the model."""
    _save(path, graph.sse, **_edges_meta(graph.edges), transverse=graph.transverse,
          longitudinal=graph.longitudinal, replicas=graph.replicas, strip_rng=strip_rng,
          **_rng_meta(graph.draws.generator, strip_rng), **_host_meta(graph),
          heatbath=graph._heatbath)


def load_qmc_ising(path: str, *, seed: int | None = None,
                   device: torch.device | str = "cuda"):
    """A ``QmcIsingGraph`` from :func:`save_qmc_ising`'s file or the JAX
    package's. ``seed`` reseeds the generator (``qmc_ising.rs:1050-1087``);
    without it the saved generator state continues, where there is one."""
    from isingmontecarlo_tpu_torch.sse.ising import QmcIsingGraph

    leaves, meta = _load(path)
    graph = QmcIsingGraph(_edges(meta), float(meta["transverse"]),
                          float(meta["longitudinal"]), cutoff=leaves[0].shape[0],
                          replicas=int(meta["replicas"]), device=device)
    graph.sse = _sse(leaves, graph.device)
    _restore_rng(graph.draws.generator, meta, seed)
    _restore_host(graph, meta)
    if "heatbath" in meta:
        graph.set_enable_heatbath(bool(meta["heatbath"]))
    return graph


# -- Qmc (qmc_runner.rs:25) ----------------------------------------------------


def save_qmc(path: str, qmc, *, strip_rng: bool = False) -> None:
    """Checkpoint a generic :class:`~isingmontecarlo_tpu_torch.sse.runner.Qmc`.
    The stored matrices are the shifted ones, so the accumulated offset is
    saved as it is, never derived again."""
    sse = qmc._ensure_sse()
    mats = [np.asarray(m, np.float64) for m, _ in qmc._interactions]
    vars_ = [v for _, v in qmc._interactions]
    _save(
        path, sse, nvars=qmc.nvars, replicas=qmc.replicas, offset=qmc.offset,
        do_loop_updates=qmc.do_loop_updates, do_heatbath=qmc._do_heatbath,
        int_diag=np.asarray([m.ndim == 1 for m in mats], bool),
        int_mat_sizes=np.asarray([m.size for m in mats], np.int64),
        int_mats=(np.concatenate([m.reshape(-1) for m in mats]) if mats
                  else np.zeros((0,), np.float64)),
        int_var_counts=np.asarray([len(v) for v in vars_], np.int64),
        int_vars=(np.concatenate([np.asarray(v, np.int64) for v in vars_]) if vars_
                  else np.zeros((0,), np.int64)),
        strip_rng=strip_rng, **_rng_meta(qmc.draws.generator, strip_rng), **_host_meta(qmc),
        loop_cap=-1 if qmc._loop_cap is None else qmc._loop_cap,
    )


def load_qmc(path: str, *, seed: int | None = None, device: torch.device | str = "cuda"):
    """A generic ``Qmc`` from :func:`save_qmc`'s file or the JAX package's."""
    from isingmontecarlo_tpu_torch.sse.runner import Qmc

    leaves, meta = _load(path)
    q = Qmc(int(meta["nvars"]), replicas=int(meta["replicas"]),
            do_loop_updates=bool(meta["do_loop_updates"]), device=device)
    mats, vars_flat = meta["int_mats"], meta["int_vars"]
    mo = vo = 0
    for diag, msize, vcount in zip(meta["int_diag"], meta["int_mat_sizes"],
                                   meta["int_var_counts"]):
        mat = mats[mo:mo + int(msize)]
        vars_ = [int(v) for v in vars_flat[vo:vo + int(vcount)]]
        mo += int(msize)
        vo += int(vcount)
        if bool(diag):
            q.make_diagonal_interaction(mat, vars_)
        else:
            n = 1 << len(vars_)
            q.make_interaction(mat.reshape(n, n), vars_)
    q.offset = float(meta["offset"])
    q._model = None  # the offset is part of the compiled tables
    if bool(meta["do_heatbath"]):
        q.set_do_heatbath(True)
    q._sse = _sse(leaves, q.device)
    _restore_rng(q.draws.generator, meta, seed)
    _restore_host(q, meta)
    if "loop_cap" in meta and int(meta["loop_cap"]) >= 0:
        q.set_loop_cap(int(meta["loop_cap"]))
    return q


# -- TemperingContainer (SerializeTemperingContainer) ---------------------------


def _sharded_rng_meta(container, strip_rng: bool) -> dict:
    """Every rank's sweep generator state and the swap generator's, for a
    sharded container (gathered: every rank calls it alike)."""
    from isingmontecarlo_tpu_torch.parallel import _dist

    if strip_rng:
        return {}
    gen = container.graph.draws.generator
    mine = gen.get_state().to(container.device)[None]
    states = _dist.all_gather(mine, container._shard.group, tag="checkpoint").cpu().numpy()
    swap = container._shard.draws.swap_draws.generator
    return {"torch_rng": states[0], "torch_rng_device": gen.device.type,
            "torch_rng_ranks": states, "torch_swap_rng": swap.get_state().numpy()}


def save_tempering(path: str, container, *, strip_rng: bool = False) -> None:
    """Checkpoint a :class:`~isingmontecarlo_tpu_torch.parallel.TemperingContainer`:
    states, per-replica labels and the swap bookkeeping. Every rank of a
    sharded container calls it: the blocks are gathered, rank 0 writes the
    file, and no rank returns before it is written."""
    container._finalize()
    g = container.graph
    sse, glob = g.sse, container._global
    if container._shard:
        ops = sse.ops
        sse = type(sse)(type(ops)(*(glob(t, t.dim() - 1, "checkpoint") for t in ops)),
                        glob(sse.state, 0, "checkpoint"))
        rng = _sharded_rng_meta(container, strip_rng)
    else:
        rng = _rng_meta(g.draws.generator, strip_rng)
    xors = (glob(container.xors, 0, "checkpoint").cpu().numpy() if container.xors is not None
            else np.zeros((0, 0), np.int32))  # an empty array means unsigned
    scales = glob(container.scales, 0, "checkpoint").cpu().numpy()
    betas = glob(container.betas, 0, "checkpoint")
    if container._shard is None or container._shard.rank == 0:
        _save(path, sse, betas, **_edges_meta(g.edges), transverse=g.transverse,
              longitudinal=g.longitudinal, replicas=container.replicas,
              parity=container._parity, total_swaps=container.total_swaps, scales=scales,
              xors=xors, strip_rng=strip_rng, **rng, **_host_meta(g),
              heatbath=container._heatbath)
    if container._shard:
        from isingmontecarlo_tpu_torch.parallel import _dist

        # A barrier: rank 0 has written the file when every rank returns.
        _dist.all_reduce_max(torch.zeros(1, dtype=torch.int32, device=container.device),
                             container._shard.group, tag="checkpoint")


def load_tempering(path: str, *, seed: int | None = None,
                   device: torch.device | str = "cuda"):
    """A ``TemperingContainer`` from :func:`save_tempering`'s file or the
    JAX package's. A file of a sharded container loads whole on every rank;
    :meth:`~isingmontecarlo_tpu_torch.parallel.TemperingContainer.shard_over`
    over as many ranks then restores each rank's generators. With ``seed``
    the container is seeded from it instead, and so are the ranks'
    generators when it is sharded."""
    from isingmontecarlo_tpu_torch.convert import tempering_from_numpy

    leaves, meta = _load(path)
    tc = tempering_from_numpy(
        _edges(meta), float(meta["transverse"]), float(meta["longitudinal"]),
        bond=leaves[0], inputs=leaves[1], outputs=leaves[2], state=leaves[3],
        betas=leaves[5], scales=meta.get("scales"), xors=meta.get("xors"),
        parity=int(meta["parity"]), total_swaps=int(meta["total_swaps"]),
        seed=0 if seed is None else seed, device=device,
    )
    _restore_rng(tc.graph.draws.generator, meta, seed)
    _restore_host(tc.graph, meta)
    if "heatbath" in meta:
        tc.set_enable_heatbath(bool(meta["heatbath"]))
    if seed is None and "torch_rng_ranks" in meta:
        tc._resume_rng = (torch.from_numpy(np.array(meta["torch_rng_ranks"], np.uint8)),
                          torch.from_numpy(np.array(meta["torch_swap_rng"], np.uint8)))
    return tc
