"""Carry the JAX package's models, tables, states and tempering labels
across as numpy arrays, so both packages compute from the same inputs. The
JAX PRNG key is not carried."""

from __future__ import annotations

import numpy as np
import torch

from isingmontecarlo_tpu_torch.classical.metropolis import tables_from_numpy
from isingmontecarlo_tpu_torch.sse.diagonal import HeatBathTables
from isingmontecarlo_tpu_torch.sse.ising import SseState
from isingmontecarlo_tpu_torch.sse.model import BondModel
from isingmontecarlo_tpu_torch.sse.opstring import OpString
from isingmontecarlo_tpu_torch.sse.runner import Qmc
from isingmontecarlo_tpu_torch.sse.rvb import RvbTables


def _t(a, dtype: torch.dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a)).to(device=device, dtype=dtype).contiguous()


def model_from_numpy(*, bond_vars, is_constant, diag_w, full_w, cls, wtab,
                     cls_full, wtab_full, offset: float, nvars: int,
                     device: torch.device | str) -> BondModel:
    """A :class:`BondModel` from the JAX ``BondModel``'s leaves (numpy
    arrays named as its attributes) and its ``offset`` and ``nvars``."""
    i32, f32 = torch.int32, torch.float32
    return BondModel(
        _t(bond_vars, i32, device), _t(is_constant, torch.bool, device),
        _t(diag_w, f32, device), _t(full_w, f32, device),
        _t(cls, i32, device), _t(wtab, f32, device),
        _t(cls_full, i32, device), _t(wtab_full, f32, device),
        offset=offset, nvars=nvars,
    )


def sse_state_from_numpy(*, bond, inputs, outputs, state,
                         device: torch.device | str) -> SseState:
    """An :class:`SseState` from ``bond i32[M, R]``, ``inputs/outputs
    bool[K, M, R]`` and ``state bool[R, N]``."""
    return SseState(
        ops=OpString(
            bond=_t(bond, torch.int32, device),
            inputs=_t(inputs, torch.bool, device),
            outputs=_t(outputs, torch.bool, device),
        ),
        state=_t(state, torch.bool, device),
    )


def heatbath_tables_from_numpy(cum_max_w, total,
                               device: torch.device | str) -> HeatBathTables:
    """:class:`HeatBathTables` from the JAX tables' ``cum_max_w`` (``[NB]``
    or ``[R, NB]``) and ``total``, so both packages search the same floats
    (``torch.cumsum`` may round non-integer weights otherwise)."""
    return HeatBathTables(cum_max_w=_t(cum_max_w, torch.float32, device),
                          total=_t(total, torch.float32, device))


def rvb_tables_from_numpy(neigh_bond, neigh_var, bond_mag, nedges: int,
                          device: torch.device | str) -> RvbTables:
    """:class:`RvbTables` from the JAX ``RvbTables``' arrays and
    ``nedges``."""
    return RvbTables(neigh_bond=_t(neigh_bond, torch.int32, device),
                     neigh_var=_t(neigh_var, torch.int32, device),
                     bond_mag=_t(bond_mag, torch.float32, device), nedges=int(nedges))


# The port's GraphTables from the JAX GraphTables' fields (numpy arrays and
# the two colour counts), colourings included, so both packages sweep the
# same colour classes.
graph_tables_from_numpy = tables_from_numpy


def qmc_from_numpy(nvars: int, interactions, offset: float, *, bond, inputs, outputs,
                   state, seed: int = 0, device: torch.device | str) -> Qmc:
    """A port :class:`Qmc` from a JAX ``Qmc``'s data: its stored
    interactions ``[(mat, vars), ...]`` (``_interactions``, post-offset), its
    ``offset``, and its op string's and state's arrays, so both packages
    step the same model from the same string. The random stream is the
    port's own, from ``seed``."""
    state = np.asarray(state)
    q = Qmc(nvars, replicas=state.shape[0], seed=seed, device=device)
    for mat, vars in interactions:
        q._append(np.asarray(mat, dtype=np.float64), list(vars))
    q.offset = float(offset)
    q._sse = sse_state_from_numpy(bond=bond, inputs=inputs, outputs=outputs, state=state,
                                  device=device)
    return q


def tempering_from_numpy(edges, transverse: float, longitudinal: float = 0.0, *, bond,
                         inputs, outputs, state, betas, scales=None, xors=None,
                         parity: int = 0, total_swaps: int = 0, seed: int = 0,
                         device: torch.device | str):
    """A port :class:`~isingmontecarlo_tpu_torch.parallel.TemperingContainer`
    from a JAX container's data: its model (``edges``, fields), the op
    string's and state's arrays, the labels ``betas f32[R]``, ``scales
    f32[R, NB]`` (ones when None) and ``xors i32[R, NB]`` (None or empty:
    unsigned), the swap ``parity`` and count. Both packages then compute the
    same chain on the same draws. The generator starts from ``seed``."""
    from isingmontecarlo_tpu_torch.parallel import TemperingContainer

    betas = np.asarray(betas, np.float32)
    tc = TemperingContainer(edges, transverse, longitudinal, betas=betas, seed=seed,
                            device=device)
    tc.graph.sse = sse_state_from_numpy(bond=bond, inputs=inputs, outputs=outputs,
                                        state=state, device=device)
    tc.graph.draws.generator.manual_seed(seed)
    if scales is not None:
        sc = np.asarray(scales, np.float32)
        tc.scales = _t(sc, torch.float32, device)
        tc.hetero = bool(np.max(np.abs(sc - 1.0)) > 1e-12)
    if xors is not None and np.size(xors):
        tc.xors = _t(xors, torch.int32, device)
    tc._parity = int(parity)
    tc.total_swaps = int(total_swaps)
    return tc
