"""Operator-string storage (port of ``isingmontecarlo_tpu/sse/opstring.py``).

The op string is a fixed-capacity struct of arrays, with imaginary time
``M`` second to last and replicas ``R`` last, as in the JAX package:

- ``bond: i32[M, R]`` — bond id per slot, ``-1`` = identity.
- ``inputs/outputs: bool[K, M, R]`` — per-leg spin states.

Per-variable adjacency is derived on demand by a stable sort of all legs
along imaginary time (see :func:`verify` and ``cluster.segment_graph``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from isingmontecarlo_tpu_torch.sse.model import BondModel
from isingmontecarlo_tpu_torch.sse.tables import bond_fetch_multi

# Sort key of legs that belong to no variable: above every real key.
SORT_BIG = 2**30


class OpString(NamedTuple):
    bond: torch.Tensor  # i32[M, R]
    inputs: torch.Tensor  # bool[K, M, R]
    outputs: torch.Tensor  # bool[K, M, R]

    @property
    def cutoff(self) -> int:
        """The imaginary-time capacity M (reference ``cutoff``)."""
        return self.bond.shape[0]

    @property
    def replicas(self) -> int:
        return self.bond.shape[1]

    @property
    def max_legs(self) -> int:
        return self.inputs.shape[0]


def empty_opstring(cutoff: int, replicas: int, max_legs: int = 2, *,
                   device: torch.device | str) -> OpString:
    return OpString(
        bond=torch.full((cutoff, replicas), -1, dtype=torch.int32, device=device),
        inputs=torch.zeros((max_legs, cutoff, replicas), dtype=torch.bool, device=device),
        outputs=torch.zeros((max_legs, cutoff, replicas), dtype=torch.bool, device=device),
    )


def grow(ops: OpString, new_cutoff: int) -> OpString:
    """Re-pad to a larger cutoff with identity slots (``qmc_ising.rs:786``)."""
    m = ops.cutoff
    if new_cutoff <= m:
        return ops
    pad = new_cutoff - m
    K, _, R = ops.inputs.shape
    dev = ops.bond.device
    legs = torch.zeros((K, pad, R), dtype=torch.bool, device=dev)
    return OpString(
        bond=torch.cat([ops.bond, torch.full((pad, R), -1, dtype=torch.int32, device=dev)]),
        inputs=torch.cat([ops.inputs, legs], dim=1),
        outputs=torch.cat([ops.outputs, legs], dim=1),
    )


def op_count(ops: OpString) -> torch.Tensor:
    """``n`` per replica, ``i32[R]`` (``OpContainer::get_n``)."""
    return (ops.bond >= 0).sum(dim=0, dtype=torch.int32)


def bond_counts(ops: OpString, nbonds: int) -> torch.Tensor:
    """Per-bond op counts ``i32[R, NB]`` (the reference's bond counters,
    ``fast_ops.rs:45, 360-365``)."""
    R = ops.replicas
    b = torch.where(ops.bond >= 0, ops.bond, nbonds).long()  # row NB is dropped
    ones = torch.ones_like(ops.bond)
    counts = torch.zeros((nbonds + 1, R), dtype=torch.int32, device=b.device)
    return counts.scatter_add_(0, b, ones)[:nbonds].T.contiguous()


def op_vars(ops: OpString, model: BondModel) -> torch.Tensor:
    """i32[K, M, R]: variable per leg, ``-1`` where the leg is invalid."""
    N = model.nvars
    b = ops.bond.clamp(min=0)
    bv_nn = torch.where(model.bond_vars >= 0, model.bond_vars, N)
    v = torch.stack(bond_fetch_multi(bv_nn.unbind(1), b))  # [K, M, R]
    return torch.where((ops.bond >= 0)[None] & (v < N), v, -1)


def substate_index(bits: torch.Tensor) -> torch.Tensor:
    """bool[K, ...] -> i32[...] with bit l = slot l."""
    k = bits.shape[0]
    w = (1 << torch.arange(k, dtype=torch.int32, device=bits.device)).reshape(
        (k,) + (1,) * (bits.dim() - 1)
    )
    return (bits.to(torch.int32) * w).sum(dim=0, dtype=torch.int32)


def op_weights(ops: OpString, model: BondModel) -> torch.Tensor:
    """f32[M, R]: matrix element of every op (1.0 for identities)."""
    b = ops.bond.clamp(min=0).long()
    si = substate_index(ops.inputs).long()
    so = substate_index(ops.outputs).long()
    w = model.full_w[b, si, so]
    return torch.where(ops.bond >= 0, w, torch.ones_like(w))


def sorted_legs(ops: OpString, model: BondModel):
    """All legs stably sorted by ``(variable, slot)`` along imaginary time.

    Flat leg index ``f = l*M + p``. Returns ``(skey, order, leg_var)``:
    ``skey i32[K*M, R]`` (``var*M + p``, or :data:`SORT_BIG` for invalid
    legs, which keep their flat order at the end), ``order i64[K*M, R]`` the
    flat index of each sorted leg, and ``leg_var i32[K*M, R]``."""
    M, R = ops.bond.shape
    KM = ops.max_legs * M
    leg_var = op_vars(ops, model).reshape(KM, R)
    p_of_f = (torch.arange(KM, dtype=torch.int32, device=leg_var.device) % M)[:, None]
    key = torch.where(leg_var >= 0, leg_var * M + p_of_f, SORT_BIG)
    skey, order = torch.sort(key, dim=0, stable=True)
    return skey, order, leg_var


def itime_fold(ops: OpString, state: torch.Tensor, model: BondModel, fold_fn, init):
    """``imaginary_time_fold`` (``qmc_stepper.rs:165-167``): fold
    ``fold_fn(acc, state_at_p)`` over the ``M`` propagated states
    ``bool[R, N]``, the state just below each slot, without holding the
    trajectory. A loop over ``M`` on the host; each state handed to
    ``fold_fn`` is a fresh tensor, never written again."""
    M, R = ops.bond.shape
    N = model.nvars
    vars_ = op_vars(ops, model)
    idx = torch.where(vars_ >= 0, vars_, N).permute(1, 2, 0).long()  # [M, R, K]
    outs = ops.outputs.permute(1, 2, 0)
    # Column N is a dump for padded legs and identity slots.
    prop = torch.cat([state, torch.zeros((R, 1), dtype=torch.bool, device=state.device)], 1)
    acc = init
    for p in range(M):
        acc = fold_fn(acc, prop[:, :N])
        prop = prop.scatter(1, idx[p], outs[p])
    return acc


def itime_states(ops: OpString, state: torch.Tensor, model: BondModel) -> torch.Tensor:
    """All propagated imaginary-time states ``bool[M, R, N]``; memory is
    O(M R N), for measurement at modest sizes (:func:`itime_fold` streams)."""
    states: list[torch.Tensor] = []
    itime_fold(ops, state, model, lambda acc, s: states.append(s), None)
    return torch.stack(states)


def verify(ops: OpString, state: torch.Tensor, model: BondModel) -> torch.Tensor:
    """Worldline integrity per replica, ``bool[R]`` (``OpContainer::verify``,
    ``op_container.rs:137-159``, plus the positive-weight check of
    ``qmc_ising.rs:829-861``).

    Same verdict as propagating ``state`` through the string slot by slot
    (the JAX package's scan): along each variable's worldline every op's
    input must equal the previous op's output (the p=0 state for the first
    op), and the last op's output must equal the p=0 state (periodic). Here
    the worldlines come from one sort of the legs, so there is no loop over
    ``M``. Assumes no bond names a variable twice, as every model does."""
    M, R = ops.bond.shape
    KM = ops.max_legs * M
    N = model.nvars
    skey, order, _ = sorted_legs(ops, model)
    valid = skey < SORT_BIG
    svar = torch.where(valid, skey // M, N).long()
    in_s = torch.gather(ops.inputs.reshape(KM, R), 0, order)
    out_s = torch.gather(ops.outputs.reshape(KM, R), 0, order)
    same_prev = torch.zeros_like(valid)
    same_prev[1:] = svar[1:] == svar[:-1]
    prev_out = torch.zeros_like(out_s)
    prev_out[1:] = out_s[:-1]
    st_pad = torch.cat([state.T, torch.zeros((1, R), dtype=torch.bool, device=state.device)])
    st_v = torch.gather(st_pad, 0, svar)  # p=0 spin of each sorted leg's var
    expect_in = torch.where(same_prev, prev_out, st_v)
    tail = valid.clone()
    tail[:-1] &= svar[:-1] != svar[1:]
    ok = (~valid | (in_s == expect_in)).all(dim=0)
    ok &= (~tail | (out_s == st_v)).all(dim=0)
    ok &= (op_weights(ops, model) > 0.0).all(dim=0)
    return ok
