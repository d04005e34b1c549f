"""Operator-string storage (port of ``isingmontecarlo_tpu/sse/opstring.py``).

The op string is a fixed-capacity struct of arrays, with imaginary time
``M`` second to last and replicas ``R`` last, as in the JAX package:

- ``bond: i32[M, R]`` — bond id per slot, ``-1`` = identity.
- ``inputs/outputs: bool[K, M, R]`` — per-leg spin states.

Per-variable adjacency is derived on demand by a stable sort of all legs
along imaginary time (see :func:`verify`, :func:`worldline_maps` and
``cluster.segment_graph``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from isingmontecarlo_tpu_torch.sse.model import BondModel
from isingmontecarlo_tpu_torch.sse.tables import bond_fetch_multi, fetch_xor

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


def new_from_ops(cutoff: int, ops, *, replicas: int | None = None, max_legs: int = 2,
                 device: torch.device | str = "cuda") -> OpString:
    """An op string from explicit ``(p, bond, inputs, outputs)`` tuples
    (``FastOpsTemplate::new_from_ops``, ``fast_ops.rs:80-173``): one
    iterable of tuples for a single replica, or with ``replicas`` one such
    iterable per replica. ``inputs``/``outputs`` are per-leg spins, at most
    ``max_legs`` of them."""
    per_rep = [list(ops)] if replicas is None else [list(x) for x in ops]
    if replicas is not None and len(per_rep) != replicas:
        raise ValueError(f"expected {replicas} per-replica op lists")
    R = len(per_rep)
    bond = np.full((cutoff, R), -1, np.int32)
    ins = np.zeros((max_legs, cutoff, R), bool)
    outs = np.zeros((max_legs, cutoff, R), bool)
    for r, lst in enumerate(per_rep):
        for p, b, i_bits, o_bits in lst:
            bond[p, r] = b
            for leg, v in enumerate(i_bits):
                ins[leg, p, r] = bool(v)
            for leg, v in enumerate(o_bits):
                outs[leg, p, r] = bool(v)
    t = torch.from_numpy
    return OpString(t(bond).to(device), t(ins).to(device), t(outs).to(device))


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


def leg_valid(ops: OpString, model: BondModel) -> torch.Tensor:
    """bool[K, M, R]: the leg slot holds a real variable."""
    return op_vars(ops, model) >= 0


def is_diagonal(ops: OpString) -> torch.Tensor:
    """bool[M, R]; identity slots count as diagonal (padded legs hold equal
    inputs and outputs by construction)."""
    return (ops.inputs == ops.outputs).all(dim=0)


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


def op_weights(ops: OpString, model: BondModel,
               bond_xor: torch.Tensor | None = None) -> torch.Tensor:
    """f32[M, R]: matrix element of every op (1.0 for identities).
    ``bond_xor i32[R, NB]`` applies per-replica sign-pattern labels as
    substate permutations (see ``diagonal.py``, "sign patterns")."""
    b = ops.bond.clamp(min=0)
    si = substate_index(ops.inputs)
    so = substate_index(ops.outputs)
    if bond_xor is not None:
        x = fetch_xor(bond_xor, b)
        si, so = si ^ x, so ^ x
    w = model.full_w[b.long(), si.long(), so.long()]
    return torch.where(ops.bond >= 0, w, torch.ones_like(w))


def log_relative_weight(ops: OpString, model_a: BondModel, model_b: BondModel):
    """The op-walking relative weight (``OpWeights``,
    ``tempering_traits.rs:163-196``): every op's matrix element under both
    models' tables, the log ratios summed. Returns ``(f32[R] log prod
    w_b/w_a, bool[R] is_zero)``; ``is_zero`` marks replicas whose string
    has zero weight under ``model_b``, where the log means nothing."""
    wa = op_weights(ops, model_a)
    wb = op_weights(ops, model_b)
    is_zero = ((wb <= 0.0) & (ops.bond >= 0)).any(dim=0)
    logw = (torch.log(wb.clamp(min=1e-30)) - torch.log(wa.clamp(min=1e-30))).sum(dim=0)
    return logw, is_zero


def log_weight_delta(ops: OpString, model: BondModel, scale_a: torch.Tensor,
                     xor_a: torch.Tensor, scale_b: torch.Tensor, xor_b: torch.Tensor):
    """Per replica ``log W(string | label b) - log W(string | label a)``,
    a label being per-bond multipliers ``f32[R, NB]`` and sign-pattern
    masks ``i32[R, NB]`` relative to ``model``: :func:`log_relative_weight`
    in label space, one ``[M, R]`` pass. Returns ``(delta f32[R], blocked
    bool[R])``; ``blocked`` marks strings of zero weight under label b."""
    b = ops.bond.clamp(min=0)
    bl = b.long()
    occupied = ops.bond >= 0
    si = substate_index(ops.inputs)
    so = substate_index(ops.outputs)
    xa, xb = fetch_xor(xor_a, b), fetch_xor(xor_b, b)
    wa = model.full_w[bl, (si ^ xa).long(), (so ^ xa).long()]
    wb = model.full_w[bl, (si ^ xb).long(), (so ^ xb).long()]
    blocked = (occupied & (wb <= 0.0)).any(dim=0)
    dlog_tab = torch.where(
        occupied, torch.log(wb.clamp(min=1e-30)) - torch.log(wa.clamp(min=1e-30)), 0.0)
    dlog_c = torch.log(scale_b.clamp(min=1e-30)) - torch.log(scale_a.clamp(min=1e-30))
    rows = torch.arange(ops.replicas, device=b.device)[None, :]
    dlog_scale = torch.where(occupied, dlog_c[rows, bl], 0.0)
    return (dlog_tab + dlog_scale).sum(dim=0), blocked


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


def worldline_maps(ops: OpString, model: BondModel):
    """Flat-leg successor and predecessor maps along each variable's
    worldline, periodic in imaginary time (the reference's per-variable
    doubly linked lists, ``fast_ops.rs:176-207``), from one sort of all
    legs (:func:`sorted_legs`).

    Flat leg index ``f = l*M + p``. Returns ``(wnext, wprev, leg_var,
    (order, svar, seg_start))``: ``wnext/wprev/leg_var i32[K*M, R]``
    (invalid legs map to themselves); ``order i32[K*M, R]`` the flat index
    of each sorted leg, ``svar i32[K*M, R]`` its variable (``-1`` for
    invalid legs) and ``seg_start bool[K*M, R]`` the first row of each
    variable's run. The sort is stable with invalid legs keyed last, the
    same permutation as the JAX package's unique keys (invalid legs
    tie-broken by flat index). The wrap targets of a run's tail and head
    are the flat indices of its first and last legs: a ``cummax`` of
    flagged row numbers, then a gather; the back-permute to flat leg space
    is a scatter by ``order``."""
    M, R = ops.bond.shape
    KM = ops.max_legs * M
    dev = ops.bond.device
    skey, order, leg_var = sorted_legs(ops, model)
    svar = torch.where(skey < SORT_BIG, skey // M, -1)
    same = svar[1:] == svar[:-1]  # row j+1 continues row j's run
    seg_start = torch.ones_like(skey, dtype=torch.bool)
    seg_start[1:] = ~same
    seg_end = torch.ones_like(seg_start)
    seg_end[:-1] = ~same
    # The scans run along the innermost axis of the transpose: PyTorch's
    # CUDA scan along the outer axis takes a thread a column (5 ms each at
    # the 32x32 shape [14016, 256]).
    row = torch.arange(KM, device=dev)
    head_row = torch.where(seg_start.T, row, 0).cummax(dim=1).values.T
    # The tail of each run, broadcast upward: a running minimum from the end.
    tail_row = torch.where(seg_end.T, row, KM - 1).flip(1).cummin(dim=1).values.flip(1).T
    tgt_next = torch.gather(order, 0, head_row)  # wraps to the run's first leg
    tgt_prev = torch.gather(order, 0, tail_row)  # wraps to the run's last leg
    tgt_next[:-1] = torch.where(same, order[1:], tgt_next[:-1])
    tgt_prev[1:] = torch.where(same, order[:-1], tgt_prev[1:])
    # Sorted row j belongs at flat row order[j].
    wnext = torch.empty_like(order).scatter_(0, order, tgt_next)
    wprev = torch.empty_like(order).scatter_(0, order, tgt_prev)
    self_f = row[:, None].expand(KM, R)
    valid = leg_var >= 0
    wnext = torch.where(valid, wnext, self_f).to(torch.int32)
    wprev = torch.where(valid, wprev, self_f).to(torch.int32)
    return wnext, wprev, leg_var, (order.to(torch.int32), svar, seg_start)


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


def verify(ops: OpString, state: torch.Tensor, model: BondModel,
           bond_xor: torch.Tensor | None = None) -> torch.Tensor:
    """Worldline integrity per replica, ``bool[R]`` (``OpContainer::verify``,
    ``op_container.rs:137-159``, plus the positive-weight check of
    ``qmc_ising.rs:829-861``, each replica's ops weighed under its own
    sign pattern ``bond_xor i32[R, NB]`` when given).

    Same verdict as propagating ``state`` through the string slot by slot
    (the JAX package's scan): every leg's input must equal its variable's
    value just below the slot, then the slot's outputs overwrite it, the
    last leg's last where a bond names the variable twice; the value above
    the last slot must equal the p=0 state (periodic). Here the worldlines
    come from one sort of the legs, so there is no loop over ``M``: the
    legs of one (variable, slot) group sit together in leg order, and each
    reads the output of the row just before its group (when that row holds
    the same variable) or the p=0 state."""
    M, R = ops.bond.shape
    KM = ops.max_legs * M
    N = model.nvars
    skey, order, _ = sorted_legs(ops, model)
    valid = skey < SORT_BIG
    svar = torch.where(valid, skey // M, N).long()
    in_s = torch.gather(ops.inputs.reshape(KM, R), 0, order)
    out_s = torch.gather(ops.outputs.reshape(KM, R), 0, order)
    group_start = torch.ones_like(valid)
    group_start[1:] = skey[1:] != skey[:-1]
    # The first row of each row's group, by a running maximum along the
    # transpose's innermost axis (see worldline_maps); the row before it.
    row = torch.arange(KM, device=skey.device)
    head = torch.where(group_start.T, row, 0).cummax(dim=1).values.T
    before = (head - 1).clamp(min=0)
    carried = (head > 0) & (torch.gather(svar, 0, before) == svar)
    st_pad = torch.cat([state.T, torch.zeros((1, R), dtype=torch.bool, device=state.device)])
    st_v = torch.gather(st_pad, 0, svar)  # p=0 spin of each sorted leg's var
    expect_in = torch.where(carried, torch.gather(out_s, 0, before), st_v)
    tail = valid.clone()
    tail[:-1] &= svar[:-1] != svar[1:]
    ok = (~valid | (in_s == expect_in)).all(dim=0)
    ok &= (~tail | (out_s == st_v)).all(dim=0)
    ok &= (op_weights(ops, model, bond_xor) > 0.0).all(dim=0)
    return ok
