"""SSE diagonal update, Metropolis and heat-bath (port of
``isingmontecarlo_tpu/sse/diagonal.py::_diagonal_update_fast``).

Reference semantics (``src/sse/qmc_traits/diagonal.rs:84-191``, Sandvik
PRB 59 14157 eqs. 19a/19b): sweep the slots ``p = 0..M`` carrying the
propagated state and the op count ``n``:

- identity slot: draw a bond ``b`` uniformly; insert a diagonal op with
  probability ``min(1, beta NB <s|H_b|s> / (M - n))``;
- diagonal op: remove with probability ``min(1, (M - n + 1) / (beta NB W))``;
- off-diagonal op: propagate the state through its outputs.

Heat-bath variant (``src/sse/qmc_traits/heatbath.rs:148-209``): insert with
probability ``bW_tot / (M - n + bW_tot)`` where ``bW_tot = beta * sum_b
max_w(b)``; pick the bond from the max-weight distribution (cumulative table
and a binary search) and accept ``u * max_w(b) < W``; remove any diagonal op
with probability ``(M - n + 1) / (M - n + 1 + bW_tot)``.

A diagonal sweep never changes worldline propagation, so every slot's
proposal and its matrix element are computed up front (the flip-parity scan,
kernel K2), and the only sequential piece left is the carry of ``n``
(kernel K3, or K3-hb for heat-bath). The uniforms ``u f32[3, M, R]`` are an
argument, drawn by the caller in the JAX package's shape: ``u[0]`` accepts,
``u[1]`` picks the proposal bond, ``u[2]`` is the heat-bath weight test.

Sign patterns (``bond_xor i32[R, NB]``, the signed tempering ladders): a
bond whose coupling sign is flipped has the base table with its substate
columns permuted by an XOR mask, ``w_flip(b, s) = w(b, s ^ m_b)``
(``isingmontecarlo_tpu/sse/diagonal.py:67-80``), so each replica looks its
weights up at ``s ^ bond_xor[r, b]``; the stored spins stay physical.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from isingmontecarlo_tpu_torch.ops.diag_carry import (
    carry_decisions, carry_decisions_heatbath,
)
from isingmontecarlo_tpu_torch.ops.parity_kernel import parity_bits
from isingmontecarlo_tpu_torch.sse.model import BondModel
from isingmontecarlo_tpu_torch.sse.opstring import OpString, op_count, substate_index
from isingmontecarlo_tpu_torch.sse.tables import (
    bond_fetch_multi, fetch_xor, searchsorted_left,
)


class HeatBathTables(NamedTuple):
    """Precomputed ``BondWeights`` (``heatbath.rs:10-61``): per model
    (``cum_max_w f32[NB]``, scalar ``total``) or per replica (``f32[R, NB]``
    and ``f32[R]``) when bond scales differ across the batch."""

    cum_max_w: torch.Tensor  # f32[NB] or f32[R, NB] inclusive cumulative maxima
    total: torch.Tensor  # f32[] or f32[R]


def make_heatbath_tables(model: BondModel,
                         bond_scale: torch.Tensor | None = None) -> HeatBathTables:
    """The heat-bath tables of ``model``, per replica when ``bond_scale
    f32[R, NB]`` is given. ``torch.cumsum`` may round non-integer weights
    differently from XLA's in the last ulps; integer weights agree exactly."""
    maxw = model.max_diag_w()
    if bond_scale is None:
        cum = torch.cumsum(maxw, dim=0)
        return HeatBathTables(cum_max_w=cum, total=cum[-1])
    cum = torch.cumsum(maxw[None, :] * bond_scale, dim=1)  # [R, NB]
    return HeatBathTables(cum_max_w=cum, total=cum[:, -1].contiguous())


def _parallel_weights(ops: OpString, state: torch.Tensor, u1: torch.Tensor,
                      model: BondModel, hb: HeatBathTables | None = None,
                      heatbath: bool = False, bond_xor: torch.Tensor | None = None):
    """Proposal bond ``b_new i32[M, R]``, its leg spins ``bits_new
    bool[K, M, R]`` and its weight ``w_new f32[M, R]`` for every slot, and
    the current op's weight ``w_cur f32[M, R]`` (under the replica's sign
    pattern, when ``bond_xor`` is given).

    The proposal is uniform over bonds (Metropolis) or drawn from the
    max-weight distribution (heat-bath), from the same ``u1`` either way.
    The spin of variable ``v`` just below slot ``p`` is ``state[v]`` XOR the
    parity of the off-diagonal flips on ``v`` before ``p`` (K2). Identity
    slots fetch bond 0's variables with all-false toggles; padded legs carry
    the sentinel ``N``, so they toggle nothing and read 0."""
    N = model.nvars
    NB = model.nbonds
    if heatbath:
        total = hb.total[None, :] if hb.cum_max_w.dim() == 2 else hb.total
        b_new = searchsorted_left(hb.cum_max_w, u1 * total).clamp(max=NB - 1)
    else:
        b_new = (u1 * NB).to(torch.int32).clamp(max=NB - 1)
    b_safe = ops.bond.clamp(min=0)
    bv_nn = torch.where(model.bond_vars >= 0, model.bond_vars, N).unbind(1)
    v_idx = torch.stack(bond_fetch_multi(bv_nn, b_safe))  # [K, M, R]
    vq = torch.stack(bond_fetch_multi(bv_nn, b_new))
    tog = ops.inputs != ops.outputs
    pb, sb = parity_bits(state.contiguous(), v_idx, tog, vq)
    bits_new = sb ^ pb  # sentinel legs are 0 by construction
    si_new = substate_index(bits_new)
    si_cur = substate_index(ops.inputs)
    if bond_xor is not None:
        x_new, x_cur = fetch_xor(bond_xor, b_new, b_safe)
        si_new, si_cur = si_new ^ x_new, si_cur ^ x_cur
    w_new = model.diag_w[b_new.long(), si_new.long()]
    w_cur = model.diag_w[b_safe.long(), si_cur.long()]
    return b_new, bits_new, w_new, w_cur


def diagonal_update(ops: OpString, state: torch.Tensor, beta,
                    u: torch.Tensor, model: BondModel,
                    hb: HeatBathTables | None = None, heatbath: bool = False,
                    bond_scale: torch.Tensor | None = None,
                    bond_xor: torch.Tensor | None = None) -> OpString:
    """One diagonal sweep with uniforms ``u f32[3, M, R]``: Metropolis, or
    heat-bath with the tables ``hb`` when ``heatbath``.

    ``state bool[R, N]`` is the p=0 state, ``beta`` a float or ``f32[R]``;
    ``bond_scale f32[R, NB]`` multiplies every bond's matrix elements per
    replica (heat-bath then needs per-replica tables), and ``bond_xor
    i32[R, NB]`` sets each replica's sign pattern. Bit-identical to
    ``_diagonal_update_fast`` given the same uniforms and tables: the same
    f32 expressions in the same order (``num = (beta * NB) * w``)."""
    if heatbath:
        if hb is None:
            raise ValueError("heat-bath needs its tables (make_heatbath_tables)")
        if bond_scale is not None and hb.cum_max_w.dim() != 2:
            raise ValueError("per-replica bond scales with heat-bath need per-replica "
                             "tables (make_heatbath_tables(model, bond_scale))")
    M, R = ops.bond.shape
    NB = model.nbonds
    beta = torch.as_tensor(beta, dtype=torch.float32, device=u.device)
    beta = beta.expand(R) if beta.dim() == 0 else beta

    n0 = op_count(ops)
    b_new, bits_new, w_new, w_cur = _parallel_weights(ops, state, u[1], model, hb,
                                                      heatbath, bond_xor)

    is_ident = ops.bond < 0
    is_diag = (ops.inputs == ops.outputs).all(dim=0) & ~is_ident
    b_safe = ops.bond.clamp(min=0)
    if bond_scale is not None:
        rows = torch.arange(R, device=u.device)[None, :]
        scale_new = bond_scale[rows, b_new.long()]
        w_new = w_new * scale_new
        w_cur = w_cur * bond_scale[rows, b_safe.long()]
    if heatbath:
        maxw = model.max_diag_w()[b_new.long()]
        if bond_scale is not None:
            maxw = maxw * scale_new
        bw_tot = (beta * hb.total).expand(R).contiguous()
        insert, remove = carry_decisions_heatbath(
            n0, u[0].contiguous(), is_ident, is_diag, u[2] * maxw < w_new, bw_tot
        )
    else:
        num_ins = beta[None, :] * NB * w_new
        num_rem = beta[None, :] * NB * w_cur
        insert, remove = carry_decisions(
            n0, u[0].contiguous(), is_ident, is_diag, num_ins, num_rem
        )

    new_bond = torch.where(insert, b_new, torch.where(remove, -1, ops.bond))
    keep_in = torch.where(insert[None], bits_new, ops.inputs)
    keep_in = keep_in & ~remove[None]
    changed = (new_bond != ops.bond)[None]
    return OpString(
        bond=new_bond,
        inputs=torch.where(changed, keep_in, ops.inputs),
        outputs=torch.where(changed, keep_in, ops.outputs),
    )
