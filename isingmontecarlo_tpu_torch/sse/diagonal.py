"""SSE diagonal (Metropolis) update (port of
``isingmontecarlo_tpu/sse/diagonal.py::_diagonal_update_fast``).

Reference semantics (``src/sse/qmc_traits/diagonal.rs:84-191``, Sandvik
PRB 59 14157 eqs. 19a/19b): sweep the slots ``p = 0..M`` carrying the
propagated state and the op count ``n``:

- identity slot: draw a bond ``b`` uniformly; insert a diagonal op with
  probability ``min(1, beta NB <s|H_b|s> / (M - n))``;
- diagonal op: remove with probability ``min(1, (M - n + 1) / (beta NB W))``;
- off-diagonal op: propagate the state through its outputs.

A diagonal sweep never changes worldline propagation, so every slot's
proposal and its matrix element are computed up front (the flip-parity scan,
kernel K2), and the only sequential piece left is the carry of ``n``
(kernel K3). The uniforms ``u f32[3, M, R]`` are an argument, drawn by the
caller in the JAX package's shape: ``u[0]`` accepts, ``u[1]`` picks the
proposal bond (``u[2]`` is the heat-bath draw, unused here).
"""

from __future__ import annotations

import torch

from isingmontecarlo_tpu_torch.ops.diag_carry import carry_decisions
from isingmontecarlo_tpu_torch.ops.parity_kernel import parity_bits
from isingmontecarlo_tpu_torch.sse.model import BondModel
from isingmontecarlo_tpu_torch.sse.opstring import OpString, op_count, substate_index
from isingmontecarlo_tpu_torch.sse.tables import bond_fetch_multi


def _parallel_weights(ops: OpString, state: torch.Tensor, u1: torch.Tensor,
                      model: BondModel):
    """Proposal bond ``b_new i32[M, R]``, its leg spins ``bits_new
    bool[K, M, R]`` and its weight ``w_new f32[M, R]`` for every slot.

    The spin of variable ``v`` just below slot ``p`` is ``state[v]`` XOR the
    parity of the off-diagonal flips on ``v`` before ``p`` (K2). Identity
    slots fetch bond 0's variables with all-false toggles; padded legs carry
    the sentinel ``N``, so they toggle nothing and read 0."""
    N = model.nvars
    NB = model.nbonds
    b_new = (u1 * NB).to(torch.int32).clamp(max=NB - 1)
    b_safe = ops.bond.clamp(min=0)
    bv_nn = torch.where(model.bond_vars >= 0, model.bond_vars, N).unbind(1)
    v_idx = torch.stack(bond_fetch_multi(bv_nn, b_safe))  # [K, M, R]
    vq = torch.stack(bond_fetch_multi(bv_nn, b_new))
    tog = ops.inputs != ops.outputs
    pb, sb = parity_bits(state.contiguous(), v_idx, tog, vq)
    bits_new = sb ^ pb  # sentinel legs are 0 by construction
    w_new = model.diag_w[b_new.long(), substate_index(bits_new).long()]
    return b_new, bits_new, w_new


def diagonal_update(ops: OpString, state: torch.Tensor, beta,
                    u: torch.Tensor, model: BondModel) -> OpString:
    """One Metropolis diagonal sweep with uniforms ``u f32[3, M, R]``.

    ``state bool[R, N]`` is the p=0 state, ``beta`` a float or ``f32[R]``.
    Bit-identical to ``_diagonal_update_fast`` given the same uniforms: the
    same f32 expressions in the same order (``num = (beta * NB) * w``)."""
    M, R = ops.bond.shape
    NB = model.nbonds
    beta = torch.as_tensor(beta, dtype=torch.float32, device=u.device)
    beta = beta.expand(R) if beta.dim() == 0 else beta

    n0 = op_count(ops)
    b_new, bits_new, w_new = _parallel_weights(ops, state, u[1], model)

    is_ident = ops.bond < 0
    is_diag = (ops.inputs == ops.outputs).all(dim=0) & ~is_ident
    b_safe = ops.bond.clamp(min=0)
    w_cur = model.diag_w[b_safe.long(), substate_index(ops.inputs).long()]
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
