"""Directed-loop (off-diagonal) update (port of
``isingmontecarlo_tpu/sse/loops.py``; reference
``src/sse/qmc_traits/directed_loop.rs``).

Reference semantics: pick a random op, leg and direction; repeatedly choose
an exit leg with probability proportional to the matrix element of the op
with the entrance and exit legs toggled (``directed_loop.rs:111-143``),
toggle the op, hop along the worldline to the adjacent op (writing the p=0
state when the hop wraps the periodic boundary, ``directed_loop.rs:267-287``),
and stop when the walk returns to its first (op, leg, side)
(``directed_loop.rs:258-297``).

Every replica advances its own walker in lockstep. Ops do not move during a
loop update, only their leg bits toggle, so the worldline maps are derived
once per update (``opstring.worldline_maps``). The walk is plain PyTorch:
each hop is a few dozen small operations on ``[R]`` vectors, run in blocks
of hops with one host read per block (whether a walker is still open).

A walker's state is its entrance ``g = (side*K + leg)*M + p``; an op's leg
bits live in one integer per slot, ``b * 4^K + (si << K | so)``, so that
toggling a leg is an XOR with ``MASK[side*K + leg]`` and the exit weights of
an entrance are one row of a per-bond table of cumulative weights.

Deliberate deviation (the JAX package's too): walks are capped at
``4*K*M + 16`` hops; a replica whose loop has not closed by then is reverted
wholesale (op string and state) and counts as a rejected move. The reference
would walk forever on a loop that does not close.
"""

from __future__ import annotations

from typing import Protocol

import torch

from isingmontecarlo_tpu_torch.sse.model import BondModel
from isingmontecarlo_tpu_torch.sse.opstring import (
    OpString, op_count, substate_index, worldline_maps,
)

# Hops between two host reads of "is any walker still open".
HOP_BLOCK = 32


class LoopDraws(Protocol):
    """The random numbers of one loop update, in the JAX package's order
    (``loops.py:101-106, 130-137``)."""

    def start_index(self, hi: torch.Tensor) -> torch.Tensor:
        """Integers uniform in ``[0, hi)``, ``hi i32[R] >= 1``: which
        occupied slot starts the walk."""

    def start_leg(self, hi: torch.Tensor) -> torch.Tensor:
        """Integers uniform in ``[0, hi)``: the start leg (``hi`` the start
        op's arity, at least 1)."""

    def start_side(self, replicas: int) -> torch.Tensor:
        """Integers uniform in ``{0, 1}``: 0 enters on the inputs."""

    def exits(self, hop0: int, count: int, replicas: int) -> torch.Tensor:
        """Uniforms ``f32[count, R]`` of hops ``hop0 .. hop0 + count - 1``
        (one per hop; a hop after every walker closed uses none of it)."""


class GeneratorLoopDraws:
    """:class:`LoopDraws` from a ``torch.Generator``."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    def _below(self, hi: torch.Tensor) -> torch.Tensor:
        g = self.generator
        r = torch.randint(0, 2**62, hi.shape, generator=g, device=g.device)
        return r % hi

    def start_index(self, hi):
        return self._below(hi)

    def start_leg(self, hi):
        return self._below(hi)

    def start_side(self, replicas):
        g = self.generator
        return torch.randint(0, 2, (replicas,), generator=g, device=g.device)

    def exits(self, hop0, count, replicas):
        g = self.generator
        return torch.rand((count, replicas), generator=g, device=g.device,
                          dtype=torch.float32)


def toggle_masks(K: int, device) -> torch.Tensor:
    """``i64[2K]``: the bit of leg ``e % K`` on side ``e // K`` (0 = inputs)
    in a slot's ``si << K | so``."""
    return torch.tensor([1 << (l + K) for l in range(K)] + [1 << l for l in range(K)],
                        dtype=torch.int64, device=device)


def exit_table(model: BondModel, masks: torch.Tensor) -> torch.Tensor:
    """``f32[NB * 4^K, 2K]``: row ``b * 4^K + (si << K | so)``, the bits of
    an op after its entrance leg toggled, holds the running sums over the
    ``2K`` exits ``e`` (inputs legs first) of ``full_w[b]`` at those bits
    with exit ``e`` toggled, zero for legs past the bond's arity."""
    NB, K = model.nbonds, model.max_legs
    SS2 = 1 << (2 * K)
    dev = masks.device
    sio = torch.arange(SS2, device=dev)[:, None] ^ masks[None, :]  # [4^K, 2K]
    w = model.full_w.reshape(NB, SS2)[:, sio]  # [NB, 4^K, 2K]
    leg = torch.arange(2 * K, device=dev) % K
    w = torch.where(leg < model.arity()[:, None, None], w, 0.0)
    return torch.cumsum(w, dim=2).reshape(NB * SS2, 2 * K)


def loop_update(ops: OpString, state: torch.Tensor, draws: LoopDraws,
                model: BondModel, cap_hops: int | None = None,
                stats: dict | None = None):
    """One directed-loop update per replica. Returns ``(ops, state,
    reverted bool[R])``, ``reverted`` marking walks that hit the cap
    (``4*K*M + 16`` hops, or ``cap_hops``) and were undone.

    Given the same draws the result equals the JAX package's
    ``loop_update`` bit for bit, except where an exit uniform ties the
    running sum of the exit weights, whose last ulp may differ. A given
    ``stats`` dict receives ``hops i32[R]`` (each walker's hops) and
    ``host_reads`` (the blocks run)."""
    M, R = ops.bond.shape
    K = ops.max_legs
    KM = K * M
    N = model.nvars
    dev = ops.bond.device
    SS2 = 1 << (2 * K)
    rows = torch.arange(R, device=dev)
    masks = toggle_masks(K, dev)
    table = exit_table(model, masks)

    wnext, wprev, leg_var, _ = worldline_maps(ops, model)
    b_safe = ops.bond.clamp(min=0)
    ar = model.arity()[b_safe.long()]  # [M, R]
    # Replica-major tables, indexed by rows * width + column.
    si0 = substate_index(ops.inputs)
    so0 = substate_index(ops.outputs)
    bits = (b_safe.long() * SS2 + (si0.long() << K) + so0.long()).T.contiguous()  # [R, M]
    # The exit g = e*M + p = s*KM + f hops to the entrance (1 - s)*KM + f'
    # with f' = wnext[f] (s = 1, up) or wprev[f] (s = 0, down); a hop that
    # wraps the boundary writes the exit leg's new bit into the p=0 state
    # (dump column N otherwise).
    f = torch.arange(KM, device=dev)[:, None]
    nxt = torch.cat([KM + wprev.long(), wnext.long()]).T.contiguous()  # [R, 2KM]
    p_f = f % M
    wrap_up = (wnext.long() % M) <= p_f
    wrap_dn = (wprev.long() % M) >= p_f
    var = torch.where(leg_var >= 0, leg_var.long(), N)
    wvar = torch.cat([torch.where(wrap_dn, var, N), torch.where(wrap_up, var, N)]).T.contiguous()

    # The start: the target-th occupied slot, a leg below its arity, a side.
    n = op_count(ops)
    target = draws.start_index(n.clamp(min=1))
    # Along the innermost axis of the transpose, in int32 (see worldline_maps).
    cum = torch.cumsum((ops.bond >= 0).T.to(torch.int32), dim=1, dtype=torch.int32)
    p0 = torch.where(n > 0, (cum <= target[:, None]).sum(dim=1), 0)
    l0 = draws.start_leg(ar[p0, rows].clamp(min=1))
    s0 = draws.start_side(R)
    g0 = (s0.long() * K + l0.long()) * M + p0
    live = n > 0
    g = g0.clone()
    hops = torch.zeros(R, dtype=torch.int32, device=dev)

    state_pad = torch.cat([state, torch.zeros((R, 1), dtype=torch.bool, device=dev)], 1)
    flat_bits = bits.view(-1)
    flat_nxt, flat_wvar, flat_state = nxt.view(-1), wvar.view(-1), state_pad.view(-1)
    row_m, row_2km, row_n = rows * M, rows * (2 * KM), rows * (N + 1)
    last = 2 * K - 1

    cap = 4 * KM + 16 if cap_hops is None else cap_hops
    h = blocks = 0
    while h < cap:
        count = min(HOP_BLOCK, cap - h)
        u_block = draws.exits(h, count, R)
        for i in range(count):
            p = g % M
            ip = row_m + p
            cur = flat_bits[ip]
            ent = cur ^ masks[g // M]  # the entrance leg toggled
            cw = table[ent]  # [R, 2K] running exit weights
            u = u_block[i] * cw[:, last]
            ex = torch.searchsorted(cw, u[:, None], right=True)[:, 0].clamp_(max=last)
            ex_mask = masks[ex]
            new = ent ^ ex_mask
            flat_bits.scatter_(0, ip, torch.where(live, new, cur))
            g_exit = ex * M + p
            closed_a = g_exit == g0  # left through the first entrance
            ix = row_2km + g_exit
            g_next = flat_nxt[ix]
            keep = live & ~closed_a
            col = torch.where(keep, flat_wvar[ix], N)
            flat_state.scatter_(0, row_n + col, (new & ex_mask) != 0)
            if stats is not None:
                hops += live
            live = keep & (g_next != g0)  # or arrives at it
            g = torch.where(live, g_next, g)
        h += count
        blocks += 1
        if not bool(live.any()):
            break

    # A walker still open at the cap is reverted with its state.
    reverted = live
    sio = (bits & (SS2 - 1)).T
    leg = torch.arange(K, device=dev).reshape(K, 1, 1)
    ch_in = ((sio >> K)[None] >> leg) & 1
    ch_out = (sio[None] >> leg) & 1
    new_inputs = torch.where(reverted[None, None, :], ops.inputs, ch_in.bool())
    new_outputs = torch.where(reverted[None, None, :], ops.outputs, ch_out.bool())
    new_state = torch.where(reverted[:, None], state, state_pad[:, :N])
    if stats is not None:
        stats["hops"] = hops
        stats["host_reads"] = blocks
    return OpString(ops.bond, new_inputs, new_outputs), new_state, reverted
