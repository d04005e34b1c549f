"""A plain reference of the SSE timestep with the heat-bath diagonal update
and the cluster update thinned to every ``k``-th timestep, in numpy and
plain torch. It imports nothing of the program; the lattice tables, the
spins below a slot, the clusters, the label space, the caps and the growth
are :mod:`benchmark.reference.sse`'s.

The heat-bath diagonal update (Renmusxd/IsingMonteCarlo
``src/sse/qmc_traits/heatbath.rs:149-209``), on uniforms ``u f32[3, M, R]``,
at each slot ``p`` in order, with ``n`` the running op count and
``W = sum_b max_w(b)`` (``max_w(b)`` the largest diagonal weight of bond
``b``):

- the proposal is ``b = #{cum_max_w < u[1] * W}``, clamped to ``NB - 1``;
- an empty slot takes ``b`` where ``u[2] * max_w(b) < w(b, spins below p)``
  and ``u[0] * (M - n + beta W) < beta W``;
- a diagonal op (inputs equal to outputs on every leg) goes where
  ``u[0] * (M - n + 1 + beta W) < M - n + 1``, the sum taken left to right.

Every product and comparison is float32. A timestep either runs the
diagonal update alone, on the ``(3, M, R)`` uniforms and nothing else, or
the diagonal update, the cluster update and the free spins' coin flips, as
:func:`benchmark.reference.sse.timestep` with this diagonal update in the
Metropolis one's place. A chunk of ``nsteps`` runs the cluster update on the
timesteps ``i % k == k - 1``, then the growth and the caps.

``precision="bfloat16"`` rounds ``u[2] * max_w``, ``w`` and the carry's
products and sums to bfloat16: the control, which a sound comparison has to
refuse.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from benchmark.reference.sse import (
    Ops, Tfim, _spins_below, cluster_caps, clusters, grow, label_space, op_count,
    to_bf16,
)

# The weights are float32 on the card; a float32 product must not become TF32.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def heatbath_tables(model: Tfim) -> tuple[np.ndarray, np.ndarray]:
    """``max_w f32[NB]``, each bond's largest diagonal weight, and their
    inclusive cumulative sums ``cum_max_w f32[NB]`` (the last is ``W``)."""
    max_w = model.diag_w.max(axis=1).astype(np.float32)
    return max_w, np.cumsum(max_w, dtype=np.float32)


def _carry(u0, can_ins, removable, n0, M: int, bwt, rnd=None):
    """The walk over the slots, on host arrays: ``can_ins`` marks the empty
    slots whose proposal passed its weight test, ``bwt f32[R]`` is
    ``beta W``. Without ``rnd``, ``M - n`` is carried exactly in float32;
    with it, every sum and product of the tests is rounded by ``rnd``."""
    f32 = np.float32
    one = f32(1.0)
    insert = np.zeros(u0.shape, bool)
    remove = np.zeros(u0.shape, bool)
    if rnd is None:
        mmn = (M - n0).astype(f32)
        for p in range(M):
            ins = can_ins[p] & (u0[p] * (mmn + bwt) < bwt)
            rem = removable[p] & (u0[p] * ((mmn + one) + bwt) < mmn + one)
            insert[p] = ins
            remove[p] = rem
            mmn -= ins
            mmn += rem
        return insert, remove
    n = n0.astype(np.int64)
    for p in range(M):
        mmn = rnd((M - n).astype(f32))
        m1 = rnd(mmn + one)
        ins = can_ins[p] & (rnd(u0[p] * rnd(mmn + bwt)) < bwt)
        rem = removable[p] & (rnd(u0[p] * rnd(m1 + bwt)) < m1)
        insert[p] = ins
        remove[p] = rem
        n += ins.astype(np.int64) - rem.astype(np.int64)
    return insert, remove


def diagonal(ops: Ops, state: np.ndarray, beta: np.ndarray, u: torch.Tensor, model: Tfim,
             device, precision: str = "float32") -> Ops:
    """One heat-bath diagonal update on uniforms ``u f32[3, M, R]`` at
    inverse temperatures ``beta f32[R]``. The walk runs on the host; the
    rest on ``device``."""
    M, R = ops.bond.shape
    NB = len(model.bond_vars)
    max_w, cum = heatbath_tables(model)
    total = torch.tensor(cum[-1], dtype=torch.float32, device=device)
    cum_t = torch.as_tensor(cum, device=device)
    b_new = torch.clamp(torch.searchsorted(cum_t, (u[1] * total).contiguous()), max=NB - 1)
    bond_vars = torch.as_tensor(model.bond_vars, device=device)
    qvar = bond_vars[b_new].permute(2, 0, 1)  # [2, M, R]
    bits = _spins_below(ops, state, qvar, model, device)
    diag_w = torch.as_tensor(model.diag_w, device=device)
    w_new = diag_w[b_new, bits[0].long() + 2 * bits[1].long()]
    mw = torch.as_tensor(max_w, device=device)[b_new]
    if precision == "bfloat16":
        insw = (u[2] * mw).to(torch.bfloat16) < w_new.to(torch.bfloat16)
    else:
        insw = u[2] * mw < w_new
    bond = torch.as_tensor(ops.bond, device=device)
    ins = torch.as_tensor(ops.ins, device=device)
    outs = torch.as_tensor(ops.outs, device=device)
    empty = bond < 0
    removable = ~empty & (ins == outs).all(dim=0)
    walk = (_host(u[0]), _host(empty & insw), _host(removable), op_count(ops), M)
    bwt = beta.astype(np.float32) * cum[-1]
    if precision == "bfloat16":
        insert, remove = _carry(*walk, to_bf16(bwt), to_bf16)
    else:
        insert, remove = _carry(*walk, bwt)
    insert = torch.as_tensor(insert, device=device)
    remove = torch.as_tensor(remove, device=device)
    new_bond = torch.where(insert, b_new.to(torch.int32), torch.where(remove, -1, bond))
    legs = torch.where(insert[None], bits, ins) & ~remove[None]
    changed = (new_bond != bond)[None]
    return Ops(_host(new_bond), _host(torch.where(changed, legs, ins)),
               _host(torch.where(changed, legs, outs)))


def cluster_and_free_spins(ops: Ops, state: np.ndarray, model: Tfim,
                           draw: Callable[[tuple], torch.Tensor], caps: tuple[int, int],
                           device) -> tuple[Ops, np.ndarray]:
    """The cluster update on ``(SL, R)`` uniforms (where the caps hold every
    replica's runs and links; else none are drawn and nothing flips), then
    the coin flips ``(R, N)`` of the spins that carry no op: the part of
    :func:`benchmark.reference.sse.timestep` after its diagonal update."""
    M, R = ops.bond.shape
    N = model.nvars
    cl = clusters(ops, model, device)
    SL = label_space(M, N, caps, int(cl.nruns.max()), int(cl.nlinks.max()))
    bond = torch.as_tensor(ops.bond, device=device)
    second = torch.as_tensor(model.bond_vars[:, 1] >= 0, device=device)
    lv = torch.stack([bond >= 0, (bond >= 0) & second[bond.clamp(min=0).long()]])
    ins = torch.as_tensor(ops.ins, device=device)
    outs = torch.as_tensor(ops.outs, device=device)
    if SL is not None:
        flip = draw((SL, R)) < 0.5
        flip = torch.cat([flip, torch.zeros((cl.label.shape[0] - SL, R), dtype=torch.bool,
                                            device=device)])
        valid = bond >= 0
        f_in = torch.gather(flip, 0, torch.gather(cl.label, 0, cl.run_in)) & valid
        f_out = torch.gather(flip, 0, torch.gather(cl.label, 0, cl.run_out)) & valid
        ins = ins ^ (f_in[None] & lv)
        outs = outs ^ (f_out[None] & lv)
    has = cl.head >= 0
    first_in = torch.gather(ins.reshape(2 * M, R), 0, cl.head.clamp(min=0)).T
    coin = draw((R, N)) < 0.5
    st = torch.where(has.T, first_in, coin)
    return Ops(ops.bond, _host(ins), _host(outs)), _host(st)


def timestep(ops: Ops, state: np.ndarray, beta: np.ndarray, model: Tfim,
             draw: Callable[[tuple], torch.Tensor], caps: tuple[int, int], device,
             do_cluster: bool, precision: str = "float32") -> tuple[Ops, np.ndarray]:
    """One timestep on the uniforms ``draw(shape)`` returns: the diagonal
    ``(3, M, R)``; where ``do_cluster``, then the cluster ``(SL, R)`` and the
    free spins ``(R, N)``."""
    M, R = ops.bond.shape
    ops = diagonal(ops, state, beta, draw((3, M, R)), model, device, precision)
    if not do_cluster:
        return ops, state
    return cluster_and_free_spins(ops, state, model, draw, caps, device)


def chunk(start: dict, model: Tfim, beta: float, nsteps: int, k: int,
          draw: Callable[[tuple], torch.Tensor], device,
          precision: str = "float32") -> dict:
    """The end of a chunk of ``nsteps`` timesteps from the program's state
    at its start (``start``: ``bond``, ``ins``, ``outs``, ``state`` and the
    cluster ``caps``), the cluster update on the timesteps ``i % k == k - 1``,
    then the growth: the op string, spins, the op counts after each timestep
    (``ns``) and the caps."""
    ops = Ops(start["bond"], start["ins"], start["outs"])
    state = start["state"]
    betas = np.full(state.shape[0], beta, np.float32)
    ns = []
    for i in range(nsteps):
        ops, state = timestep(ops, state, betas, model, draw, start["caps"], device,
                              i % k == k - 1, precision)
        ns.append(op_count(ops))
    caps = cluster_caps(ops, model, start["caps"])
    ops = grow(ops)
    return {"bond": ops.bond, "ins": ops.ins, "outs": ops.outs, "state": state,
            "ns": np.stack(ns), "caps": caps}
