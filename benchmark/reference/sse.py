"""A plain reference of the stochastic-series-expansion (SSE) timestep of the
transverse-field Ising model, written from the published algorithm and the
upstream's semantics (Renmusxd/IsingMonteCarlo ``src/sse/qmc_ising.rs``,
``qmc_traits/diagonal.rs``, ``qmc_traits/cluster.rs``; Sandvik, PRB 59,
14157), in numpy and plain torch. It imports nothing of the program.

``H = sum_ij J_ij s^z_i s^z_j + G sum_i s^x_i`` with ``h = 0``. An op string
of ``M`` slots and ``R`` replicas is ``bond i32[M, R]`` (``-1`` an empty
slot) and the per-leg spins ``ins, outs bool[2, M, R]``; bond ids follow the
upstream's layout: ``[0, NE)`` the edges (leg 0 and leg 1 their two
variables), ``[NE, NE + N)`` the field ops of each variable (leg 0 only).
A timestep, on uniforms drawn in a fixed order from one stream:

1. the diagonal update, on ``u f32[3, M, R]``: at each slot ``p`` in order,
   with ``n`` the running op count, an empty slot proposes bond
   ``b = floor(u[1] * NB)`` and takes it where ``u[0] * (M - n) <
   (beta * NB) * w(b, spins below p)``; a diagonal op (inputs equal to
   outputs on every leg) goes where ``u[0] * ((beta * NB) * w) < M - n + 1``.
   Every product and comparison is float32, as the configuration states;
2. the cluster update: the legs' worldlines are cut at every field op and
   joined by every edge op and across imaginary time; each cluster flips
   where its uniform ``f32[SL, R]`` is below 1/2 (with ``h = 0`` flipping all
   legs of an op never changes its weight), its uniform's row being the
   cluster's least worldline-run id, the runs numbered in order of
   ``(variable, slot)`` with a new run at each variable's first leg and
   after each field op; ``SL`` is the label space the cluster caps give;
3. spins that carry no op take fresh coin flips ``bool[R, N]``;
4. between chunks, the cutoff grows to ``M' = 16 ceil((n + n // 2) / 16)``
   where that exceeds ``M`` (slots appended empty), and the cluster caps
   follow the largest counts of field and edge ops.

``precision="bfloat16"`` rounds every operand and product of the diagonal
update's acceptance tests to bfloat16: the control, which a sound
comparison has to refuse.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

BIG = 1 << 40


class Tfim(NamedTuple):
    bond_vars: np.ndarray  # i32[NB, 2], -1 where a field op has no second leg
    diag_w: np.ndarray  # f32[NB, 4]: weight of a diagonal op, index = leg0 + 2 leg1
    is_field: np.ndarray  # bool[NB]
    nvars: int


class Ops(NamedTuple):
    bond: np.ndarray  # i32[M, R]
    ins: np.ndarray  # bool[2, M, R]
    outs: np.ndarray  # bool[2, M, R]


def tfim(edges, transverse: float, longitudinal: float = 0.0) -> Tfim:
    """The bond tables of the upstream's TFIM (``qmc_ising.rs:80-115,
    863-878``): an edge's diagonal weight is ``|J| - J`` for aligned spins and
    ``|J| + J`` for opposite ones, a field op's ``G``."""
    if longitudinal != 0.0:
        raise ValueError("the reference covers h = 0 only")
    nvars = max(max(a, b) for (a, b), _ in edges) + 1
    ne = len(edges)
    nb = ne + nvars
    bond_vars = np.full((nb, 2), -1, np.int32)
    diag_w = np.zeros((nb, 4), np.float32)
    for k, ((a, b), j) in enumerate(edges):
        bond_vars[k] = (a, b)
        for s in range(4):
            diag_w[k, s] = abs(j) - j if (s & 1) == (s >> 1) else abs(j) + j
    bond_vars[ne:, 0] = np.arange(nvars)
    diag_w[ne:] = np.float32(transverse)
    is_field = np.zeros(nb, bool)
    is_field[ne:] = True
    return Tfim(bond_vars, diag_w, is_field, nvars)


def to_bf16(x: np.ndarray) -> np.ndarray:
    """float32 values rounded to the nearest bfloat16, ties to even."""
    b = np.ascontiguousarray(x, np.float32).view(np.uint32)
    b = (b + np.uint32(0x7FFF) + ((b >> np.uint32(16)) & np.uint32(1))) & np.uint32(0xFFFF0000)
    return b.view(np.float32)


def op_count(ops: Ops) -> np.ndarray:
    return (ops.bond >= 0).sum(axis=0).astype(np.int32)


def _leg_vars(bond: np.ndarray, model: Tfim) -> np.ndarray:
    """i32[2, M, R]: each leg's variable, -1 on empty slots and absent legs."""
    v = model.bond_vars[np.maximum(bond, 0)]  # [M, R, 2]
    return np.where(bond[None] >= 0, np.moveaxis(v, -1, 0), -1)


def _spins_below(ops: Ops, state: np.ndarray, qvar: torch.Tensor, model: Tfim,
                 device) -> torch.Tensor:
    """bool[2, M, R]: the spin of variable ``qvar[l, p, r]`` just below slot
    ``p`` (the p=0 spin, flipped by every op before ``p`` whose leg on it
    changes it); False where ``qvar < 0``."""
    M, R = ops.bond.shape
    lv = torch.as_tensor(_leg_vars(ops.bond, model), device=device).long()
    tog = (torch.as_tensor(ops.ins, device=device) != torch.as_tensor(ops.outs, device=device))
    slot = torch.arange(M, device=device)[None, :, None]
    keys = torch.where(tog & (lv >= 0), lv * M + slot, BIG).reshape(2 * M, R).T
    keys = torch.sort(keys.contiguous(), dim=1).values
    q = qvar.long()
    at = (q * M + slot).reshape(2 * M, R).T.contiguous()
    flips = (torch.searchsorted(keys, at) - torch.searchsorted(keys, (q * M).reshape(2 * M, R).T
                                                               .contiguous())) & 1
    flips = flips.T.reshape(2, M, R).bool()
    st = torch.as_tensor(state, device=device)
    rows = torch.arange(R, device=device)[None, None, :]
    return (st[rows, q.clamp(min=0)] ^ flips) & (q >= 0)


def _carry(u0, num_ins, num_rem, empty, removable, n0, M: int):
    """The walk over the slots, carrying ``M - n`` exactly in float32."""
    f32 = np.float32
    mmn = (M - n0).astype(f32)
    insert = np.zeros(u0.shape, bool)
    remove = np.zeros(u0.shape, bool)
    one = f32(1.0)
    for p in range(M):
        ins = empty[p] & (u0[p] * mmn < num_ins[p])
        rem = removable[p] & (u0[p] * num_rem[p] < mmn + one)
        insert[p] = ins
        remove[p] = rem
        mmn -= ins
        mmn += rem
    return insert, remove


def _carry_rounded(u0, num_ins, num_rem, empty, removable, n0, M: int, rnd):
    """:func:`_carry` with every operand and product rounded by ``rnd``."""
    f32 = np.float32
    n = n0.astype(np.int64)
    insert = np.zeros(u0.shape, bool)
    remove = np.zeros(u0.shape, bool)
    for p in range(M):
        mmn = rnd((M - n).astype(f32))
        ins = empty[p] & (rnd(u0[p] * mmn) < num_ins[p])
        rem = removable[p] & (rnd(u0[p] * num_rem[p]) < rnd(mmn + f32(1.0)))
        insert[p] = ins
        remove[p] = rem
        n += ins.astype(np.int64) - rem.astype(np.int64)
    return insert, remove


def diagonal(ops: Ops, state: np.ndarray, beta: np.ndarray, u: torch.Tensor, model: Tfim,
             device, precision: str = "float32") -> Ops:
    """One diagonal update on uniforms ``u f32[3, M, R]`` at inverse
    temperatures ``beta f32[R]``."""
    M, R = ops.bond.shape
    NB = len(model.bond_vars)
    nb = np.float32(NB)
    b_new = torch.clamp((u[1] * float(nb)).to(torch.int32), max=NB - 1).long()
    bond_vars = torch.as_tensor(model.bond_vars, device=device)
    qvar = bond_vars[b_new].permute(2, 0, 1)  # [2, M, R]
    bits = _spins_below(ops, state, qvar, model, device)
    diag_w = torch.as_tensor(model.diag_w, device=device)
    w_new = diag_w[b_new, bits[0].long() + 2 * bits[1].long()].cpu().numpy()
    b_new = b_new.cpu().numpy().astype(np.int32)
    bits = bits.cpu().numpy()
    u0 = u[0].cpu().numpy()
    valid = ops.bond >= 0
    w_cur = model.diag_w[np.maximum(ops.bond, 0),
                         ops.ins[0].astype(np.int32) + 2 * ops.ins[1].astype(np.int32)]
    empty = ~valid
    removable = valid & (ops.ins == ops.outs).all(axis=0)
    n0 = op_count(ops)
    if precision == "bfloat16":
        bnb = to_bf16(beta.astype(np.float32) * nb)[None, :]
        insert, remove = _carry_rounded(
            to_bf16(u0), to_bf16(bnb * to_bf16(w_new)), to_bf16(bnb * to_bf16(w_cur)), empty,
            removable, n0, M, to_bf16)
    else:
        bnb = (beta.astype(np.float32) * nb)[None, :]
        insert, remove = _carry(u0, bnb * w_new, bnb * w_cur, empty, removable, n0, M)
    bond = np.where(insert, b_new, np.where(remove, -1, ops.bond)).astype(np.int32)
    legs = np.where(insert[None], bits, ops.ins) & ~remove[None]
    changed = (bond != ops.bond)[None]
    return Ops(bond, np.where(changed, legs, ops.ins), np.where(changed, legs, ops.outs))


class Clusters(NamedTuple):
    run_in: torch.Tensor  # i64[M, R]: run id of slot p's input side (leg 0)
    run_out: torch.Tensor  # i64[M, R]
    label: torch.Tensor  # i64[S + 1, R]: least run id of each run's cluster
    nruns: torch.Tensor  # i64[R]
    nlinks: torch.Tensor  # i64[R]: edge ops plus variables with legs
    head: torch.Tensor  # i64[N, R]: flat leg (l M + p) of each variable's first leg, -1 if none


def clusters(ops: Ops, model: Tfim, device) -> Clusters:
    """Worldline runs and the clusters they form, each labelled by its least
    run id."""
    M, R = ops.bond.shape
    N = model.nvars
    lv = torch.as_tensor(_leg_vars(ops.bond, model), device=device).long()  # [2, M, R]
    slot = torch.arange(M, device=device)[None, :, None]
    key = torch.where(lv >= 0, lv * M + slot, BIG).reshape(2 * M, R)
    skey, order = torch.sort(key, dim=0, stable=True)
    valid = skey < BIG
    var = torch.where(valid, skey // M, -1)
    first = valid.clone()
    first[1:] &= var[1:] != var[:-1]
    last = valid.clone()
    last[:-1] &= var[:-1] != var[1:]
    is_field = torch.as_tensor(model.is_field, device=device)
    field_slot = is_field[torch.as_tensor(np.maximum(ops.bond, 0), device=device).long()] & (
        torch.as_tensor(ops.bond, device=device) >= 0)
    field_leg = torch.cat([field_slot, torch.zeros_like(field_slot)])  # leg 1 of a field op is absent
    cut = torch.gather(field_leg, 0, order) & valid
    c = torch.cumsum(first.long() + cut.long(), dim=0)
    r_in_s = c - cut.long() - 1
    r_out_s = c - 1
    r_in = torch.empty_like(r_in_s).scatter_(0, order, r_in_s).reshape(2, M, R)
    r_out = torch.empty_like(r_out_s).scatter_(0, order, r_out_s).reshape(2, M, R)
    S = 2 * M + N  # more than the runs there can be
    dump = S
    both = (lv[0] >= 0) & (lv[1] >= 0)
    a = [torch.where(both, r_in[0], dump)]
    b = [torch.where(both, r_in[1], dump)]
    rows_first = torch.where(first, var, N)
    rows_last = torch.where(last, var, N)

    def per_var(rows, vals, fill):
        out = torch.full((N + 1, R), fill, dtype=torch.long, device=device)
        return out.scatter_(0, rows, vals)[:N]

    wrap_in = per_var(rows_first, r_in_s, dump)
    a.append(wrap_in)
    b.append(per_var(rows_last, r_out_s, dump))
    a, b = torch.cat(a), torch.cat(b)
    label = torch.arange(S + 1, device=device)[:, None].repeat(1, R)
    while True:
        la, lb = torch.gather(label, 0, a), torch.gather(label, 0, b)
        lo = torch.minimum(la, lb)
        new = label.scatter_reduce(0, la, lo, "amin").scatter_reduce(0, lb, lo, "amin")
        while True:
            jumped = torch.gather(new, 0, new)
            if torch.equal(jumped, new):
                break
            new = jumped
        if torch.equal(new, label):
            break
        label = new
    nlinks = both.sum(0) + (wrap_in != dump).sum(0)
    head = per_var(rows_first, order, -1)
    return Clusters(r_in[0], r_out[0], label, c[-1], nlinks, head)


def label_shape(M: int, N: int, caps: tuple[int, int]) -> tuple[int, int]:
    """The label rows and link rows of the cluster label problem at cutoff
    ``M`` under the caps ``caps``: the full space of ``M + N + 1`` rows and
    ``M + N`` links, or the compacted one the caps give where they are more
    than 64 rows short of it."""
    S, E = M + N + 1, M + N
    if caps[0] + 64 >= S:
        return S, E
    return caps[0], min(caps[1], E)


def label_space(M: int, N: int, caps: tuple[int, int], nruns: int, nlinks: int) -> int | None:
    """The rows ``SL`` of the cluster uniforms the label caps give, or None
    where a replica's runs or links overflow them and the cluster update is
    skipped for the timestep (no uniforms drawn)."""
    C, CE = label_shape(M, N, caps)
    if C == M + N + 1 or (nruns <= C - 1 and nlinks <= CE):
        return C
    return None


def timestep(ops: Ops, state: np.ndarray, beta: np.ndarray, model: Tfim,
             draw: Callable[[tuple], torch.Tensor], caps: tuple[int, int], device,
             precision: str = "float32") -> tuple[Ops, np.ndarray]:
    """One timestep on the uniforms ``draw(shape)`` returns, in the order
    diagonal ``(3, M, R)``, cluster ``(SL, R)`` (where it runs), free spins
    ``(R, N)``."""
    M, R = ops.bond.shape
    N = model.nvars
    ops = diagonal(ops, state, beta, draw((3, M, R)), model, device, precision)
    cl = clusters(ops, model, device)
    SL = label_space(M, N, caps, int(cl.nruns.max()), int(cl.nlinks.max()))
    lv = torch.as_tensor(_leg_vars(ops.bond, model) >= 0, device=device)
    ins = torch.as_tensor(ops.ins, device=device)
    outs = torch.as_tensor(ops.outs, device=device)
    if SL is not None:
        flip = draw((SL, R)) < 0.5
        flip = torch.cat([flip, torch.zeros((cl.label.shape[0] - SL, R), dtype=torch.bool,
                                            device=device)])
        valid = torch.as_tensor(ops.bond >= 0, device=device)
        f_in = torch.gather(flip, 0, torch.gather(cl.label, 0, cl.run_in)) & valid
        f_out = torch.gather(flip, 0, torch.gather(cl.label, 0, cl.run_out)) & valid
        ins = ins ^ (f_in[None] & lv)
        outs = outs ^ (f_out[None] & lv)
    has = cl.head >= 0
    first_in = torch.gather(ins.reshape(2 * M, R), 0, cl.head.clamp(min=0)).T
    coin = draw((R, N)) < 0.5
    st = torch.where(has.T, first_in, coin)
    return Ops(ops.bond, ins.cpu().numpy(), outs.cpu().numpy()), st.cpu().numpy()


def cluster_caps(ops: Ops, model: Tfim, caps: tuple[int, int]) -> tuple[int, int]:
    """The label and link caps after a chunk: 30% over the most field ops
    (labels) and edge ops (links) of any replica, plus ``N + 2``, in
    multiples of 16 and at least 256, never shrinking."""
    N = model.nvars
    occ = ops.bond >= 0
    b = np.maximum(ops.bond, 0)
    n_field = int((occ & model.is_field[b]).sum(0).max())
    n_edge = int((occ & ~model.is_field[b]).sum(0).max())

    def cap(k):
        return max(256, 16 * ((int((k + N + 2) * 1.3) + 15) // 16))

    return max(cap(n_field), caps[0]), max(cap(n_edge), caps[1])


def grow(ops: Ops) -> Ops:
    """The cutoff after a chunk: ``n + n // 2`` of the largest op count,
    rounded up to a multiple of 16, where that exceeds ``M``."""
    M, R = ops.bond.shape
    n = int(op_count(ops).max())
    want = n + n // 2
    if want <= M:
        return ops
    pad = ((want + 15) // 16) * 16 - M
    return Ops(np.concatenate([ops.bond, np.full((pad, R), -1, np.int32)]),
               np.concatenate([ops.ins, np.zeros((2, pad, R), bool)], axis=1),
               np.concatenate([ops.outs, np.zeros((2, pad, R), bool)], axis=1))
