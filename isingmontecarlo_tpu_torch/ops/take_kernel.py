"""K4: per-replica gathers on label tables, and the hook and the pointer
jumps of a hook-and-compress round.

Replaces ``isingmontecarlo_tpu/ops/take_kernel.py::take0`` (a Pallas
digit-plane gather on the TPU's matrix unit) and the XLA hook around it at
``isingmontecarlo_tpu/sse/cluster.py:561-570``. The CUDA kernels are the
three entry points of ``csrc/take0.cu``; see that file for what bounds them
on the card. Each wrapper takes its plain PyTorch version for a CPU tensor
and launches its kernel (counting the launch in ``<wrapper>.launches``) for
a CUDA tensor, or raises.
"""

from __future__ import annotations

import torch

from isingmontecarlo_tpu_torch.ops import _build


def take0_plain(table: torch.Tensor, idx: torch.Tensor,
                idx2: torch.Tensor | None = None):
    """The plain PyTorch version: ``torch.gather`` along axis 0, per grid."""
    out = torch.gather(table, 0, idx.long())
    return out if idx2 is None else (out, torch.gather(table, 0, idx2.long()))


def take0(table: torch.Tensor, idx: torch.Tensor, idx2: torch.Tensor | None = None):
    """``take_along_axis(table, idx, axis=0)`` for ``table i32[C, R]`` and
    ``idx i32[E, R]`` with values in ``[0, C)``; returns ``i32[E, R]``. With
    ``idx2 i32[E2, R]`` one launch gathers both grids from the table and
    returns the pair."""
    C, R = table.shape
    _build.check(table, "table", torch.int32, (C, R), table.device)
    _build.check(idx, "idx", torch.int32, (idx.shape[0], R), table.device)
    if idx2 is not None:
        _build.check(idx2, "idx2", torch.int32, (idx2.shape[0], R), table.device)
    if not _build.use_kernel(table.device):
        return take0_plain(table, idx, idx2)
    out = torch.empty_like(idx)
    out2 = None if idx2 is None else torch.empty_like(idx2)
    _build.launch("ising_take0", table, idx, out, idx2, out2, C, idx.shape[0],
                  0 if idx2 is None else idx2.shape[0], R)
    take0.launches += 1
    return out if idx2 is None else (out, out2)


def hook_min_plain(P: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                   first: bool = False) -> torch.Tensor:
    """The plain PyTorch version: endpoint gathers, then ``scatter_reduce``
    with ``amin`` onto the rows of the larger endpoint labels."""
    pu, pv = (u, v) if first else (torch.gather(P, 0, u.long()),
                                   torch.gather(P, 0, v.long()))
    return P.scatter_reduce(0, torch.maximum(pu, pv).long(),
                            torch.minimum(pu, pv), reduce="amin")


def hook_min(P: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
             first: bool = False) -> torch.Tensor:
    """One hook of a hook-and-compress round over the edge list ``(u, v)
    i32[E, R]`` (values in ``[0, S)``): with ``pu, pv = P[u], P[v]`` per
    replica, ``Pn[max(pu, pv)] = min(P[max(pu, pv)], every min(pu, pv)
    hooked there)``. Returns the new ``Pn i32[S, R]``; ``P`` is unchanged.

    ``first=True`` is the round from the identity, ``P[x] = x``: the
    endpoint labels are ``u`` and ``v`` themselves, and ``P`` must be the
    identity. The kernel needs ``P[x] <= x`` (every label array of the
    hook-and-compress rounds has it) to skip its no-op updates."""
    S, R = P.shape
    _build.check(P, "P", torch.int32, (S, R), P.device)
    _build.check(u, "u", torch.int32, (u.shape[0], R), P.device)
    _build.check(v, "v", torch.int32, tuple(u.shape), P.device)
    if not _build.use_kernel(P.device):
        return hook_min_plain(P, u, v, first)
    Pn = P.clone()
    _build.launch("ising_hook_min", P, Pn, u, v, int(first), S, u.shape[0], R)
    hook_min.launches += 1
    return Pn


def pointer_jump_plain(Pn: torch.Tensor, P_start: torch.Tensor, jumps: int,
                       flag: torch.Tensor | None = None, tag: int = 1):
    """The plain PyTorch version: ``jumps`` gathers ``P <- P[P]``, then the
    compare."""
    out = Pn.clone()
    for _ in range(jumps):
        out = torch.gather(out, 0, out.long())
    if flag is None:
        flag = torch.zeros(1, dtype=torch.int32, device=Pn.device)
    flag.copy_(torch.where((out != P_start).any(), tag, flag))
    return out, flag


def pointer_jump(Pn: torch.Tensor, P_start: torch.Tensor, jumps: int,
                 flag: torch.Tensor | None = None, tag: int = 1):
    """``jumps`` pointer jumps ``P <- P[P]`` from ``Pn i32[S, R]`` in one
    launch: ``out[x] = Pn`` applied ``2**jumps`` times to ``x``, which is
    what ``jumps`` separate jumps give. Returns ``(out, flag)``: ``flag
    i32[1]`` is set to ``tag`` where any ``out[x] != P_start[x]`` and left
    as it was otherwise (a fresh flag starts at 0). A caller that runs
    rounds numbered ``1, 2, ...`` with one flag and ``tag`` = the round
    reads from the flag whether the round changed anything, without
    zeroing it between rounds."""
    S, R = Pn.shape
    _build.check(Pn, "Pn", torch.int32, (S, R), Pn.device)
    _build.check(P_start, "P_start", torch.int32, (S, R), Pn.device)
    if flag is None:
        flag = torch.zeros(1, dtype=torch.int32, device=Pn.device)
    _build.check(flag, "flag", torch.int32, (1,), Pn.device)
    if not _build.use_kernel(Pn.device):
        return pointer_jump_plain(Pn, P_start, jumps, flag, tag)
    out = torch.empty_like(Pn)
    _build.launch("ising_pointer_jump", Pn, P_start, out, flag, tag, 2 ** jumps, S, R)
    pointer_jump.launches += 1
    return out, flag


take0.launches = 0
hook_min.launches = 0
pointer_jump.launches = 0
