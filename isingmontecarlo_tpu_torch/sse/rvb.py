"""RVB (resonating-valence-bond) cluster updates (port of
``isingmontecarlo_tpu/sse/rvb.py``; reference ``src/sse/qmc_traits/rvb.rs``).

One update per replica:

1. **Cluster growth** (``build_cluster``, ``rvb.rs:1054-1123``): cluster
   elements are imaginary-time segments of single-variable worldlines
   bounded by consecutive constant (transverse-field) ops, or whole
   worldlines of variables with no constant op. From a uniformly chosen
   seed element, a geometric number of elements (at most :data:`MAX_POPS`)
   is popped from a weighted boundary set (weight 1 for the same variable's
   neighbouring segments, the bond magnitude for lattice neighbours'
   segments that overlap in imaginary time), by Gumbel-argmax over the
   element space ``[0, M + N)``.
2. **Acceptance** (``calculate_flip_prob``, ``rvb.rs:649-946``): every
   diagonal lattice op on a boundary bond (one endpoint in the cluster)
   contributes ``W_after / W_before``, the total weight of all boundary
   bonds in the flipped and the current state; ops entirely inside the
   cluster contribute their flip ratio.
3. **Mutation** (``mutate_graph``, ``rvb.rs:294-615``): boundary ops rotate
   to a boundary bond drawn by weight, the cluster-bounding constant ops
   toggle off-diagonal, interior ops flip, and the p=0 state flips where
   the cluster holds p=0.

GPU form. The propagated worldline state and the cluster mask at every
slot are exclusive prefix parities along imaginary time: an integer scatter
of the toggle events into counts ``[2R, W + 2, M + 1]`` and one ``cumsum``
along the slots (counts wrap in ``uint8``, which keeps their parity). The
columns are only the variables an update reads: with the candidate edge
axis (``A = MAX_POPS * D < NE``) the cluster's variables and their lattice
neighbours, ``W <= MAX_POPS * (D + 1)``, otherwise all ``N``. Every
per-slot quantity then vectorises over ``M``; the edge ends' bits are
whole rows, the legs' bits plain gathers. The cluster builds of a whole
sweep run batched (they read only the sweep-invariant constant-op
inventory), then the updates' acceptance-and-mutation passes run in order.
No step reads the host.

Randomness enters through an :class:`RvbDraws` object asked for each draw
by shape, in the shapes the JAX package draws.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Protocol

import numpy as np
import torch

from isingmontecarlo_tpu_torch.sse.model import BondModel
from isingmontecarlo_tpu_torch.sse.opstring import OpString, substate_index

BIG = 2**30
TINY = 1e-30
NEG_INF = float("-inf")
# The geometric cluster size is capped at MAX_POPS pops (the reference caps
# its trailing-ones draw at 64); P(size > 16) < 1e-4, and the cap changes
# only the proposal distribution.
MAX_POPS = 16

# Footprint gate of the one-shot acceptance-and-mutation pass:
# M x R x max(EW, K*N) elements, EW the edge-axis width. At the gate the
# parity counts take 1 GiB (uint8) and an edge-axis f32 tensor at most
# 4 GiB; a longer string runs in chunks of slots at this footprint.
VEC_MAX_ELEMS = 1 << 30
# Element gate of one batch of cluster builds, G x R x max(M*D, M+N): at
# the gate a [G, R, M] f32 temporary is 1 GiB. Larger sweeps build in
# batches of G updates.
BUILD_MAX_ELEMS = 1 << 28


class RvbTables(NamedTuple):
    """Adjacency over the 2-site (edge) bonds, ``EdgeNavigator``
    (``rvb.rs:10-32``) in dense padded form."""

    neigh_bond: torch.Tensor  # i32[N, D] edge-bond ids per var, -1 pad
    neigh_var: torch.Tensor  # i32[N, D] the other var of that bond
    bond_mag: torch.Tensor  # f32[NE] largest matrix element per edge bond
    nedges: int


def make_rvb_tables(edges, model: BondModel) -> RvbTables:
    """Adjacency over the lattice edges (bonds ``[0, NE)`` of the TFIM
    layout, ``qmc_ising.rs:186-205``), on the model's device."""
    nvars = model.nvars
    ne = len(edges)
    lists: list[list[tuple[int, int]]] = [[] for _ in range(nvars)]
    for b, ((va, vb), _) in enumerate(edges):
        lists[va].append((b, vb))
        lists[vb].append((b, va))
    deg = max(1, max((len(l) for l in lists), default=0))
    nb = np.full((nvars, deg), -1, np.int32)
    nv = np.full((nvars, deg), -1, np.int32)
    for v, l in enumerate(lists):
        for d, (b, ov) in enumerate(l):
            nb[v, d] = b
            nv[v, d] = ov
    dev = model.diag_w.device
    return RvbTables(
        neigh_bond=torch.from_numpy(nb).to(dev),
        neigh_var=torch.from_numpy(nv).to(dev),
        bond_mag=model.diag_w[:ne].max(dim=1).values.contiguous(),
        nedges=ne,
    )


class RvbDraws(Protocol):
    """The random numbers of one RVB sweep of ``U`` updates, asked for by
    shape. ``u0`` is the first update a batch of rows belongs to."""

    def seed(self, u0: int, shape: tuple[int, int]) -> torch.Tensor:
        """Uniforms ``f32[G, R]`` in ``[0, 1)`` choosing the seed elements
        of updates ``u0 .. u0 + G - 1``."""

    def size(self, u0: int, shape: tuple[int, int]) -> torch.Tensor:
        """Uniforms ``f32[G, R]`` in ``[1e-9, 1)`` sizing the clusters."""

    def pop(self, u0: int, i: int, shape: tuple[int, int, int]) -> torch.Tensor:
        """Gumbels ``f32[G, R, M + N]`` of pop iteration ``i``."""

    def accept(self, u0: int, shape: tuple[int, int]) -> torch.Tensor:
        """Uniforms ``f32[G, R]`` of the acceptance tests."""

    def rotation(self, u: int, chunk: int | None,
                 shape: tuple[int, int, int]) -> torch.Tensor:
        """Gumbels ``f32[M, R, EW]`` of update ``u``'s bond rotations, or
        ``f32[mc, R, EW]`` of chunk ``chunk`` of a chunked pass (``None``
        for the one-shot pass)."""


def contiguous_bits(u: torch.Tensor) -> torch.Tensor:
    """``n`` with probability ``2^-(n+1)`` from uniforms ``u`` in ``[1e-19,
    1)``: the reference's trailing-ones draw that sizes an RVB spacetime
    cluster (``contiguous_bits``, ``rvb.rs:1190-1192``; the JAX package's,
    ``isingmontecarlo_tpu/sse/rvb.py:64``), capped at 64 as a ``u64`` draw
    is. ``i32`` of ``u``'s shape."""
    return torch.floor(-torch.log2(u)).to(torch.int32).clamp(0, 64)


def gumbel(u: torch.Tensor) -> torch.Tensor:
    """Gumbel variates from uniforms in ``[0, 1)``, in place, as
    ``jax.random.gumbel`` makes them: ``-log(-log(u))`` with ``u`` bounded
    below by the smallest normal float, so no ``log(0)`` occurs."""
    return u.clamp_(min=torch.finfo(u.dtype).tiny).log_().neg_().log_().neg_()


class GeneratorRvbDraws:
    """:class:`RvbDraws` from a ``torch.Generator`` on one device."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    def _uniform(self, shape) -> torch.Tensor:
        return torch.rand(shape, generator=self.generator,
                          device=self.generator.device, dtype=torch.float32)

    def seed(self, u0, shape):
        return self._uniform(shape)

    def size(self, u0, shape):
        return self._uniform(shape).add_(1e-9).clamp_(min=1e-9)

    def pop(self, u0, i, shape):
        return gumbel(self._uniform(shape))

    def accept(self, u0, shape):
        return self._uniform(shape)

    def rotation(self, u, chunk, shape):
        # i.i.d., so drawn in the memory order the pass reads ([R, EW, M]).
        M, R, EW = shape
        return gumbel(self._uniform((R, EW, M))).permute(2, 0, 1)


# -- constant-op inventory -----------------------------------------------------


class Inventory(NamedTuple):
    """Constant ops per replica sorted by ``(var, slot)``
    (``find_constants``, ``rvb.rs:1160-1187``)."""

    cvar: torch.Tensor  # i32[M, R] var of each sorted constant op (pad N)
    cpos: torch.Tensor  # i32[M, R] its slot (pad 0)
    cnext: torch.Tensor  # i32[M, R] sorted index of the cyclically next op on the var
    valid: torch.Tensor  # bool[M, R]
    ncount: torch.Tensor  # i32[R] constant ops
    has_const: torch.Tensor  # bool[R, N] vars with at least one constant op


def const_inventory(ops: OpString, model: BondModel) -> Inventory:
    """The constant-op inventory of ``ops``, one sort along imaginary time.
    RVB rewrites never move constant ops, so it holds for a whole sweep."""
    M, R = ops.bond.shape
    N = model.nvars
    occ = ops.bond >= 0
    b = ops.bond.clamp(min=0).long()
    is_const = model.is_constant[b] & occ
    var0 = model.bond_vars[:, 0].clamp(min=0)[b]
    p = torch.arange(M, dtype=torch.int32, device=b.device)[:, None]
    skey = torch.sort(torch.where(is_const, var0 * M + p, BIG), dim=0).values
    valid = skey < BIG
    cvar = torch.where(valid, skey // M, N)
    cpos = torch.where(valid, skey % M, 0)
    seg_start = torch.ones_like(valid)
    seg_start[1:] = cvar[1:] != cvar[:-1]
    group_start = torch.cummax(torch.where(seg_start, p, 0), dim=0).values
    nxt_same = torch.zeros_like(valid)
    nxt_same[:-1] = cvar[1:] == cvar[:-1]
    cnext = torch.where(nxt_same, (p + 1).clamp(max=M - 1), group_start)
    cnext = torch.where(valid, cnext, p)
    has_const = torch.zeros((R, N + 1), dtype=torch.bool, device=b.device)
    has_const.scatter_(1, cvar.T.long(), True)
    return Inventory(cvar, cpos, cnext, valid, valid.sum(dim=0, dtype=torch.int32),
                     has_const[:, :N])


def seg_bounds(cpos: torch.Tensor, cnext: torch.Tensor):
    """Segment ``(start, length)`` per sorted constant op; length 0 is the
    full circle (a single constant op on the var)."""
    M = cpos.shape[0]
    return cpos, (torch.gather(cpos, 0, cnext.long()) - cpos) % M


# -- cluster growth ------------------------------------------------------------


def build_clusters(inv: Inventory, tables: RvbTables, u_seed: torch.Tensor,
                   u_size: torch.Tensor,
                   pop_gumbels: Callable[[int], torch.Tensor]) -> torch.Tensor:
    """Weighted cluster growth (``build_cluster``, ``rvb.rs:1054-1123``) of
    ``G`` updates at once. ``u_seed, u_size f32[G, R]``; ``pop_gumbels(i)``
    gives pop iteration ``i``'s Gumbels ``f32[G, R, M + N]``. Returns
    ``popped bool[G, R, M + N]``: ``[0, M)`` sorted constant-op segments,
    ``[M, M + N)`` whole worldlines.

    Runs :data:`MAX_POPS` iterations with no host read: a lane whose
    clusters are done is a fixed point of the body. The weights add up in
    the JAX package's order, so the popped sets are bit-equal."""
    cvar, cpos, cnext, valid, ncount, has_const = inv
    M, R = cvar.shape
    N = has_const.shape[1]
    G = u_seed.shape[0]
    dev = cvar.device
    ridx = torch.arange(R, device=dev)[None, :]
    cvar_t, valid_t = cvar.T.contiguous(), valid.T.contiguous()
    seg_s, seg_ln = seg_bounds(cpos, cnext)
    seg_s_t, seg_ln_t = seg_s.T.contiguous(), seg_ln.T.contiguous()
    full_t = seg_ln_t == 0
    cnext_t = cnext.T.contiguous()
    src = torch.arange(M, dtype=torch.int32, device=dev)[:, None].expand(M, R)
    # Cyclic previous within var groups: cnext is a permutation.
    cprev_t = torch.empty_like(cnext).scatter_(0, cnext.long(), src).T.contiguous()

    # Seed: uniform over (constant ops) + (vars with no constant op).
    nzero = N - has_const.sum(dim=1, dtype=torch.int32)
    total = ncount + nzero
    pick = torch.minimum((u_seed * total).to(torch.int32), total - 1)  # [G, R]
    zcum = torch.cumsum((~has_const).to(torch.int32), dim=1, dtype=torch.int32)
    zvar = (zcum >= (pick - ncount + 1)[..., None]).to(torch.uint8).argmax(dim=-1)
    seed_elem = torch.where(pick < ncount, pick.long(), M + zvar)
    # Geometric pop count: k pops with probability 2^-k.
    remaining = (1 + contiguous_bits(u_size)).clamp(1, MAX_POPS)

    w = torch.zeros((G, R, M + N), dtype=torch.float32, device=dev)
    w.scatter_(2, seed_elem[..., None], 1.0)
    popped = torch.zeros((G, R, M + N), dtype=torch.bool, device=dev)
    for i in range(MAX_POPS):
        active = (remaining > 0) & (w.sum(dim=2) > 0)
        score = torch.where(w > 0, w.clamp(min=TINY).log_().add_(pop_gumbels(i)), NEG_INF)
        elem = score.argmax(dim=2)  # [G, R]
        at = torch.where(active, elem, 0)[..., None]
        popped.scatter_(2, at, popped.gather(2, at) | active[..., None])
        w.mul_(~popped)  # popped elements leave the boundary

        is_flip = elem < M
        c = torch.where(is_flip, elem, 0)
        v = torch.where(is_flip, cvar_t[ridx, c].long(), elem - M).clamp(max=N - 1)
        flip_on = is_flip & active
        # Same-var neighbours (rvb.rs:1085-1092), weight 1 each, in order.
        for nb_t in (cnext_t, cprev_t):
            tgt = torch.where(flip_on, nb_t[ridx, c].long(), M + N - 1)[..., None]
            w.scatter_add_(2, tgt, (flip_on[..., None] & ~popped.gather(2, tgt)).float())

        ps = torch.where(is_flip, seg_s_t[ridx, c], 0)[..., None]
        pln = torch.where(is_flip, seg_ln_t[ridx, c], 0)[..., None]
        # Lattice neighbours (rvb.rs:1095-1119), all D directions.
        ov = tables.neigh_var[v]  # [G, R, D]
        okd = (ov >= 0) & active[..., None]
        bm = tables.bond_mag[tables.neigh_bond[v].clamp(min=0)]
        ov_safe = torch.where(okd, ov, N - 1).long()
        # Neighbours with no constant op: their whole worldlines.
        zmask = okd & ~has_const[ridx[..., None], ov_safe]
        tgt = torch.where(zmask, M + ov_safe, M + N - 1)
        w.scatter_add_(2, tgt, torch.where(zmask & ~popped.gather(2, tgt), bm, 0.0))
        # Their overlapping segments, one direction at a time in JAX's order
        # (a segment matches at most the directions naming its var).
        add = valid_t & ~popped[..., :M] & (
            (((seg_s_t - ps) % M) < pln) | (((ps - seg_s_t) % M) < seg_ln_t)
            | (pln == 0) | full_t)
        ov_cmp = torch.where(okd, ov, -1)
        wseg = w[..., :M]
        for d in range(ov.shape[2]):
            hit = add & (cvar_t == ov_cmp[..., d, None])
            wseg.add_(torch.where(hit, bm[..., d, None], 0.0))
        remaining = remaining - active.to(torch.int32)
    return popped


def cluster_masks(popped: torch.Tensor, inv: Inventory):
    """``in0 bool[G, R, N]`` (cluster membership at p=0) and ``is_toggle
    bool[G, M, R]`` (slots whose constant op bounds the cluster) of popped
    element sets ``bool[G, R, M + N]`` (``rvb.rs:175-196``)."""
    cvar, cpos, cnext, valid = inv.cvar, inv.cpos, inv.cnext, inv.valid
    M, R = cvar.shape
    N = inv.has_const.shape[1]
    G = popped.shape[0]
    pf = popped[..., :M] & valid.T  # popped segments [G, R, M]
    s = cpos.T
    e = torch.gather(cpos, 0, cnext.long()).T
    ones = pf.to(torch.int32)
    # Toggle parity at the segments' start and end slots.
    cnt = torch.zeros((G, R, M + 1), dtype=torch.int32, device=cvar.device)
    cnt.scatter_add_(2, torch.where(pf, s, M).long(), ones)
    cnt.scatter_add_(2, torch.where(pf, e, M).long(), ones)
    is_toggle = (cnt[..., :M] % 2 == 1).transpose(1, 2).contiguous()
    # p=0 membership: wrapping segments (e <= s) and whole worldlines.
    wrap = pf & (e <= s)
    icnt = torch.zeros((G, R, N + 1), dtype=torch.int32, device=cvar.device)
    icnt.scatter_add_(2, torch.where(wrap, cvar.T, N).long(), wrap.to(torch.int32))
    return (icnt[..., :N] % 2 == 1) | popped[..., M:], is_toggle


def cand_width(M: int, N: int, tables: RvbTables) -> int:
    """Width ``A`` of the candidate edge list (:func:`update_columns`)."""
    return min(MAX_POPS, M + N) * tables.neigh_bond.shape[1]


def use_candidates(M: int, N: int, tables: RvbTables) -> bool:
    """Whether the edge axis is the candidate list: when narrower than all
    ``NE`` edges (``rvb.py:1297-1305``)."""
    return cand_width(M, N, tables) < tables.nedges


def set_width(N: int, tables: RvbTables) -> int:
    """Columns ``W`` of an update's variable set: the popped variables (at
    most :data:`MAX_POPS`) and their lattice neighbours."""
    return min(N, MAX_POPS * (tables.neigh_bond.shape[1] + 1))


class Columns(NamedTuple):
    """The variables one update's acceptance-and-mutation pass reads, per
    replica, as the columns of its parity counts (:func:`fused_pass`): with
    candidate edges the cluster's variables and their neighbours (``W =
    set_width``), otherwise every variable (``W = N``). Variables off the
    set map to column ``W``, pad edges to ``W + 1``. Leading dims: updates,
    then replicas."""

    lvars: torch.Tensor  # i64[..., R, W] variable of each column, N pads
    col: torch.Tensor  # i64[..., R, N + 1] column of each var (index N: off the legs)
    ends: torch.Tensor  # i64[..., R, 2 EW] columns of the edges' first, then second ends
    edge_id: torch.Tensor  # i32[..., R, EW] edge of each edge column, NE pads


def update_columns(popped: torch.Tensor, inv: Inventory, tables: RvbTables,
                   model: BondModel, use_cand: bool):
    """The edge axis and the variable columns of ``G`` updates' passes from
    their popped sets ``bool[G, R, M + N]``: ``(cand i32[G, A, R] or None,
    Columns)``. ``cand`` holds every edge incident to a popped variable,
    once each, in the JAX package's column order (the sorted list of the
    popped vars' edges with repeats padded by ``NE``, ``rvb.py:403-441``)."""
    M, R = inv.cvar.shape
    N = model.nvars
    ne = tables.nedges
    G = popped.shape[0]
    dev = popped.device
    bv = model.bond_vars[:ne].long()
    iota_n = torch.arange(N + 1, device=dev)
    if not use_cand:
        ends = torch.cat([bv[:, 0], bv[:, 1]])
        return None, Columns(iota_n[:N].expand(G, R, N), iota_n.expand(G, R, N + 1),
                             ends.expand(G, R, 2 * ne),
                             torch.arange(ne, dtype=torch.int32, device=dev).expand(G, R, ne))
    A = cand_width(M, N, tables)
    W = set_width(N, tables)
    pf = popped[..., :M] & inv.valid.T
    cnt = torch.zeros((G, R, N + 1), dtype=torch.int32, device=dev)
    cnt.scatter_add_(2, torch.where(pf, inv.cvar.T, N).long(), pf.to(torch.int32))
    cnt = cnt[..., :N] + popped[..., M:]  # popped copies of each var
    # Copies of each edge in the sorted list: one per popped copy of each
    # endpoint; its first copy sits after all smaller edges' copies.
    mult = cnt[..., bv[:, 0]] + cnt[..., bv[:, 1]]  # [G, R, NE]
    first = torch.cumsum(mult, dim=2) - mult
    ids = torch.arange(ne, dtype=torch.int32, device=dev).expand(G, R, ne)
    cand = torch.full((G, R, A + 1), ne, dtype=torch.int32, device=dev)
    cand.scatter_(2, torch.where(mult > 0, first, A), ids)
    cand = cand[..., :A]
    # The variable set: popped variables and the ends of their edges.
    cvalid = cand < ne
    ea, eb = bv[cand.long().clamp(max=ne - 1)].unbind(3)  # [G, R, A]
    inset = torch.zeros((G, R, N + 1), dtype=torch.bool, device=dev)
    inset[..., :N] = cnt > 0
    inset.scatter_(2, torch.where(cvalid, ea, N), True)
    inset.scatter_(2, torch.where(cvalid, eb, N), True)
    inset[..., N] = False
    col = torch.where(inset, torch.cumsum(inset, dim=2) - 1, W)
    lvars = torch.full((G, R, W + 1), N, dtype=torch.long, device=dev)
    lvars.scatter_(2, col, iota_n.expand(G, R, N + 1))
    ends = torch.where(cvalid.repeat(1, 1, 2), col.gather(2, torch.cat([ea, eb], dim=2)), W + 1)
    return (cand.transpose(1, 2).contiguous(),
            Columns(lvars[..., :W], col, ends, cand))


def at_columns(x: torch.Tensor, cols: Columns) -> torch.Tensor:
    """``x bool[R, N]`` at one update's columns, ``bool[R, W]``."""
    return x.gather(1, cols.lvars.clamp(max=x.shape[1] - 1))


# -- acceptance and mutation ---------------------------------------------------


class SlotConsts(NamedTuple):
    """Per-slot facts of a string that RVB updates keep (every op keeps its
    slot and its number of legs: rotations move edge ops to other edges),
    and the flat offsets into the parity counts of a pass over it with
    ``W`` columns. Replica-major ``[R, M]`` where noted."""

    occ: torch.Tensor  # bool[M, R]
    leg_ok: torch.Tensor  # bool[M, R, K]
    edge_op: torch.Tensor  # bool[M, R] ops on an edge bond (2 legs, bond < NE)
    with_legs: torch.Tensor  # bool[M, R] ops with at least one leg
    flip_code: torch.Tensor  # i64[M, R] XOR flipping every leg of a full_w index
    leg_var: torch.Tensor  # i64[NB + 1, K] var of each leg, N off the legs; row -1: identity
    off: torch.Tensor  # i64[R, M] flat offset of (r, column 0, row m + 1) of the counts
    off_incl: torch.Tensor  # i64[R, M] the same in the cluster-mask half
    off_dump: torch.Tensor  # i64[R, M] the same at the dump column W


def slot_consts(ops: OpString, model: BondModel, tables: RvbTables, W: int) -> SlotConsts:
    """The :class:`SlotConsts` of ``ops`` for passes with ``W`` columns."""
    M, R = ops.bond.shape
    K = ops.max_legs
    N = model.nvars
    dev = ops.bond.device
    occ = ops.bond >= 0
    vars_ = model.bond_vars[ops.bond.clamp(min=0).long()]
    leg_ok = (vars_ >= 0) & occ[..., None]
    arity = leg_ok.sum(dim=2)
    nsub = 1 << K
    legmask = torch.arange(K, device=dev)[:, None, None] < arity[None]
    leg_var = torch.cat([torch.where(model.bond_vars >= 0, model.bond_vars, N),
                         torch.full((1, K), N, dtype=torch.int32, device=dev)]).long()
    Wc, T = W + 2, M + 1
    off = (torch.arange(R, device=dev) * (Wc * T))[:, None] + torch.arange(1, T, device=dev)
    return SlotConsts(occ, leg_ok, occ & (arity == 2) & (ops.bond < tables.nedges),
                      occ & (arity > 0), substate_index(legmask).long() * (nsub + 1),
                      leg_var, off, off + R * Wc * T, off + W * T)


def fused_pass(ops: OpString, base_sub: torch.Tensor, base_incl: torch.Tensor,
               model: BondModel, tables: RvbTables, cols: Columns,
               is_toggle: torch.Tensor, gumbels: torch.Tensor, want_carry: bool = False,
               consts: SlotConsts | None = None):
    """Acceptance and the assume-accepted rewrite of one update, all slots
    at once (``_fused_vectorized``, ``rvb.py:913-1201``).

    ``base_sub, base_incl bool[R, W]``: the worldline state and the cluster
    mask at p=0 on the update's columns (:func:`at_columns` of the state
    and of ``in0``); ``is_toggle bool[M, R]``; ``gumbels f32[M, R, EW]``
    the rotation noise over the edge columns; ``consts`` the string's
    :func:`slot_consts` (made here when not given). Returns ``(p_acc
    f32[R], bond, inputs, outputs)`` of the candidate string; with
    ``want_carry`` the raw log acceptance in place of ``p_acc`` and, after
    the arrays, the worldline state and cluster mask past the last slot on
    the columns (the chunked pass's carry).

    Worldline state and cluster mask just below every slot are parities of
    event counts ``uint8[2R, W + 2, M + 1]``: slot m's events count in row
    m + 1, p=0 in row 0, one cumsum along the slots (uint8 wraps, which
    keeps parity). Flips of variables off the set, and the slots with no
    event, count in column ``W`` of the worldline half; the cluster mask
    changes only on the set, so its column ``W`` stays 0 (reads of legs off
    the set), and column ``W + 1`` (pad edges) stays 0 in both halves."""
    M, R = ops.bond.shape
    K = ops.max_legs
    ne = tables.nedges
    W = cols.lvars.shape[1]
    EW = cols.edge_id.shape[1]
    Wc, T = W + 2, M + 1
    dev = ops.bond.device
    c = slot_consts(ops, model, tables, W) if consts is None else consts
    bond = ops.bond.long()
    vidx = c.leg_var[bond.T]  # [R, M, K]
    ins, outs = ops.inputs.permute(1, 2, 0), ops.outputs.permute(1, 2, 0)
    flips = ins != outs  # [M, R, K]; padded legs never differ
    is_diag = ~flips.any(dim=2)
    is_cb = is_toggle & c.occ
    cT = cols.col.gather(1, vidx.reshape(R, -1)).view(R, M, K) * T  # column offsets

    par = torch.zeros(2 * R * Wc * T, dtype=torch.uint8, device=dev)
    par3 = par.view(2 * R, Wc, T)
    par3[:R, :W, 0] = base_sub
    par3[R:, :W, 0] = base_incl
    par.index_fill_(0, torch.where(flips.transpose(0, 1), c.off[..., None] + cT,
                                   c.off_dump[..., None]).reshape(-1), 1)
    par.index_fill_(0, torch.where(is_cb.T, c.off_incl + cT[..., 0], c.off_dump).reshape(-1), 1)
    par3.cumsum_(dim=2)

    # Cluster mask at each op's legs (row m: events of the slots before m).
    incl_legs = par[(c.off_incl - 1)[..., None] + cT].bitwise_and_(1).view(torch.bool)
    incl_legs = incl_legs.transpose(0, 1)  # [M, R, K]
    # Edge ends' rows, [substate | cluster mask, first | second end, R, EW, M].
    rows = torch.arange(2 * R, device=dev).view(2, 1, R, 1)
    ends = cols.ends.view(R, 2, EW).transpose(0, 1)
    bits = par3[rows, ends[None], :M].bitwise_and_(1).view(torch.bool)
    sa, sb, ia, ib = bits[0, 0], bits[0, 1], bits[1, 0], bits[1, 1]
    bdry_e = ia ^ ib
    fa, fb = sa ^ ia, sb ^ ib  # the flipped state
    dw = model.diag_w[cols.edge_id.long().clamp(max=ne - 1)][..., None]  # [R, EW, 4, 1]

    def edge_w(xa, xb):  # diag_w[e, xa + 2 xb] on the boundary, else 0
        w = torch.where(xb, torch.where(xa, dw[:, :, 3], dw[:, :, 2]),
                        torch.where(xa, dw[:, :, 1], dw[:, :, 0]))
        return torch.where(bdry_e, w, 0.0)

    w_aft = edge_w(fa, fb)  # [R, EW, M]
    wb_tot = edge_w(sa, sb).sum(dim=1).T  # [M, R]
    wa_tot = w_aft.sum(dim=1).T

    bdry = incl_legs[..., 0] ^ (incl_legs[..., 1] if K > 1 else incl_legs[..., 0])
    is_bo = c.edge_op & is_diag & bdry
    completely_in = (incl_legs | ~c.leg_ok).all(dim=2) & c.with_legs

    # Acceptance (rvb.rs:845-852, :873-879): boundary ops contribute the
    # boundary weights' ratio, ops inside the cluster their flip ratio; a
    # zero-weight rewrite gets an exact -inf, so a u = 0 draw cannot accept.
    nsub = 1 << K
    code = bond * (nsub * nsub) + substate_index(ops.inputs) * nsub + substate_index(ops.outputs)
    fw = model.full_w.reshape(-1)
    num = torch.where(is_bo, wa_tot, fw[code ^ c.flip_code])
    den = torch.where(is_bo, wb_tot, fw[code])
    log_ratio = (torch.where(num > 0, num.clamp(min=TINY).log(), NEG_INF)
                 - den.clamp(min=TINY).log())
    logm = torch.where(is_bo | completely_in, log_ratio, 0.0).sum(dim=0)

    # Candidate rewrite, assumed accepted (rvb.rs:294-615): rotation by
    # Gumbel-argmax over the after-flip boundary weights.
    score = torch.where(w_aft > 0, w_aft.clamp_(min=TINY).log_().add_(gumbels.permute(1, 2, 0)),
                        NEG_INF)
    b_loc = score.argmax(dim=1, keepdim=True)  # [R, 1, M]
    b_new = cols.edge_id[..., None].expand(R, EW, M).gather(1, b_loc)[:, 0].T
    rot = torch.stack([fa.gather(1, b_loc)[:, 0].T, fb.gather(1, b_loc)[:, 0].T])
    if K > 2:
        rot = torch.cat([rot, rot.new_zeros((K - 2, M, R))])
    do_rot = is_bo
    new_bond = torch.where(do_rot, b_new, ops.bond)
    new_in = torch.where(do_rot, rot, ops.inputs)
    new_out = torch.where(do_rot, rot, ops.outputs)
    # Cluster-bounding constant ops: in ^= c, out ^= !c (rvb.rs:446-476).
    c_pre = incl_legs[..., 0]
    do_cb = is_cb & ~do_rot
    new_in[0] ^= do_cb & c_pre
    new_out[0] ^= do_cb & ~c_pre
    # Interior ops flip symmetrically (rvb.rs:513-531).
    flip = (completely_in & ~do_rot & ~do_cb)[None] & c.leg_ok.permute(2, 0, 1)
    new_in ^= flip
    new_out ^= flip
    if want_carry:
        end = par3[:, :W, M].bitwise_and(1).view(torch.bool)
        return logm, new_bond, new_in, new_out, end[:R], end[R:]
    return logm.exp().clamp(max=1.0), new_bond, new_in, new_out


def fused_chunked(ops: OpString, base_sub: torch.Tensor, base_incl: torch.Tensor,
                  model: BondModel, tables: RvbTables, cols: Columns,
                  is_toggle: torch.Tensor, rotation: Callable[[int, tuple], torch.Tensor],
                  mc: int):
    """:func:`fused_pass` over chunks of ``mc`` slots (``_fused_chunked``,
    ``rvb.py:1204-1279``), carrying the worldline state, the cluster mask
    and the log acceptance from chunk to chunk. ``rotation(c, shape)``
    gives chunk ``c``'s Gumbels ``f32[mc, R, EW]``; the last chunk uses its
    first rows. Discrete outputs equal the one-shot pass's on the same
    noise."""
    M, R = ops.bond.shape
    EW = cols.edge_id.shape[1]
    sub, incl = base_sub, base_incl
    logm = torch.zeros((R,), dtype=torch.float32, device=ops.bond.device)
    nb = torch.empty_like(ops.bond)
    ni, no = torch.empty_like(ops.inputs), torch.empty_like(ops.outputs)
    for c, lo in enumerate(range(0, M, mc)):
        hi = min(lo + mc, M)
        chunk = OpString(ops.bond[lo:hi], ops.inputs[:, lo:hi], ops.outputs[:, lo:hi])
        lg, nb[lo:hi], ni[:, lo:hi], no[:, lo:hi], sub, incl = fused_pass(
            chunk, sub, incl, model, tables, cols, is_toggle[lo:hi],
            rotation(c, (mc, R, EW))[:hi - lo], want_carry=True)
        logm = logm + lg
    return logm.exp().clamp(max=1.0), nb, ni, no


def fused_chunk_size(M: int, R: int, ew: int, K: int, W: int) -> int | None:
    """Chunk size of the acceptance-and-mutation pass by footprint, or
    ``None`` when the one-shot pass fits :data:`VEC_MAX_ELEMS`."""
    per_slot = R * max(ew, K * (W + 2), 1)
    if M * per_slot <= VEC_MAX_ELEMS:
        return None
    return min(M, max(128, VEC_MAX_ELEMS // per_slot // 128 * 128))


# -- the sweep -----------------------------------------------------------------


def compact_ops(ops: OpString, mc: int):
    """Pack the occupied slots into a time-ordered prefix of ``mc`` rows
    (``rvb.py:1394-1434``). RVB never inserts or removes ops, so a sweep
    can run on the prefix. Returns ``(ops_c, tail, sk)``: the compact
    string, the rows past ``mc`` as ``(bond, inputs..., outputs...)``, and
    the sorted keys ``i32[M, R]`` (``sk % M`` is each row's slot). A
    replica with more than ``mc`` ops gets a truncated prefix."""
    M, R = ops.bond.shape
    K = ops.max_legs
    iota = torch.arange(M, dtype=torch.int32, device=ops.bond.device)[:, None]
    sk, order = torch.sort(torch.where(ops.bond >= 0, iota, iota + M), dim=0)
    bond = ops.bond.gather(0, order)
    legs = torch.cat([ops.inputs, ops.outputs]).gather(1, order.expand(2 * K, M, R))
    ops_c = OpString(bond[:mc], legs[:K, :mc], legs[K:, :mc])
    tail = (bond[mc:], *legs[:, mc:].unbind(0))
    return ops_c, tail, sk


def uncompact_ops(ops_c: OpString, tail, sk: torch.Tensor) -> OpString:
    """Inverse of :func:`compact_ops` after rewrites of the prefix: each
    row back to its slot."""
    M, R = sk.shape
    K = ops_c.max_legs
    orig = torch.where(sk >= M, sk - M, sk).long()
    bond = torch.cat([ops_c.bond, tail[0]])
    legs = torch.cat([torch.cat([ops_c.inputs, ops_c.outputs]),
                      torch.stack(tail[1:])], dim=1)
    bond = torch.empty_like(bond).scatter_(0, orig, bond)
    legs = torch.empty_like(legs).scatter_(1, orig.expand(2 * K, M, R), legs)
    return OpString(bond, legs[:K], legs[K:])


def rvb_sweep(ops: OpString, state: torch.Tensor, draws: RvbDraws, model: BondModel,
              tables: RvbTables, n_updates: int, compact_cutoff: int | None = None):
    """``n_updates`` sequential RVB updates (the reference runs
    ``(nvars + 1) / 2`` per timestep, ``qmc_ising.rs:705-710``). Returns
    ``(ops, state, successes i32[R])``.

    ``compact_cutoff`` runs the sweep on the occupied-slot prefix
    (:func:`compact_ops`). A replica with more ops than that keeps its
    string and state for this sweep, with 0 successes, decided on the
    device: RVB never changes the op count, so the skip is unbiased."""
    M, R = ops.bond.shape
    if compact_cutoff is None or compact_cutoff >= M:
        return _rvb_sweep_impl(ops, state, draws, model, tables, n_updates)
    fits = (ops.bond >= 0).sum(dim=0) <= compact_cutoff  # [R]
    ops_c, tail, sk = compact_ops(ops, compact_cutoff)
    ops_c, new_state, succ = _rvb_sweep_impl(ops_c, state, draws, model, tables,
                                             n_updates)
    unc = uncompact_ops(ops_c, tail, sk)
    return (OpString(torch.where(fits, unc.bond, ops.bond),
                     torch.where(fits, unc.inputs, ops.inputs),
                     torch.where(fits, unc.outputs, ops.outputs)),
            torch.where(fits[:, None], new_state, state),
            torch.where(fits, succ, 0))


def rvb_update_once(ops: OpString, state: torch.Tensor, draws: RvbDraws, model: BondModel,
                    tables: RvbTables):
    """One RVB update of every replica on ``draws`` (of one update):
    :func:`rvb_sweep` with ``n_updates = 1`` (the JAX package's
    ``rvb_update_once``, ``isingmontecarlo_tpu/sse/rvb.py:1328``). Returns
    ``(ops, state, accepted bool[R])``."""
    ops, state, succ = rvb_sweep(ops, state, draws, model, tables, 1)
    return ops, state, succ > 0


def _rvb_sweep_impl(ops, state, draws: RvbDraws, model, tables, n_updates):
    """The sweep body. One inventory; every cluster build, mask and column
    set up front, batched under :data:`BUILD_MAX_ELEMS` (builds read only
    the inventory, which the updates never change); then the updates'
    passes in order."""
    M, R = ops.bond.shape
    N = model.nvars
    D = tables.neigh_bond.shape[1]
    inv = const_inventory(ops, model)
    use_cand = use_candidates(M, N, tables)
    G = max(1, min(n_updates, BUILD_MAX_ELEMS // (R * max(M * D, M + N))))
    in0s, togs, colss = [], [], []
    for u0 in range(0, n_updates, G):
        g = min(G, n_updates - u0)
        popped = build_clusters(
            inv, tables, draws.seed(u0, (g, R)), draws.size(u0, (g, R)),
            lambda i, u0=u0, g=g: draws.pop(u0, i, (g, R, M + N)))
        in0, tog = cluster_masks(popped, inv)
        in0s.append(in0)
        togs.append(tog)
        colss.append(update_columns(popped, inv, tables, model, use_cand)[1])
    in0, tog = torch.cat(in0s), torch.cat(togs)
    cols = Columns(*(torch.cat(x) for x in zip(*colss)))
    lvars = cols.lvars.clamp(max=N - 1)
    in0_cols = in0.gather(2, lvars)
    u_acc = draws.accept(0, (n_updates, R))
    EW = cols.edge_id.shape[2]
    W = cols.lvars.shape[2]
    mc = fused_chunk_size(M, R, EW, ops.max_legs, W)
    consts = slot_consts(ops, model, tables, W) if mc is None else None
    succ = torch.zeros((R,), dtype=torch.int32, device=ops.bond.device)
    for u in range(n_updates):
        cols_u = Columns(*(x[u] for x in cols))
        args = (ops, state.gather(1, lvars[u]), in0_cols[u], model, tables, cols_u, tog[u])
        if mc is None:
            p_acc, nb, ni, no = fused_pass(*args, draws.rotation(u, None, (M, R, EW)),
                                           consts=consts)
        else:
            p_acc, nb, ni, no = fused_chunked(
                *args, lambda c, shape, u=u: draws.rotation(u, c, shape), mc)
        # Accepted replicas take the candidate string and flip the cluster at p=0.
        accept = u_acc[u] < p_acc
        ops = OpString(torch.where(accept, nb, ops.bond), torch.where(accept, ni, ops.inputs),
                       torch.where(accept, no, ops.outputs))
        state = state ^ (in0[u] & accept[:, None])
        succ += accept
    return ops, state, succ


def rvb_footprint(M: int, R: int, N: int, tables: RvbTables, n_updates: int,
                  K: int = 2) -> dict:
    """Bytes of the largest tensors of one RVB sweep at these shapes: the
    parity counts and an f32 edge-axis tensor of one pass (or chunk), a
    ``[G, R, M + N]`` f32 tensor of a batch of builds, and the path taken."""
    D = tables.neigh_bond.shape[1]
    cand = use_candidates(M, N, tables)
    ew = cand_width(M, N, tables) if cand else tables.nedges
    W = set_width(N, tables) if cand else N
    mc = fused_chunk_size(M, R, ew, K, W)
    rows = M if mc is None else mc
    G = max(1, min(n_updates, BUILD_MAX_ELEMS // (R * max(M * D, M + N))))
    return {"M": M, "R": R, "N": N, "edge_width": ew, "columns": W, "chunk": mc,
            "parity_bytes": 2 * R * (W + 2) * (rows + 1),
            "edge_f32_bytes": 4 * rows * R * ew,
            "build_batch": G, "build_f32_bytes": 4 * G * R * (M + N)}
