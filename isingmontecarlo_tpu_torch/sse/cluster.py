"""SSE cluster update (port of ``isingmontecarlo_tpu/sse/cluster.py``;
reference ``src/sse/qmc_traits/cluster.rs``).

Clusters are built over op sides: constant single-variable ops (transverse
field ops) are cluster edges whose two sides belong to different clusters
(``cluster.rs:276-286``); every other op's sides and legs are one cluster,
and worldline segments join an op's output side to the next op on the same
variable (periodic in imaginary time). Each cluster flips with probability
1/2 times the product of its ops' weight ratios (``cluster.rs:36-172``), and
the p=0 state is re-read from the first op on each variable.

Each maximal worldline run between cluster-edge ops is one supernode
(:func:`segment_graph`); components of the contracted graph are labelled by
hook-and-compress union-find (:func:`hook_compress_labels`). Kernel K4 does
the hooks (``ops.hook_min``), the pointer jumps (``ops.pointer_jump``) and
the per-replica gathers on label tables (``ops.take0``).

Like the JAX package, label propagation yields one cluster per connected
component even when no constant op exists, where the reference treats the
whole string as one cluster (``cluster.rs:98-107``): equally valid and more
ergodic.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from isingmontecarlo_tpu_torch import profiling
from isingmontecarlo_tpu_torch.ops.take_kernel import hook_min, pointer_jump, take0
from isingmontecarlo_tpu_torch.sse.graphs import run_eager
from isingmontecarlo_tpu_torch.sse.model import BondModel
from isingmontecarlo_tpu_torch.sse.opstring import (
    SORT_BIG, OpString, op_vars, sorted_legs, substate_index,
)
from isingmontecarlo_tpu_torch.sse.tables import bond_fetch, fetch_xor

# Pointer jumps per hook round. Root ids depend on this schedule, and the
# cluster uniforms are indexed by root id, so it must equal the JAX
# package's _N_COMPRESS for the two to draw the same flips.
N_COMPRESS = 2


class SegGraph(NamedTuple):
    """Segment-contracted label problem (see :func:`segment_graph`)."""

    seg_in: torch.Tensor  # i32[M, R] in-side segment id per op slot
    seg_out: torch.Tensor  # i32[M, R]
    u: torch.Tensor  # i32[E, R] edge endpoints (dump = S - 1)
    v: torch.Tensor  # i32[E, R]
    nseg: torch.Tensor  # i32[R] per-replica segment count
    head_f: torch.Tensor  # i32[N, R] flat leg index of each var's first leg
    #                        (K*M where the var has no legs)
    S: int  # label-space size


def is_valid_cluster_edge(is_constant, nvars):
    """Whether an op can bound a cluster in imaginary time: constant
    single-variable ops only (``is_valid_cluster_edge``,
    ``cluster.rs:280-286``). Takes numbers or tensors."""
    return torch.as_tensor(is_constant, dtype=torch.bool) & (torch.as_tensor(nvars) == 1)


def segment_graph(ops: OpString, model: BondModel) -> SegGraph:
    """Contract worldline runs between cluster-edge ops into supernodes.

    Segment ids are break-count prefix sums over the legs sorted by
    ``(variable, slot)`` (a new segment starts at each worldline head and
    between the two sides of an edge op). Graph edges: one per multi-leg op
    chaining its legs' in-side segments, plus one periodic wrap edge per
    variable (head in-segment to tail out-segment). ``S = M + N + 1`` with a
    trailing dump row for invalid slots."""
    M, R = ops.bond.shape
    K = ops.max_legs
    KM = K * M
    N = model.nvars
    S = M + N + 1
    dev = ops.bond.device

    valid_op = ops.bond >= 0
    b = ops.bond.clamp(min=0)
    vars_kmr = op_vars(ops, model)
    edge_t = model.is_constant & (model.arity() == 1)  # cluster.rs:276-286
    is_edge = (bond_fetch(edge_t, b) == 1) & valid_op
    skey, order, _ = sorted_legs(ops, model)
    edge_s = torch.gather(is_edge.repeat(K, 1), 0, order)

    valid_j = skey < SORT_BIG
    svar = torch.where(valid_j, skey // M, -1)
    seg_start = torch.ones_like(valid_j)
    seg_start[1:] = svar[1:] != svar[:-1]
    seg_end = torch.ones_like(valid_j)
    seg_end[:-1] = svar[:-1] != svar[1:]
    edge_i = (edge_s & valid_j).to(torch.int32)

    # In the interleaved (in, out) break sequence the in element's id is
    # c - edge - 1 and the out element's c - 1, with c the inclusive cumsum
    # of (group head + edge op). The scan runs along the innermost axis of
    # the transpose: PyTorch's CUDA scan along an outer axis of an int
    # tensor took 2.6 ms at the 32x32 shape [13856, 256].
    breaks = ((seg_start & valid_j).to(torch.int32) + edge_i).T.contiguous()
    c = torch.cumsum(breaks, dim=1, dtype=torch.int32).T
    seg_in_j = torch.where(valid_j, c - edge_i - 1, S - 1)
    seg_out_j = torch.where(valid_j, c - 1, S - 1)
    nseg = c[-1].clone()

    # Back to flat leg space: sorted row j belongs at flat row order[j].
    seg_in_k = torch.empty_like(seg_in_j).scatter_(0, order, seg_in_j).reshape(K, M, R)
    seg_out_k = torch.empty_like(seg_out_j).scatter_(0, order, seg_out_j).reshape(K, M, R)
    seg_in = torch.where(valid_op, seg_in_k[0], S - 1)
    seg_out = torch.where(valid_op, seg_out_k[0], S - 1)

    us, vs = [], []
    for l in range(K - 1):
        ok = (vars_kmr[l] >= 0) & (vars_kmr[l + 1] >= 0)
        us.append(torch.where(ok, seg_in_k[l], S - 1))
        vs.append(torch.where(ok, seg_in_k[l + 1], S - 1))

    # Wrap edges and first-leg indices: each variable has one head and one
    # tail row in sorted space; every other row lands in dump row N.
    head = seg_start & valid_j
    tail = seg_end & valid_j
    row_h = torch.where(head, svar, N).long()
    row_t = torch.where(tail, svar, N).long()

    def place(rows, vals, fill):
        out = torch.full((N + 1, R), fill, dtype=torch.int32, device=dev)
        return out.scatter_(0, rows, vals)[:N]

    uw = place(row_h, seg_in_j, S - 1)
    vw = place(row_t, seg_out_j, S - 1)
    head_f = place(row_h, order.to(torch.int32), KM)
    return SegGraph(
        seg_in=seg_in, seg_out=seg_out,
        u=torch.cat(us + [uw]), v=torch.cat(vs + [vw]),
        nseg=nseg, head_f=head_f, S=S,
    )


def label_init(S: int, R: int, device: torch.device):
    """The hook-and-compress rounds' start: the identity labels ``P
    i32[S, R]`` and the round flag ``i32[1]`` at 0."""
    P = torch.arange(S, dtype=torch.int32, device=device)[:, None].repeat(1, R)
    return P, torch.zeros(1, dtype=torch.int32, device=device)


def hook_rounds(P: torch.Tensor, flag: torch.Tensor, u: torch.Tensor,
                v: torch.Tensor) -> torch.Tensor:
    """Hook-and-compress rounds over the edge list ``(u, v) i32[E, R]`` from
    :func:`label_init`'s ``(P, flag)``: each round hooks ``min(P[u],
    P[v])`` onto the row of the larger endpoint label (``P[max] <- min``,
    :func:`ops.hook_min`), then pointer-jumps ``P <- P[P]``
    :data:`N_COMPRESS` times in one launch (:func:`ops.pointer_jump`),
    until a round changes nothing. Returns ``P``: every segment of a
    component gets the component's minimum id (``P[x] <= x`` and labels
    never leave the component, so the minimum is its own root).

    The fixpoint test reads one flag to the host per round: the jump of
    round ``k`` sets the flag to ``k`` where the round changed a label, so
    the flag is zeroed once, not every round."""
    rounds = 0
    while True:
        rounds += 1
        # Round 1 from the identity: the endpoint labels are (u, v) themselves.
        Pn = hook_min(P, u, v, first=rounds == 1)
        P, _ = pointer_jump(Pn, P, N_COMPRESS, flag, rounds)
        profiling.count("host_reads.labels")
        if int(flag) != rounds:
            return P


def hook_compress_labels(u: torch.Tensor, v: torch.Tensor, S: int) -> torch.Tensor:
    """Connected components over the segment edge list ``(u, v) i32[E, R]``
    by hook-and-compress (:func:`hook_rounds`); returns ``P i32[S, R]``."""
    return hook_rounds(*label_init(S, u.shape[1], u.device), u, v)


def label_plan(S: int, E: int, label_cap: int | None = None,
               edge_cap: int | None = None) -> tuple[int, int] | None:
    """The ``(C, CE)`` rows and edges of the compacted label problem of
    ``S`` rows and ``E`` edges, or None where it would not be smaller:
    the JAX package's ``_compact_dispatch`` defaults and rule, since the
    label-space size is the shape of the cluster uniforms."""
    C = label_cap or max(256, 16 * (-(-(S // 2) // 16)))
    CE = min(edge_cap or max(256, 16 * (-(-(2 * E // 3) // 16))), E)
    return None if C + 64 >= S else (C, CE)


def fits_flag(sg: SegGraph, C: int, CE: int) -> torch.Tensor:
    """``bool[]``: every replica's segments fit ``C - 1`` rows and its
    real edges ``CE`` (the dump row ``C - 1`` takes what is past them)."""
    return (sg.nseg.max() <= C - 1) & ((sg.u != sg.S - 1).sum(0).max() <= CE)


def compact_problem(sg: SegGraph, C: int, CE: int):
    """The compacted label problem where :func:`fits_flag` holds: ``(uc,
    vc)`` the first ``CE`` real edges (a stable sort puts them first) and
    each op slot's in- and out-side rows, clamped to ``C - 1``, and
    :func:`label_init`'s ``(P, flag)`` for ``C`` rows."""
    cdump = C - 1
    not_edge = sg.u == sg.S - 1
    _, perm = torch.sort(not_edge.to(torch.int32), dim=0, stable=True)
    uc = torch.gather(sg.u, 0, perm[:CE]).clamp(max=cdump)
    vc = torch.gather(sg.v, 0, perm[:CE]).clamp(max=cdump)
    return (uc, vc, sg.seg_in.clamp(max=cdump), sg.seg_out.clamp(max=cdump),
            *label_init(C, sg.u.shape[1], sg.u.device))


def segment_stage(ops: OpString, model: BondModel, label_cap: int | None = None,
                  edge_cap: int | None = None):
    """The timestep's segment-graph stage: ``(sg, has_op, fits)``, the
    :func:`segment_graph`, whether each variable carries an op ``bool[R,
    N]`` (a variable has ops iff its worldline has a head leg), and
    :func:`fits_flag` of the compacted label problem of the caps, or None
    where :func:`label_plan` labels at full size."""
    sg = segment_graph(ops, model)
    has_op = (sg.head_f < ops.max_legs * ops.bond.shape[0]).T
    plan = label_plan(sg.S, sg.u.shape[0], label_cap, edge_cap)
    return sg, has_op, None if plan is None else fits_flag(sg, *plan)


def compact_labels(sg: SegGraph, label_cap: int | None = None,
                   edge_cap: int | None = None, skip_overflow: bool = False,
                   fits: torch.Tensor | None = None, stage=run_eager):
    """Label the components of the segment graph: on a compacted problem of
    ``label_cap`` rows and ``edge_cap`` edges when every replica fits, else
    at full size ``S`` (or return None when ``skip_overflow``: the sweep's
    cap-holding callers skip the cluster update instead). Returns ``(W,
    seg_in, seg_out, SL)``: the labels ``i32[SL, R]`` and each op slot's
    in- and out-side rows in them.

    Same defaults and branch rule as the JAX package's ``_compact_dispatch``
    (:func:`label_plan`). The ``fits`` test is a host read, of ``fits`` where
    the caller computed it. ``stage`` runs the start of the rounds
    (:func:`compact_problem`, :func:`label_init`; :class:`graphs.Stager`)."""
    with profiling.span("sse.labels"):
        R = sg.u.shape[1]
        plan = label_plan(sg.S, sg.u.shape[0], label_cap, edge_cap)
        if plan is not None:
            C, CE = plan
            if fits is None:
                fits = fits_flag(sg, C, CE)
            profiling.count("host_reads.fits")
            if bool(fits):
                uc, vc, s_in, s_out, P, flag = stage("compact", compact_problem, sg, C, CE)
                return hook_rounds(P, flag, uc, vc), s_in, s_out, C
            if skip_overflow:
                return None
        P, flag = stage("label_init", label_init, sg.S, R, sg.u.device)
        return hook_rounds(P, flag, sg.u, sg.v), sg.seg_in, sg.seg_out, sg.S


def cluster_labels(ops: OpString, model: BondModel, label_cap: int | None = None,
                   edge_cap: int | None = None) -> torch.Tensor:
    """Min-label clusters over the op sides, ``i32[2M, R]`` (node ``2p`` the
    input side of slot ``p``, ``2p + 1`` its output side), through the
    contracted segment graph (``isingmontecarlo_tpu/sse/cluster.py:586``).
    The values are component-minimum segment ids: equal labels define the
    partition. Invalid slots share the dump segment's label."""
    sg = segment_graph(ops, model)
    M, R = ops.bond.shape
    W, s_in, s_out, _ = compact_labels(sg, label_cap, edge_cap)
    lab_in, lab_out = take0(W, s_in.contiguous(), s_out.contiguous())
    return torch.stack([lab_in, lab_out], dim=1).reshape(2 * M, R)


def root_flip_prob(lab_in, lab_out, valid_op, w_cur, w_flip, SL: int,
                   prob: float):
    """Per-root flip probability ``min(prob * prod ratio, 1)`` and frozen
    flag, ``f32/bool[SL, R]``, over the ops whose two sides share the root
    (``cluster.rs:120-128``); an op whose flipped weight is 0 freezes its
    cluster. The log-ratio sums are a scatter-add, whose order (and so the
    last ulp) is not fixed on the GPU."""
    R = lab_in.shape[1]
    both_sides = valid_op & (lab_in == lab_out)
    ratio = torch.where(both_sides, w_flip / w_cur.clamp(min=1e-30), 1.0)
    frozen = both_sides & (w_flip <= 0.0)
    logr = torch.where(both_sides, torch.log(ratio.clamp(min=1e-30)), 0.0)
    lab = lab_in.long()
    acc_logr = torch.zeros((SL, R), dtype=torch.float32,
                           device=logr.device).scatter_add_(0, lab, logr)
    acc_frozen = torch.zeros((SL, R), dtype=torch.int32,
                             device=logr.device).scatter_add_(
        0, lab, frozen.to(torch.int32)) > 0
    return (prob * torch.exp(acc_logr)).clamp(max=1.0), acc_frozen


def cluster_update(ops: OpString, state: torch.Tensor, draw_uniform: Callable,
                   model: BondModel, prob: float = 0.5,
                   label_cap: int | None = None, edge_cap: int | None = None,
                   bond_xor: torch.Tensor | None = None):
    """Flip every spacetime cluster with probability ``prob`` times its
    weight ratio (``flip_each_cluster_rng``, ``cluster.rs:18-172``): build
    the :func:`segment_graph` and run :func:`cluster_update_impl` on it.
    Returns ``(ops, state)``."""
    sg = segment_graph(ops, model)
    return cluster_update_impl(ops, state, draw_uniform, model, prob, label_cap,
                               edge_cap, sg, bond_xor)


def cluster_update_impl(ops: OpString, state: torch.Tensor,
                        draw_uniform: Callable, model: BondModel,
                        prob: float, label_cap: int | None,
                        edge_cap: int | None, sg: SegGraph,
                        bond_xor: torch.Tensor | None = None,
                        fits: torch.Tensor | None = None, stage=run_eager):
    """Flip every cluster with probability ``prob`` times its weight ratio.

    ``draw_uniform(shape)`` returns the per-root uniforms ``f32[SL, R]``
    (the JAX package draws ``uniform(fold_in(key, 0), (SL, R))``). With
    ``label_cap`` set, a cap overflow skips the update (all-False flips),
    as in the JAX sweep path. ``bond_xor i32[R, NB]`` looks each replica's
    weights up under its sign pattern (``diagonal.py``); the spins stay
    physical, and the XOR commutes with the cluster's leg flip. ``fits`` and
    ``stage`` go to :func:`compact_labels`; ``stage`` also runs the flips
    (:func:`cluster_flips` or :func:`noop_flips`). Returns ``(ops,
    state)``."""
    R = ops.bond.shape[1]
    labels = compact_labels(sg, label_cap, edge_cap, skip_overflow=label_cap is not None,
                            fits=fits, stage=stage)
    with profiling.span("sse.flips"):
        if labels is None:
            return stage("flips_noop", noop_flips, ops, state, sg.head_f, model)
        W, s_in, s_out, SL = labels
        return stage("flips", cluster_flips, ops, state, sg.head_f, W, s_in, s_out,
                     draw_uniform((SL, R)), model, prob, bond_xor)


def cluster_flips(ops: OpString, state: torch.Tensor, head_f: torch.Tensor,
                  W: torch.Tensor, s_in: torch.Tensor, s_out: torch.Tensor,
                  u_root: torch.Tensor, model: BondModel, prob: float,
                  bond_xor: torch.Tensor | None = None):
    """The flips of the labelled clusters ``W i32[SL, R]`` (each op slot's
    sides at rows ``s_in``, ``s_out``): a root flips where its uniform
    ``u_root f32[SL, R]`` is below :func:`root_flip_prob`'s and its cluster
    is not frozen. Returns ``(ops, state)`` (:func:`apply_flips`)."""
    SL = W.shape[0]
    valid_op = ops.bond >= 0
    b = ops.bond.clamp(min=0)
    si = substate_index(ops.inputs)
    so = substate_index(ops.outputs)
    if bond_xor is not None:
        x = fetch_xor(bond_xor, b)
        si, so = si ^ x, so ^ x
    legmask = (1 << bond_fetch(model.arity(), b)) - 1
    bl = b.long()
    w_cur = model.full_w[bl, si.long(), so.long()]
    w_flip = model.full_w[bl, (si ^ legmask).long(), (so ^ legmask).long()]
    # [M, R] component root ids of both sides, one launch
    lab_in, lab_out = take0(W, s_in.contiguous(), s_out.contiguous())
    flip_prob, frozen = root_flip_prob(lab_in, lab_out, valid_op, w_cur, w_flip, SL, prob)
    flip_root = ((u_root < flip_prob) & ~frozen).to(torch.int32)
    f_in, f_out = take0(flip_root, lab_in, lab_out)
    return apply_flips(ops, state, head_f, f_in.bool() & valid_op, f_out.bool() & valid_op,
                       model)


def noop_flips(ops: OpString, state: torch.Tensor, head_f: torch.Tensor,
               model: BondModel):
    """:func:`apply_flips` with no flip: a cap overflow's skipped update."""
    off = torch.zeros_like(ops.bond, dtype=torch.bool)
    return apply_flips(ops, state, head_f, off, off, model)


def apply_flips(ops: OpString, state: torch.Tensor, head_f: torch.Tensor,
                flip_in: torch.Tensor, flip_out: torch.Tensor, model: BondModel):
    """Flip the legs of the op sides ``flip_in``, ``flip_out bool[M, R]``
    and re-read the p=0 state from each variable's first leg ``head_f``
    (:class:`SegGraph`). Returns ``(ops, state)``."""
    M, R = ops.bond.shape
    KM = ops.max_legs * M
    lv = op_vars(ops, model) >= 0  # [K, M, R]
    new_inputs = ops.inputs ^ (flip_in[None] & lv)
    new_outputs = ops.outputs ^ (flip_out[None] & lv)

    # The p=0 state is the first op's input on each variable
    # (cluster.rs:150-160); variables without ops keep their spin.
    has_head = head_f < KM
    first_val = torch.gather(new_inputs.reshape(KM, R), 0,
                             head_f.clamp(max=KM - 1).long())  # [N, R]
    new_state = torch.where(has_head.T, first_val.T, state)
    return OpString(bond=ops.bond, inputs=new_inputs, outputs=new_outputs), new_state
