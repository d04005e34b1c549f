"""Batched zero-energy worm walks (port of
``isingmontecarlo_tpu/classical/worm.py``; reference
``src/classical/graph.rs:179-318``).

One worm per replica (reference ``do_worm_flip``):

1. Pick a random start site, record ``starting_e`` = coupling-only dE of
   flipping it, flip it.
2. Repeatedly, from the current endpoint, enumerate neighbour moves
   (excluding the site we came from). Candidates are flips with
   coupling-only ``dE == 0`` (continuation) or ``dE == -starting_e``
   (resolution). If any resolving candidate exists, choose only among them;
   otherwise choose uniformly among continuations. With no candidates, turn
   around (re-apply the previous move reversed, ``graph.rs:252-262``).
3. The worm closes when the applied move's ``dE`` cancels ``starting_e``.
   If the path length exceeds ``nvars`` the update fails and all flips are
   reverted (``graph.rs:283-316``).
4. On success, the net-flipped set is accepted or reverted with a
   Metropolis test on the longitudinal-bias energy change.

Double moves (``graph.rs:224-240``): besides single flips of each neighbour
``ov`` of the endpoint, the candidates include pairs ``(ov, oov)`` with
``dE = c(ov) + c(oov) + 4 J(ov,oov) sigma_ov sigma_oov``; after one the
endpoint is ``oov`` and ``ov`` the banned back-step.

As in the JAX package, the bias test uses the physical energy change
``dE_bias = sum_v 2 h_v sigma_v^{before}`` of the net flip (the reference
evaluates it after the flip, ``graph.rs:303-306``; the two agree at h = 0).

The worms of all replicas advance in lockstep, one Python iteration per
step; finished replicas idle. The loop reads "all done" from the device
every :data:`CHECK_EVERY` iterations rather than every one, so up to that
many idle iterations run past the last worm's close (they change nothing).
"""

from __future__ import annotations

import torch

from isingmontecarlo_tpu_torch.classical.metropolis import (
    Draws,
    GraphTables,
    _masked_adjacency,
    local_field,
    sigma,
)

_EPS = 1e-6
CHECK_EVERY = 8


def _coupling_delta_e(spins, tables: GraphTables, v):
    """Coupling-only dE of flipping site ``v i64[R]`` per replica, ``f32[R]``
    (``graph.rs:155-177``)."""
    s = sigma(spins)
    neigh, w = _masked_adjacency(tables)
    sv = s.gather(1, v[:, None])
    sn = s.gather(1, neigh[v])
    return torch.sum(-2.0 * w[v] * sv * sn, dim=-1)


def _choose(u, weights):
    """Choose an index uniformly among ``weights > 0`` per row with the
    uniforms ``u f32[R]``; -1 where there is none."""
    R, D = weights.shape
    total = weights.sum(dim=-1)
    cum = torch.cumsum(weights, dim=-1)
    idx = ((u * total)[:, None] >= cum).sum(dim=-1)
    idx = torch.clamp(idx, max=D - 1)
    return torch.where(total > 0, idx, -1)


def _step(c: dict, u, tables: GraphTables, neigh, njw, starting_e, N, allow_doubles):
    """One lockstep worm move of every active replica; updates ``c``."""
    R = c["spins"].shape[0]
    D = neigh.shape[1]
    rows = torch.arange(R, device=neigh.device)
    s = sigma(c["spins"])
    cvals = -2.0 * s * local_field(c["spins"], tables)  # coupling dE of each site
    cur, last = c["cur"], c["last"]

    ov = neigh[cur]  # [R, D]
    valid_ov = (tables.neigh[cur] >= 0) & (ov != last[:, None])
    de_s = cvals.gather(1, ov)
    if allow_doubles:
        oov = neigh[ov]  # [R, D, D]
        valid_oov = (valid_ov[:, :, None] & (tables.neigh[ov] >= 0)
                     & (oov != cur[:, None, None]) & (oov != ov[:, :, None]))
        c_oov = cvals.gather(1, oov.reshape(R, D * D)).reshape(R, D, D)
        s_ov = s.gather(1, ov)[:, :, None]
        s_oov = s.gather(1, oov.reshape(R, D * D)).reshape(R, D, D)
        de_d = de_s[:, :, None] + c_oov + 4.0 * njw[ov] * s_ov * s_oov
        all_de = torch.cat([de_s, de_d.reshape(R, D * D)], dim=1)
        all_valid = torch.cat([valid_ov, valid_oov.reshape(R, D * D)], dim=1)
    else:
        all_de, all_valid = de_s, valid_ov

    is_cont = all_valid & (all_de.abs() < _EPS)
    is_res = all_valid & ((all_de + starting_e[:, None]).abs() < _EPS)
    cand = torch.where(is_res.any(dim=-1)[:, None], is_res, is_cont | is_res)
    choice = _choose(u, cand.to(torch.float32))
    has_choice = choice >= 0
    safe = torch.clamp(choice, min=0)
    is_double_choice = has_choice & (safe >= D)
    d1 = torch.where(safe >= D, (safe - D) // D, safe)
    d2 = torch.where(safe >= D, (safe - D) % D, 0)
    mv_a_sel = ov[rows, d1]
    mv_b_sel = torch.where(is_double_choice, neigh[mv_a_sel][rows, d2], mv_a_sel)

    # Turn-around: the previous move reversed; a double (a, b) -> (b, a).
    single = c["mv_a"] == c["mv_b"]
    mv_a = torch.where(has_choice, mv_a_sel, torch.where(single, cur, c["mv_b"]))
    mv_b = torch.where(has_choice, mv_b_sel, torch.where(single, cur, c["mv_a"]))
    is_double = mv_a != mv_b

    # dE of the applied move under the current state.
    c_a, c_b = cvals[rows, mv_a], cvals[rows, mv_b]
    jab = torch.where(neigh[mv_a] == mv_b[:, None], njw[mv_a], 0.0).sum(dim=1)
    de_pair = c_a + c_b + 4.0 * jab * s[rows, mv_a] * s[rows, mv_b]
    move_de = torch.where(is_double, de_pair, c_a)

    active = ~(c["done"] | c["failed"])
    for name in ("spins", "flipped"):
        x = c[name].clone()
        x[rows, mv_a] ^= active
        x[rows, mv_b] ^= active & is_double
        c[name] = x

    closed = (move_de + starting_e).abs() < _EPS
    steps = c["steps"] + 1
    c["cur"] = torch.where(active, torch.where(is_double, mv_b, mv_a), cur)
    c["last"] = torch.where(active, torch.where(is_double, mv_a, cur), last)
    c["mv_a"] = torch.where(active, mv_a, c["mv_a"])
    c["mv_b"] = torch.where(active, mv_b, c["mv_b"])
    c["steps"] = torch.where(active, steps, c["steps"])
    c["done"] = c["done"] | (active & closed)
    c["failed"] = c["failed"] | (active & ~closed & (steps > N))


def worm_sweep(spins: torch.Tensor, draws: Draws, beta, tables: GraphTables,
               allow_doubles: bool = True) -> torch.Tensor:
    """One worm update per replica: ``spins bool[R, N]`` -> updated.

    Draws, in order: the start sites ``randint(N, (R,))``, one ``uniform
    ((R,))`` per lockstep iteration for the move choice, and a last
    ``uniform((R,))`` for the bias test. ``allow_doubles`` enables the
    reference's two-site moves (``graph.rs:224-240``; its main move path
    passes true, ``graph.rs:389-397``)."""
    R, N = spins.shape
    dev = spins.device
    neigh, njw = _masked_adjacency(tables)
    rows = torch.arange(R, device=dev)
    start = draws.randint(N, (R,)).to(dev)
    starting_e = _coupling_delta_e(spins, tables, start)

    flipped = torch.zeros_like(spins)
    flipped[rows, start] = True
    c = {
        "spins": spins ^ flipped,
        "flipped": flipped,
        "cur": start, "last": start, "mv_a": start, "mv_b": start,
        "steps": torch.zeros((R,), dtype=torch.int32, device=dev),
        "done": torch.zeros((R,), dtype=torch.bool, device=dev),
        "failed": torch.zeros((R,), dtype=torch.bool, device=dev),
    }
    it = 0
    while True:
        if it % CHECK_EVERY == 0 and bool((c["done"] | c["failed"]).all()):
            break
        _step(c, draws.uniform((R,)), tables, neigh, njw, starting_e, N, allow_doubles)
        it += 1

    failed = c["failed"][:, None]
    # Failed worms revert entirely (graph.rs:311-316).
    out = torch.where(failed, spins, c["spins"])
    flipped = c["flipped"] & ~failed
    # Bias Metropolis test on the net flip (see the module docstring).
    s_before = sigma(out ^ flipped)
    de_bias = torch.where(flipped, 2.0 * tables.biases[None, :] * s_before, 0.0).sum(dim=-1)
    b = torch.as_tensor(beta, dtype=torch.float32, device=dev)
    keep = draws.uniform((R,)) < torch.exp(-b * torch.clamp(de_bias, min=0.0))
    return torch.where((keep[:, None] | failed), out, out ^ flipped)
