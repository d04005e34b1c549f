"""K1: ``nsweeps`` checkerboard Metropolis sweeps of a periodic L x L field.

Replaces ``isingmontecarlo_tpu/ops/checkerboard.py::checkerboard_multi_sweep``
(a Pallas kernel that holds one replica's field in VMEM for all sweeps).
The CUDA kernel has three variants in use, and :func:`k1_variant` picks one.
``csrc/checkerboard.cu``: a thread-block cluster of ``c`` CTAs per
replica, each holding a band of ``L/c`` rows of both colour planes in its
shared memory and reading the rows beside its band from its neighbours'
(:func:`cluster_size` picks ``c``). ``csrc/checkerboard_bands.cu``
(:func:`checkerboard_multi_sweep_bands`), for fields that no cluster holds:
a cooperative launch a wave of replicas, a CTA a band of rows in shared
memory for all sweeps, halo rows passed through global memory between
neighbouring bands at each half-step (:func:`k1_global_plan` cuts the bands
and waves). ``csrc/checkerboard_tiles.cu``
(:func:`checkerboard_multi_sweep_tiles`), for a replica too large for the
card's resident shared memory: overlapped temporal tiles, a launch per
``k`` sweeps, each CTA a tile and its halo in shared memory
(:func:`k1_tile_plan` picks ``k`` and the tiles). The fourth,
``csrc/checkerboard_global.cu`` (:func:`checkerboard_multi_sweep_global`:
the planes in global memory, a launch per colour half-step), is no longer
dispatched and stays callable to be timed beside the tiled one. See those
files for what bounds them on the card.

Semantics (``src/classical/graph.rs:339-347, 430-447``): energy
``E = J sum_<ij> s_i s_j - h sum_i s_i``; each sweep updates the even plane
(``(x + y) % 2 == 0``) and then the odd one, flipping a site when
``u < exp(-beta * max(dE, 0))`` with ``dE = s * (2h - 2J * nsum)``.

Layout: the two colours are held as compact ``(L, L/2)`` planes (plane E
holds ``s[y, 2k + (y & 1)]``, plane O the rest), so every lane is a real
attempt; neighbour sums are the other plane at rows ``y +- 1`` and at
columns ``k`` and ``k -+ 1`` chosen by row parity. L must be even.

Randomness: Philox4x32-10 (Salmon et al., SC'11; Random123's constants),
keyed by the 64-bit ``seed`` and counted by ``(group, sweep, colour,
replica)``, where ``group = site // 4`` over the plane's row-major sites and
word ``site % 4`` of the group's output is the site's draw. So the numbers
do not depend on launch geometry, and the kernel and :func:`checkerboard_
multi_sweep_plain` give the same spins bit for bit. ``u = (bits >> 8) *
2^-24``. ``dE`` takes 10 values (``s = +-1``, ``nsum`` in ``{-4..4}`` step
2), so the acceptance probabilities are one ``f32[2, 5]`` table computed once
with ``torch.exp`` (:func:`accept_table`), which both versions index.
"""

from __future__ import annotations

import functools

import torch

from isingmontecarlo_tpu_torch.ops import _build

# Random123's Philox4x32 multipliers and Weyl key increments.
PHILOX_M0, PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
PHILOX_W0, PHILOX_W1 = 0x9E3779B9, 0xBB67AE85
_MASK32 = 0xFFFFFFFF

# A CTA holds a band of L/c rows of both int8 planes, L * L / c bytes, and
# a 40-byte threshold table in the 232,448 bytes of shared memory an H100
# block can have; c is at most 8 (the portable cluster size) and divides L,
# so the cluster variant takes L <= 1360 (not every even L below it), and
# the banded and tiled variants every other even L.
MAX_SHARED_BYTES = 232_448
TABLE_BYTES = 40
CLUSTER_SIZES = (1, 2, 4, 8)
# An H100's SMs: the default card of the pure planners below.
H100_SMS = 132
# The banded variant's CTA: at most this many threads; in the 16-byte path a
# thread keeps one column quad, so L/8 quads must fit one CTA.
BAND_MAX_THREADS = 1024
# Shared memory the card keeps for each resident CTA beside what it asks
# for: m CTAs share an SM's MAX_SHARED_BYTES + BLOCK_RESERVED_BYTES.
BLOCK_RESERVED_BYTES = 1024
# The tiled variant's largest k (sweeps a launch; halos of 2k rows).
TILE_K_MAX = 16
# Its cost model (k1_tile_plan): a launch takes, on its busiest SM,
# ceil(CTAs / SMs) * loaded sites * (sweeps * TILE_ATTEMPT_SM_S +
# TILE_LOAD_SITE_S), plus TILE_LAUNCH_S. The constants are the least-squares
# fit of scripts/k1_tile_sweep.py to its 28 readings (the default plan and
# 13 forced tile shapes at 6000^2, R=1, 2 sweeps and at 8192^2, R=1, 100
# sweeps) on an H100 80GB HBM3 at 700 W: the seconds an attempt takes one
# SM, a loaded site's load and write-back, and a launch's fixed cost (its
# fill and drain). The fit ranks the shapes as the card did; a single
# launch it overestimates by ~20 us.
TILE_ATTEMPT_SM_S = 1.539e-10
TILE_LOAD_SITE_S = 6.05e-12
TILE_LAUNCH_S = 5.6e-5


def split_planes(x: torch.Tensor) -> torch.Tensor:
    """``[..., L, L]`` -> ``[..., 2, L, L/2]`` compact colour planes, any
    dtype: plane 0 holds the sites with ``(x + y) % 2 == 0``."""
    *lead, L, _ = x.shape
    pairs = x.reshape(*lead, L, L // 2, 2)
    ye = (torch.arange(L, device=x.device) % 2 == 0)[:, None]
    e = torch.where(ye, pairs[..., 0], pairs[..., 1])
    o = torch.where(ye, pairs[..., 1], pairs[..., 0])
    return torch.stack([e, o], dim=-3)


def split_colors(spins: torch.Tensor) -> torch.Tensor:
    """``bool/int8 [R, L, L]`` -> ``int8 [R, 2, L, L/2]`` compact planes."""
    return split_planes(spins.to(torch.int8))


def merge_colors(eo: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`split_colors`: ``[R, 2, L, L/2]`` -> ``[R, L, L]``."""
    R, _, L, H = eo.shape
    e, o = eo[:, 0], eo[:, 1]
    ye = (torch.arange(L, device=eo.device) % 2 == 0)[:, None]
    p0 = torch.where(ye, e, o)
    p1 = torch.where(ye, o, e)
    return torch.stack([p0, p1], dim=-1).reshape(R, L, 2 * H)


def plane_neighbour_sums(other: torch.Tensor, color: int) -> torch.Tensor:
    """Sum of the four neighbours of every site of plane ``color``, read
    from the other plane ``other [..., L, H]`` (any numeric dtype)."""
    L = other.shape[-2]
    row_even = (torch.arange(L, device=other.device) % 2 == 0)[:, None]
    # Left/right pair: column k and k - 1 (E plane, even rows; O plane, odd
    # rows) or k and k + 1 (the other two cases).
    back = row_even if color == 0 else ~row_even
    side = torch.where(back, torch.roll(other, 1, dims=-1),
                       torch.roll(other, -1, dims=-1))
    return (torch.roll(other, 1, dims=-2) + torch.roll(other, -1, dims=-2)
            + other + side)


def _mulhilo(m: int, x: torch.Tensor):
    """``(hi, lo)`` 32-bit words of ``m * x`` for ``x`` int64 holding uint32.
    The product can reach 2^64 and overflow int64, so it is formed from the
    16-bit halves of ``x``."""
    a = m * (x & 0xFFFF)  # < 2^48
    b = m * (x >> 16)  # < 2^48
    low = a + ((b & 0xFFFF) << 16)  # < 2^49
    return (b >> 16) + (low >> 32), low & _MASK32


def philox4x32(c0, c1, c2, c3, k0: int, k1: int):
    """Philox4x32-10 of counter ``(c0, c1, c2, c3)`` (int64 tensors or ints
    holding uint32, broadcast together) under key ``(k0, k1)``; returns the
    four output words as int64 tensors."""
    c = [torch.as_tensor(x, dtype=torch.int64) for x in (c0, c1, c2, c3)]
    k0, k1 = k0 & _MASK32, k1 & _MASK32
    for r in range(10):
        if r:
            k0, k1 = (k0 + PHILOX_W0) & _MASK32, (k1 + PHILOX_W1) & _MASK32
        hi0, lo0 = _mulhilo(PHILOX_M0, c[0])
        hi1, lo1 = _mulhilo(PHILOX_M1, c[2])
        c = [hi1 ^ c[1] ^ k0, lo1, hi0 ^ c[3] ^ k1, lo0]
    return c


def seed_words(seed: int) -> tuple[int, int]:
    """The two Philox key words of a 64-bit seed (taken mod 2^64)."""
    s = int(seed) & ((1 << 64) - 1)
    return s & _MASK32, s >> 32


def plane_uniforms(seed: int, R: int, L: int, sweep: int, color: int,
                   device) -> torch.Tensor:
    """``f32[R, L, L/2]``: the draws of plane ``color`` in sweep ``sweep``."""
    H = L // 2
    k0, k1 = seed_words(seed)
    n_groups = (L * H + 3) // 4
    g = torch.arange(n_groups, dtype=torch.int64, device=device)[None]
    r = torch.arange(R, dtype=torch.int64, device=device)[:, None]
    words = torch.stack(philox4x32(g, sweep, color, r, k0, k1), dim=-1)
    bits = words.reshape(R, 4 * n_groups)[:, : L * H]
    return ((bits >> 8).to(torch.float32) * 2.0 ** -24).reshape(R, L, H)


def accept_table(beta, j, h, device) -> torch.Tensor:
    """``f32[2, 5]``: ``p[s, c] = exp(-beta * max(dE, 0))`` for spin index
    ``s`` (0 down, 1 up) and ``c`` up neighbours, with the Pallas kernel's
    ``dE = s * (2h - 2J * nsum)``, ``nsum = 2c - 4``, all in float32.

    Computed on the host and, for a CUDA ``device``, copied from pinned
    memory without waiting: a copy from pageable memory would wait for the
    stream, and so for the kernel launched before it."""
    f32 = torch.float32
    beta, j, h = (torch.tensor(float(x), dtype=f32) for x in (beta, j, h))
    sig = torch.tensor([-1.0, 1.0], dtype=f32)[:, None]
    nsum = torch.arange(-4.0, 5.0, 2.0, dtype=f32)[None]
    de = sig * (2.0 * h - 2.0 * j * nsum)
    p = torch.exp(-beta * torch.clamp(de, min=0.0))
    if torch.device(device).type == "cpu":
        return p
    return p.pin_memory().to(device, non_blocking=True)


def half_sweep(eo: torch.Tensor, color: int, u: torch.Tensor,
               table: torch.Tensor) -> torch.Tensor:
    """Update plane ``color`` of ``eo int8[R, 2, L, H]`` (0/1 spins) with the
    draws ``u f32[R, L, H]`` and the table of :func:`accept_table`; returns
    the new ``eo``."""
    own = eo[:, color]
    ups = plane_neighbour_sums(eo[:, 1 - color].to(torch.int64), color)
    p = table[own.to(torch.int64), ups]
    new = own ^ (u < p).to(torch.int8)
    return torch.stack([new, eo[:, 1]] if color == 0 else [eo[:, 0], new], dim=1)


def _check_lattice(spins: torch.Tensor) -> tuple[int, int]:
    if spins.dim() != 3 or spins.shape[1] != spins.shape[2]:
        raise ValueError(f"spins: expected [R, L, L], got {tuple(spins.shape)}")
    R, L, _ = spins.shape
    if L % 2:
        # With odd L the periodic wrap makes same-coloured sites neighbours,
        # and a parallel colour update is no longer a Metropolis sweep.
        raise ValueError(f"checkerboard sweeps need an even L, got L={L}")
    return R, L


def checkerboard_multi_sweep_plain(spins, seed: int, beta, j, h,
                                   nsweeps: int) -> torch.Tensor:
    """The plain PyTorch version: the same Philox draws and table, one colour
    plane at a time."""
    R, L = _check_lattice(spins)
    eo = split_colors(spins)
    table = accept_table(beta, j, h, spins.device)
    for t in range(nsweeps):
        for c in (0, 1):
            eo = half_sweep(eo, c, plane_uniforms(seed, R, L, t, c, spins.device), table)
    return merge_colors(eo).to(torch.bool)


def cluster_sizes(L: int) -> list[int]:
    """The CTAs per replica that can hold an L x L field (even L): ``c`` in
    :data:`CLUSTER_SIZES` that divides L and whose band of ``L * L / c``
    bytes fits a CTA's shared memory; empty when there is none."""
    if L % 2:
        raise ValueError(f"checkerboard sweeps need an even L, got L={L}")
    return [c for c in CLUSTER_SIZES
            if L % c == 0 and L * L // c + TABLE_BYTES <= MAX_SHARED_BYTES]


def band_rows(L: int, nb: int) -> list[tuple[int, int]]:
    """The rows ``[y0, y1)`` of each of the ``nb`` bands of an L-row field
    in the banded variant, as ``csrc/checkerboard_bands.cu`` cuts them:
    ``y0 = b * L // nb``, so the bands tile ``[0, L)`` and differ by at most
    one row."""
    return [(b * L // nb, (b + 1) * L // nb) for b in range(nb)]


def band_smem_bytes(L: int, rows: int) -> int:
    """Shared memory of a banded CTA of ``rows`` rows: both colour planes'
    rows and a halo row on each side, ``(rows + 2) * L`` bytes, and the
    threshold table."""
    return (rows + 2) * L + TABLE_BYTES


def k1_global_plan(R: int, L: int, n_sms: int = H100_SMS,
                   smem_bytes: int = MAX_SHARED_BYTES) -> dict:
    """How K1 runs ``R`` replicas of an L x L field (even L) outside the
    cluster variant, on a card of ``n_sms`` SMs whose CTA may have
    ``smem_bytes`` of shared memory. A pure function.

    ``{"path": "bands", "waves": [(r0, count, nb), ...]}``: one cooperative
    launch a wave, replicas ``r0 .. r0 + count - 1`` cut into ``nb`` bands
    each (:func:`band_rows`), a CTA a band and one CTA an SM (a 1024-thread
    CTA takes an SM's registers), so ``count * nb <= n_sms``. A CTA holds at
    most ``rows = (smem_bytes - TABLE_BYTES) // L - 2`` rows, so a replica
    needs ``nb_min = ceil(L / rows)`` bands; a wave takes as many replicas
    as ``nb_min`` bands each fit on the SMs, and spreads them over every
    SM (``nb = n_sms // count``, at most L).

    ``{"path": "tiles"}``: a single replica needs more CTAs than the
    card holds at once (on an H100 every L above 5,404: 132 SMs of 227 KB,
    one byte a spin), or its 16-byte path more than 1024 threads a row of
    quads; ``csrc/checkerboard_tiles.cu`` takes it (:func:`k1_tile_plan`)."""
    if L % 2:
        raise ValueError(f"checkerboard sweeps need an even L, got L={L}")
    rows = (smem_bytes - TABLE_BYTES) // L - 2
    H = L // 2
    if rows < 1 or (H % 4 == 0 and H // 4 > BAND_MAX_THREADS):
        return {"path": "tiles"}
    nb_min = -(-L // rows)
    if nb_min > n_sms:
        return {"path": "tiles"}
    waves, r0 = [], 0
    while r0 < R:
        count = min(R - r0, n_sms // nb_min)
        waves.append((r0, count, min(L, n_sms // count)))
        r0 += count
    return {"path": "bands", "waves": waves}


def tile_halo_cols(L: int, k: int) -> int:
    """The tiled variant's column halo in plane columns on each side of a
    tile, for ``k`` sweeps a launch: ``k`` (2k field columns), rounded up to
    a multiple of 4 where L % 8 == 0, so that on ``csrc/checkerboard_tiles.
    cu``'s word path every loaded row starts on a 4-site group."""
    return -(-k // 4) * 4 if L % 8 == 0 else k


def tile_smem_bytes(L: int, k: int, ty: int, tx: int) -> int:
    """Shared memory of a tiled CTA: both colour planes of the ``ty x tx``
    interior and its halos, ``ty + 4k`` rows of ``tx / 2 + 2 hc`` plane
    columns (:func:`tile_halo_cols`) each, a row padded to whole 4-byte
    words, and the threshold table."""
    words = -(-(tx // 2 + 2 * tile_halo_cols(L, k)) // 4)
    return 2 * (ty + 4 * k) * 4 * words + TABLE_BYTES


def tile_launches(nsweeps: int, k: int) -> list[tuple[int, int]]:
    """``(first sweep, sweeps)`` of each launch of a call of ``nsweeps``
    sweeps at ``k`` sweeps a launch: ``ceil(nsweeps / k)`` launches, the
    last with the rest; one launch of no sweeps for ``nsweeps = 0``."""
    return [(t, min(k, nsweeps - t)) for t in range(0, nsweeps, k)] or [(0, 0)]


def _tile_geometry(R: int, L: int, nsweeps: int, k: int, ty: int, tx: int,
                   n_sms: int, smem_bytes: int) -> dict | None:
    """The tiled plan at one (k, ty, tx), or None where it does not fit:
    the most CTAs an SM (2 or 1) whose shared memory and threads hold the
    tile, the threads a CTA (whole rows of column quads), the launches and
    the modelled seconds."""
    hc = tile_halo_cols(L, k)
    quads = -(-(tx // 2 + 2 * hc) // 4)
    rows = ty + 4 * k
    smem = tile_smem_bytes(L, k, ty, tx)
    m = next((m for m in (2, 1) if quads <= BAND_MAX_THREADS // m and
              m * (smem + BLOCK_RESERVED_BYTES) <= smem_bytes + BLOCK_RESERVED_BYTES), None)
    if m is None:
        return None
    ny, nx = -(-L // ty), -(-L // tx)
    ctas = R * ny * nx
    launches = tile_launches(nsweeps, k)
    # An SM runs ceil(ctas / n_sms) CTAs (m at once share its issue rate).
    per_sm = -(-ctas // n_sms) * rows * (tx + 4 * hc)
    seconds = sum(per_sm * (sweeps * TILE_ATTEMPT_SM_S + TILE_LOAD_SITE_S) + TILE_LAUNCH_S
                  for _, sweeps in launches)
    return {"path": "tiles", "k": k, "ty": ty, "tx": tx, "halo_rows": 2 * k,
            "halo_cols": 2 * hc, "ny": ny, "nx": nx, "ctas": ctas, "ctas_per_sm": m,
            "threads": min(BAND_MAX_THREADS // m // quads, rows - 2) * quads,
            "smem_bytes": smem, "launches": launches, "seconds": seconds}


def k1_tile_plan(R: int, L: int, nsweeps: int, n_sms: int = H100_SMS,
                 smem_bytes: int = MAX_SHARED_BYTES, *, k: int | None = None,
                 ty: int | None = None, tx: int | None = None) -> dict:
    """How K1's tiled variant (``csrc/checkerboard_tiles.cu``) runs
    ``nsweeps`` sweeps of ``R`` replicas of an L x L field (even L) on a card
    of ``n_sms`` SMs whose CTA may have ``smem_bytes`` of shared memory. A
    pure function.

    Returns ``{"path": "tiles", "k", "ty", "tx", "halo_rows", "halo_cols",
    "ny", "nx", "ctas", "ctas_per_sm", "threads", "smem_bytes", "launches",
    "seconds"}``: a launch a ``k`` sweeps (``launches``, from
    :func:`tile_launches`), each CTA an interior tile of ``ty`` rows by
    ``tx`` field columns of one replica (``ny x nx`` tiles a replica, the
    last row and column of tiles ragged) with halos of ``halo_rows`` rows and
    ``halo_cols`` columns on each side, loaded in ``smem_bytes`` of shared
    memory (:func:`tile_smem_bytes`), ``ctas_per_sm`` at once on an SM of
    ``threads`` threads each. Column origins are multiples of 8 field
    columns where L % 8 == 0.

    By default it takes the (k, ty, tx) of least modelled time ``seconds``:
    the redundant sites of the halos, ``(ty + 4k)(tx + 4 hc) / (ty tx)``,
    times the CTAs an SM runs, ``ceil(CTAs / n_sms)``, each loaded site at
    ``TILE_ATTEMPT_SM_S`` a sweep and ``TILE_LOAD_SITE_S`` a launch, plus
    ``TILE_LAUNCH_S`` a launch; k <= nsweeps and ``TILE_K_MAX``, and for
    each k and column count the tiles even in size. ``k``, ``ty`` and
    ``tx`` force one shape (all three or none); a shape that does not fit
    raises ``ValueError``."""
    if L % 2:
        raise ValueError(f"checkerboard sweeps need an even L, got L={L}")
    align = 8 if L % 8 == 0 else 2
    forced = (k, ty, tx)
    if any(v is not None for v in forced):
        if any(v is None for v in forced):
            raise ValueError(f"k1_tile_plan: force k, ty and tx together, got {forced}")
        if k < 1 or ty < 1 or tx < 2 or tx % align:
            raise ValueError(f"k1_tile_plan: k={k}, ty={ty}, tx={tx} at L={L}: k and ty "
                             f"positive, tx a positive multiple of {align}")
        plan = _tile_geometry(R, L, nsweeps, k, ty, tx, n_sms, smem_bytes)
        if plan is None:
            raise ValueError(f"k1_tile_plan: a {ty} x {tx} tile with k={k} at L={L} needs "
                             f"{tile_smem_bytes(L, k, ty, tx)} bytes of shared memory (of "
                             f"{smem_bytes}) or more than {BAND_MAX_THREADS} threads")
        return plan
    return _best_tile_plan(R, L, nsweeps, n_sms, smem_bytes)


@functools.lru_cache(maxsize=256)
def _best_tile_plan(R: int, L: int, nsweeps: int, n_sms: int, smem_bytes: int) -> dict:
    align = 8 if L % 8 == 0 else 2
    best = None
    for k in range(1, max(1, min(nsweeps, TILE_K_MAX)) + 1):
        hc = tile_halo_cols(L, k)
        seen = set()
        for nx in range(1, 65):
            tx = -(-(-(-L // nx)) // align) * align
            if tx in seen or 4 * hc > tx:
                continue
            seen.add(tx)
            # The most rows a CTA holds at one CTA an SM (two planes of rows
            # padded to whole words); then the tile rows that fill the last
            # wave of CTAs best.
            row_bytes = 8 * -(-(tx // 2 + 2 * hc) // 4)
            rows_max = (smem_bytes - TABLE_BYTES) // row_bytes - 4 * k
            if rows_max < 1:
                continue
            ny_min = -(-L // rows_max)
            per_wave = -(-R * nx * ny_min // n_sms)
            cands = {ny_min} | {w * n_sms // (R * nx) for w in range(per_wave, per_wave + 3)}
            for ny in sorted(c for c in cands if ny_min <= c <= L):
                plan = _tile_geometry(R, L, nsweeps, k, -(-L // ny), tx, n_sms, smem_bytes)
                if plan is not None and (best is None or plan["seconds"] < best["seconds"]):
                    best = plan
    if best is None:
        raise ValueError(f"k1_tile_plan: no tile fits L={L} in {smem_bytes} bytes")
    return best


def k1_variant(L: int, n_sms: int = H100_SMS, smem_bytes: int = MAX_SHARED_BYTES) -> str:
    """K1's variant for an L x L field (even L): ``"cluster"`` (shared
    memory, ``csrc/checkerboard.cu``) when some cluster size holds it;
    ``"bands"`` (``csrc/checkerboard_bands.cu``) when :func:`k1_global_plan`
    places a replica's bands on the card's SMs; else ``"tiles"``
    (``csrc/checkerboard_tiles.cu``). On an H100 the cluster variant takes
    every even L up to 680, the multiples of 4 up to 964 and the multiples
    of 8 up to 1360; the banded one every other even L (the first is 682)
    up to 5,404; the tiled one every even L past it."""
    if cluster_sizes(L):
        return "cluster"
    return k1_global_plan(1, L, n_sms, smem_bytes)["path"]


def cluster_size(R: int, L: int, n_sms: int) -> int:
    """K1's CTAs per replica for ``R`` replicas of an L x L field on a card
    with ``n_sms`` SMs: the largest of :func:`cluster_sizes` whose ``R * c``
    CTAs fit one wave of one CTA per SM, else the smallest. A 1024-thread
    CTA's registers leave no room for a second on its SM, and every CTA
    more per replica adds remote rows and cluster barriers, so past one
    wave a larger c only costs (on an H100 at L=256, 100 sweeps: R=64 ran
    0.82 ms at c=2 and 1.46 ms at c=4; R=256 2.72 ms at c=1 and 3.26 ms at
    c=2; ``chip_smoke.py`` phase 3). Raises for an L that no cluster
    holds."""
    sizes = cluster_sizes(L)
    if not sizes:
        raise ValueError(f"L={L}: no cluster size holds the field in shared memory; "
                         f"K1 takes its banded or tiled variant")
    return max((c for c in sizes if R * c <= n_sms), default=sizes[0])


def checkerboard_multi_sweep(spins: torch.Tensor, seed: int, beta, j, h,
                             nsweeps: int, cluster: int | None = None) -> torch.Tensor:
    """``nsweeps`` checkerboard Metropolis sweeps of ``spins bool[R, L, L]``
    (even L) with uniform ``j`` and ``h``; returns the new ``bool[R, L, L]``.

    A CPU tensor takes :func:`checkerboard_multi_sweep_plain`. A CUDA tensor
    launches K1's variant for L on the card (:func:`k1_variant`): the
    cluster kernel (counted in ``checkerboard_multi_sweep.launches``) with
    ``cluster`` CTAs per replica (default :func:`cluster_size` for the
    card), :func:`checkerboard_multi_sweep_bands` or
    :func:`checkerboard_multi_sweep_tiles`; or raises: also when
    ``cluster`` is not a size that holds the field in shared memory, or
    when the card cannot schedule the cluster."""
    R, L = _check_lattice(spins)
    _build.check(spins, "spins", torch.bool, (R, L, L), spins.device)
    if not _build.use_kernel(spins.device):
        return checkerboard_multi_sweep_plain(spins, seed, beta, j, h, nsweeps)
    sizes = cluster_sizes(L)
    if cluster is None:
        n_sms = _build.sm_count(spins.device)
        variant = k1_variant(L, n_sms)
        if variant == "bands":
            return checkerboard_multi_sweep_bands(spins, seed, beta, j, h, nsweeps)
        if variant == "tiles":
            return checkerboard_multi_sweep_tiles(spins, seed, beta, j, h, nsweeps)
        cluster = cluster_size(R, L, n_sms)
    elif cluster not in sizes:
        raise ValueError(f"cluster={cluster}: L={L} takes a cluster size in {sizes} (c "
                         f"divides L and a band of L*L/c bytes fits a CTA's "
                         f"{MAX_SHARED_BYTES} bytes of shared memory)")
    out = torch.empty_like(spins)
    table = accept_table(beta, j, h, spins.device)
    k0, k1 = seed_words(seed)
    _build.launch("ising_checkerboard", spins, out, table, k0, k1, R, L, cluster, nsweeps)
    checkerboard_multi_sweep.launches += 1
    return out


checkerboard_multi_sweep.launches = 0


def checkerboard_multi_sweep_bands(spins: torch.Tensor, seed: int, beta, j, h,
                                   nsweeps: int) -> torch.Tensor:
    """K1's banded variant (``csrc/checkerboard_bands.cu``), with the
    semantics and draws of :func:`checkerboard_multi_sweep`: one cooperative
    launch a wave of :func:`k1_global_plan`, a CTA a band of rows in shared
    memory for all ``nsweeps`` sweeps. :func:`checkerboard_multi_sweep`
    takes it for fields that no cluster holds, up to what the card holds at
    once.

    A CPU tensor takes :func:`checkerboard_multi_sweep_plain`; a CUDA tensor
    launches a kernel a wave, each counted in
    ``checkerboard_multi_sweep_bands.launches``, or raises: also when the
    plan sends L to :func:`checkerboard_multi_sweep_tiles`, or when the
    card cannot hold a wave's CTAs at once (nothing is launched then)."""
    R, L = _check_lattice(spins)
    _build.check(spins, "spins", torch.bool, (R, L, L), spins.device)
    if not _build.use_kernel(spins.device):
        return checkerboard_multi_sweep_plain(spins, seed, beta, j, h, nsweeps)
    plan = k1_global_plan(R, L, _build.sm_count(spins.device))
    if plan["path"] != "bands":
        raise ValueError(f"L={L}: a replica needs more CTAs of {MAX_SHARED_BYTES} bytes of "
                         f"shared memory than the card holds at once; K1 takes its tiled "
                         f"variant")
    out = torch.empty_like(spins)
    table = accept_table(beta, j, h, spins.device)
    k0, k1 = seed_words(seed)
    for r0, count, nb in plan["waves"]:
        halo = torch.empty(2 * count * nb * L, dtype=torch.uint8, device=spins.device)
        flags = torch.zeros(count * nb, dtype=torch.int32, device=spins.device)
        _build.launch("ising_checkerboard_bands", spins, out, halo, flags, table, k0, k1, L,
                      nsweeps, r0, count, nb)
        checkerboard_multi_sweep_bands.launches += 1
    return out


checkerboard_multi_sweep_bands.launches = 0


def checkerboard_multi_sweep_tiles(spins: torch.Tensor, seed: int, beta, j, h,
                                   nsweeps: int, *, k: int | None = None,
                                   ty: int | None = None,
                                   tx: int | None = None) -> torch.Tensor:
    """K1's tiled variant (``csrc/checkerboard_tiles.cu``) at any even L,
    with the semantics and draws of :func:`checkerboard_multi_sweep`:
    overlapped temporal tiles, a launch a ``k`` sweeps, each CTA an interior
    tile and its halos in shared memory (:func:`k1_tile_plan`; ``k``,
    ``ty`` and ``tx`` force its shape). :func:`checkerboard_multi_sweep`
    takes it for a replica too large for the card's resident shared memory.

    A CPU tensor takes :func:`checkerboard_multi_sweep_plain`; a CUDA tensor
    launches ``ceil(nsweeps / k)`` kernels, each counted in
    ``checkerboard_multi_sweep_tiles.launches``: the first reads ``spins``,
    the last writes the result, and between them the result and one scratch
    field alternate (a tile's halo reads the field its launch started
    from). Raises for a forced shape that does not fit, before any launch,
    and for a launch that fails."""
    R, L = _check_lattice(spins)
    _build.check(spins, "spins", torch.bool, (R, L, L), spins.device)
    if not _build.use_kernel(spins.device):
        return checkerboard_multi_sweep_plain(spins, seed, beta, j, h, nsweeps)
    plan = k1_tile_plan(R, L, nsweeps, _build.sm_count(spins.device), k=k, ty=ty, tx=tx)
    launches = plan["launches"]
    out = torch.empty_like(spins)
    scratch = torch.empty_like(spins) if len(launches) > 1 else None
    table = accept_table(beta, j, h, spins.device)
    k0, k1 = seed_words(seed)
    src = spins
    for i, (sweep0, sweeps) in enumerate(launches):
        dst = out if (len(launches) - 1 - i) % 2 == 0 else scratch
        _build.launch("ising_checkerboard_tiles", src, dst, table, k0, k1, R, L, sweep0,
                      sweeps, plan["k"], plan["ty"], plan["tx"], plan["threads"])
        checkerboard_multi_sweep_tiles.launches += 1
        src = dst
    return out


checkerboard_multi_sweep_tiles.launches = 0


def checkerboard_multi_sweep_global(spins: torch.Tensor, seed: int, beta, j, h,
                                    nsweeps: int) -> torch.Tensor:
    """K1's global-memory variant (``csrc/checkerboard_global.cu``) at any
    even L, with the semantics and draws of :func:`checkerboard_multi_sweep`:
    the colour planes live in a scratch buffer in global memory, and each
    half-step is a launch of its own. :func:`checkerboard_multi_sweep` no
    longer takes it (:func:`checkerboard_multi_sweep_tiles` serves its
    fields); it stays to be timed beside the tiled variant.

    A CPU tensor takes :func:`checkerboard_multi_sweep_plain`; a CUDA tensor
    calls the variant's entry point, which launches ``2 * nsweeps + 2``
    kernels and counts once in ``checkerboard_multi_sweep_global.launches``,
    or raises."""
    R, L = _check_lattice(spins)
    _build.check(spins, "spins", torch.bool, (R, L, L), spins.device)
    if not _build.use_kernel(spins.device):
        return checkerboard_multi_sweep_plain(spins, seed, beta, j, h, nsweeps)
    out = torch.empty_like(spins)
    planes = torch.empty((R, L * L), dtype=torch.uint8, device=spins.device)
    table = accept_table(beta, j, h, spins.device)
    k0, k1 = seed_words(seed)
    _build.launch("ising_checkerboard_global", spins, out, planes, table, k0, k1, R, L,
                  nsweeps)
    checkerboard_multi_sweep_global.launches += 1
    return out


checkerboard_multi_sweep_global.launches = 0
