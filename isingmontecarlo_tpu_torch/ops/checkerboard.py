"""K1: ``nsweeps`` checkerboard Metropolis sweeps of a periodic L x L field.

Replaces ``isingmontecarlo_tpu/ops/checkerboard.py::checkerboard_multi_sweep``
(a Pallas kernel that holds one replica's field in VMEM for all sweeps).
The CUDA kernel has three variants, and :func:`k1_variant` picks one.
``csrc/checkerboard.cu``: a thread-block cluster of ``c`` CTAs per
replica, each holding a band of ``L/c`` rows of both colour planes in its
shared memory and reading the rows beside its band from its neighbours'
(:func:`cluster_size` picks ``c``). ``csrc/checkerboard_bands.cu``
(:func:`checkerboard_multi_sweep_bands`), for fields that no cluster holds:
a cooperative launch a wave of replicas, a CTA a band of rows in shared
memory for all sweeps, halo rows passed through global memory between
neighbouring bands at each half-step (:func:`k1_global_plan` cuts the bands
and waves). ``csrc/checkerboard_global.cu``
(:func:`checkerboard_multi_sweep_global`), for a replica too large for the
card's resident shared memory: the planes in global memory, a launch per
colour half-step. See those files for what bounds them on the card.

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
# the global variant every other even L.
MAX_SHARED_BYTES = 232_448
TABLE_BYTES = 40
CLUSTER_SIZES = (1, 2, 4, 8)
# An H100's SMs: the default card of the pure planners below.
H100_SMS = 132
# The banded variant's CTA: at most this many threads; in the 16-byte path a
# thread keeps one column quad, so L/8 quads must fit one CTA.
BAND_MAX_THREADS = 1024


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

    ``{"path": "global"}``: a single replica needs more CTAs than the
    card holds at once (on an H100 every L above 5,404: 132 SMs of 227 KB,
    one byte a spin), or its 16-byte path more than 1024 threads a row of
    quads; ``csrc/checkerboard_global.cu`` takes it."""
    if L % 2:
        raise ValueError(f"checkerboard sweeps need an even L, got L={L}")
    rows = (smem_bytes - TABLE_BYTES) // L - 2
    H = L // 2
    if rows < 1 or (H % 4 == 0 and H // 4 > BAND_MAX_THREADS):
        return {"path": "global"}
    nb_min = -(-L // rows)
    if nb_min > n_sms:
        return {"path": "global"}
    waves, r0 = [], 0
    while r0 < R:
        count = min(R - r0, n_sms // nb_min)
        waves.append((r0, count, min(L, n_sms // count)))
        r0 += count
    return {"path": "bands", "waves": waves}


def k1_variant(L: int, n_sms: int = H100_SMS, smem_bytes: int = MAX_SHARED_BYTES) -> str:
    """K1's variant for an L x L field (even L): ``"cluster"`` (shared
    memory, ``csrc/checkerboard.cu``) when some cluster size holds it;
    ``"bands"`` (``csrc/checkerboard_bands.cu``) when :func:`k1_global_plan`
    places a replica's bands on the card's SMs; else ``"global"``
    (``csrc/checkerboard_global.cu``). On an H100 the cluster variant takes
    every even L up to 680, the multiples of 4 up to 964 and the multiples
    of 8 up to 1360; the banded one every other even L (the first is 682)
    up to 5,404; the global one every even L past it."""
    if cluster_sizes(L):
        return "cluster"
    return "bands" if k1_global_plan(1, L, n_sms, smem_bytes)["path"] == "bands" else "global"


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
                         f"K1 takes its banded or global variant")
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
    :func:`checkerboard_multi_sweep_global`; or raises: also when
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
        if variant == "global":
            return checkerboard_multi_sweep_global(spins, seed, beta, j, h, nsweeps)
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
    plan sends L to :func:`checkerboard_multi_sweep_global`, or when the
    card cannot hold a wave's CTAs at once (nothing is launched then)."""
    R, L = _check_lattice(spins)
    _build.check(spins, "spins", torch.bool, (R, L, L), spins.device)
    if not _build.use_kernel(spins.device):
        return checkerboard_multi_sweep_plain(spins, seed, beta, j, h, nsweeps)
    plan = k1_global_plan(R, L, _build.sm_count(spins.device))
    if plan["path"] != "bands":
        raise ValueError(f"L={L}: a replica needs more CTAs of {MAX_SHARED_BYTES} bytes of "
                         f"shared memory than the card holds at once; K1 takes its global "
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


def checkerboard_multi_sweep_global(spins: torch.Tensor, seed: int, beta, j, h,
                                    nsweeps: int) -> torch.Tensor:
    """K1's global-memory variant (``csrc/checkerboard_global.cu``) at any
    even L, with the semantics and draws of :func:`checkerboard_multi_sweep`:
    the colour planes live in a scratch buffer in global memory, and each
    half-step is a launch of its own. :func:`checkerboard_multi_sweep` takes
    it for a replica too large for the card's resident shared memory
    (:func:`k1_global_plan`).

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
