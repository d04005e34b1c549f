"""Kernel K1 of the port (``ops/checkerboard.py``) on the CPU: its compact
colour planes against the JAX package's, its Philox against Random123's
known answers, its plain version against the full-field sweep of both
packages on the same uniforms, the rules that pick its cluster, banded and
tiled variants, cut bands and waves and plan tiles (the dispatch forced,
nothing launched), the tiled variant's schedule emulated in plain torch
against the plain version, and ``LatticeIsing`` against exact enumeration
of a 4x4 lattice; on a card only, each variant against the plain
version."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isingmontecarlo_tpu.classical import metropolis as jmetro
from isingmontecarlo_tpu.ops import checkerboard as jcb
from isingmontecarlo_tpu_torch import LatticeIsing, ops
from isingmontecarlo_tpu_torch.classical import metropolis as tmetro
from isingmontecarlo_tpu_torch.ops import _build
from isingmontecarlo_tpu_torch.ops import checkerboard as cb

from torch_port_utils import (
    assert_equal_where_decided,
    checkerboard_uniforms,
    decided_replicas,
    np_,
)

from torch_port_utils import release_jax_executables  # noqa: F401  (autouse)

torch.set_num_threads(1)


@pytest.mark.parametrize("R,L", [(3, 8), (2, 6), (1, 2)])
def test_split_merge_match_jax(R, L):
    s = np.random.default_rng(L).random((R, L, L)) < 0.5
    eo = cb.split_colors(torch.from_numpy(s))
    np.testing.assert_array_equal(eo.numpy(), np.asarray(jcb.split_colors(jnp.asarray(s))))
    assert eo.shape == (R, 2, L, L // 2) and eo.dtype == torch.int8
    back = cb.merge_colors(eo)
    np.testing.assert_array_equal(back.numpy(), np.asarray(jcb.merge_colors(jnp.asarray(eo.numpy()))))
    np.testing.assert_array_equal(back.numpy().astype(bool), s)


@pytest.mark.parametrize("L", [8, 6])
def test_compact_neighbour_sums_match_full_field(L):
    sf = torch.from_numpy(np.random.default_rng(L).integers(0, 2, (2, L, L)).astype(np.int64))
    full = (torch.roll(sf, 1, -1) + torch.roll(sf, -1, -1)
            + torch.roll(sf, 1, -2) + torch.roll(sf, -1, -2))
    want = cb.split_planes(full)
    eo = cb.split_planes(sf)
    for c in (0, 1):
        assert torch.equal(cb.plane_neighbour_sums(eo[:, 1 - c], c), want[:, c])


M32 = 0xFFFFFFFF


@pytest.mark.parametrize("ctr,key,want", [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((M32,) * 4, (M32, M32), (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
])
def test_philox_known_answers(ctr, key, want):
    got = cb.philox4x32(*ctr, *key)
    assert tuple(int(w) for w in got) == want


def test_plane_uniforms_follow_the_counter_layout():
    """Site i of plane c in sweep t of replica r draws word i % 4 of
    Philox((i // 4, t, c, r), seed words): the layout the CUDA kernel
    shares, whatever its launch geometry. L=6 makes groups straddle rows."""
    seed, R, L, t = (7 << 32) + 12345, 3, 6, 4
    k0, k1 = cb.seed_words(seed)
    assert (k0, k1) == (12345, 7)
    for c in (0, 1):
        u = cb.plane_uniforms(seed, R, L, t, c, "cpu").reshape(R, -1)
        for r, i in itertools.product(range(R), range(L * L // 2)):
            word = int(cb.philox4x32(i // 4, t, c, r, k0, k1)[i % 4])
            assert float(u[r, i]) == (word >> 8) * 2.0 ** -24


@pytest.mark.parametrize("h", [0.0, 0.5])
@pytest.mark.parametrize("beta", [0.3, 0.6])
def test_plain_planes_equal_full_field_and_jax(beta, h):
    """Three sweeps at L=8, R=16, j=-1 with JAX's own uniforms: K1's plain
    half-sweeps on the compact split of the uniforms equal the port's
    full-field ``checkerboard_sweep`` bit for bit, and both equal JAX's
    ``checkerboard_sweep`` in every replica whose draws sit clear of their
    thresholds."""
    R, L, j = 16, 8, -1.0
    spins = np.random.default_rng(1).random((R, L, L)) < 0.5
    table = cb.accept_table(beta, j, h, "cpu")

    def planes(sp, *us):
        eo = cb.split_colors(sp)
        for u in us:
            for c in (0, 1):
                eo = cb.half_sweep(eo, c, cb.split_planes(u[c])[:, c], table)
        return cb.merge_colors(eo).to(torch.bool)

    def full(sp, *us):
        for u in us:
            sp = tmetro.checkerboard_sweep(sp, u, beta, j, h)
        return sp

    keys = jax.random.split(jax.random.key(int(10 * beta + 4 * h)), 3)
    us = [checkerboard_uniforms(k, (R, L, L)) for k in keys]
    sp = torch.from_numpy(spins)
    assert torch.equal(planes(sp, *us), full(sp, *us))

    want = jnp.asarray(spins)
    for k in keys:
        want = jmetro.checkerboard_sweep(want, k, jnp.float32(beta), jnp.float32(j),
                                         jnp.float32(h))
    decided, got = decided_replicas(lambda *u: full(sp, *u), *us)
    assert_equal_where_decided(got, want, decided)
    assert not torch.equal(got, sp)


def test_wrapper_on_cpu_is_the_plain_version():
    sp = torch.from_numpy(np.random.default_rng(2).random((3, 6, 6)) < 0.5)
    ops.reset_launch_counts()
    got = ops.checkerboard_multi_sweep(sp, 11, 0.4, -1.0, 0.3, 5)
    want = ops.checkerboard_multi_sweep_plain(sp, 11, 0.4, -1.0, 0.3, 5)
    assert torch.equal(got, want) and got.dtype == torch.bool
    assert not torch.equal(got, sp)
    assert torch.equal(ops.checkerboard_multi_sweep_global(sp, 11, 0.4, -1.0, 0.3, 5), want)
    assert torch.equal(ops.checkerboard_multi_sweep_tiles(sp, 11, 0.4, -1.0, 0.3, 5), want)
    assert torch.equal(ops.checkerboard_multi_sweep_tiles(sp, 11, 0.4, -1.0, 0.3, 5, k=2, ty=2,
                                                          tx=2), want)
    assert ops.launch_counts()["checkerboard_multi_sweep"] == 0
    assert ops.launch_counts()["checkerboard_multi_sweep_global"] == 0
    assert ops.launch_counts()["checkerboard_multi_sweep_tiles"] == 0


def test_odd_l_raises():
    sp = torch.zeros((2, 5, 5), dtype=torch.bool)
    with pytest.raises(ValueError, match="even L"):
        ops.checkerboard_multi_sweep(sp, 0, 0.4, -1.0, 0.0, 1)
    with pytest.raises(ValueError, match="even L"):
        LatticeIsing(5, replicas=2, device="cpu")


def _recording_launches(monkeypatch):
    """Force the kernel path for CPU tensors and record the entry points
    that would be called; nothing is launched."""
    names = []
    for k in (ops.checkerboard_multi_sweep, ops.checkerboard_multi_sweep_bands,
              ops.checkerboard_multi_sweep_tiles, ops.checkerboard_multi_sweep_global):
        monkeypatch.setattr(k, "launches", k.launches)  # restored afterwards
    monkeypatch.setattr(_build, "use_kernel", lambda device: True)
    monkeypatch.setattr(_build, "launch", lambda name, *args: names.append(name))
    monkeypatch.setattr(_build, "sm_count", lambda device: 132)
    return names


@pytest.mark.parametrize("L", [1362, 1368])
def test_l_above_shared_memory_raises_before_launch(monkeypatch, L):
    """No cluster of c <= 8 CTAs with L % c == 0 holds a band of L*L/c bytes
    (1362: 1362 % 8 != 0; 1368: one eighth is 233,928 bytes), so asking for
    a cluster raises before anything is launched or the card is asked, while
    the default takes K1's banded variant (here with the dispatch forced to
    the kernel path)."""
    names = _recording_launches(monkeypatch)
    sp = torch.zeros((1, L, L), dtype=torch.bool)
    with pytest.raises(ValueError, match="shared memory"):
        ops.checkerboard_multi_sweep(sp, 0, 0.4, -1.0, 0.0, 1, cluster=8)
    assert names == []
    ops.checkerboard_multi_sweep(sp, 0, 0.4, -1.0, 0.0, 1)
    assert names == ["ising_checkerboard_bands"]


def _takes_cluster(L):
    """Where a cluster of c in {1, 2, 4, 8} CTAs (c divides L) holds a band of
    L*L/c bytes plus the 40-byte table in 232,448 bytes."""
    return L <= 680 or (L % 4 == 0 and L <= 964) or (L % 8 == 0 and L <= 1360)


@pytest.mark.parametrize("R", [1, 2, 64, 256])
def test_k1_variant_rule(monkeypatch, R):
    """Over every even L up to 2100 and past the banded variant's limit: the
    cluster variant exactly where some cluster size holds the field (then
    at :func:`cluster_size`'s c, which is one of them), else the banded
    variant up to L = 5,404 and the tiled variant past it, which the
    dispatch launches (the banded one once a wave, the tiled one once a
    launch of its plan)."""
    names = _recording_launches(monkeypatch)
    for L in [*range(2, 2101, 2), 4096, 5402, 5404, 5406, 6000, 8192]:
        want = "cluster" if _takes_cluster(L) else "bands" if L <= 5404 else "tiles"
        assert cb.k1_variant(L) == want, L
        if want == "cluster":
            assert cb.cluster_size(R, L, 132) in cb.cluster_sizes(L)
        else:
            assert cb.cluster_sizes(L) == []
            with pytest.raises(ValueError, match="tiled variant"):
                cb.cluster_size(R, L, 132)
    if R > 2:
        return  # the dispatch below only at few replicas: the fields are large
    for L, entry in ((682, "ising_checkerboard_bands"), (684, "ising_checkerboard"),
                     (1360, "ising_checkerboard"), (2048, "ising_checkerboard_bands"),
                     (4096, "ising_checkerboard_bands"), (5406, "ising_checkerboard_tiles")):
        names.clear()
        ops.checkerboard_multi_sweep(torch.zeros((R, L, L), dtype=torch.bool), 0, 0.4,
                                     -1.0, 0.0, 1)
        waves = len(cb.k1_global_plan(R, L, 132).get("waves", [None]))
        n = {"ising_checkerboard_bands": waves,
             "ising_checkerboard_tiles": len(cb.k1_tile_plan(R, L, 1)["launches"])}
        assert names == [entry] * n.get(entry, 1), L


_BANDED_PLANS = (
    (2, 2048, 132, cb.MAX_SHARED_BYTES),   # one wave of 2 x 66 bands
    (2, 4096, 132, cb.MAX_SHARED_BYTES),   # a wave a replica, 132 bands
    (3, 4096, 132, cb.MAX_SHARED_BYTES),   # bands of 31 or 32 rows
    (1, 682, 132, cb.MAX_SHARED_BYTES),    # the first L no cluster holds
    (7, 1362, 132, cb.MAX_SHARED_BYTES),   # one wave, 18 bands a replica
    (7, 2048, 132, cb.MAX_SHARED_BYTES),   # waves of 6 and 1 replicas (22, 132 bands)
    (64, 2048, 132, cb.MAX_SHARED_BYTES),  # 11 waves: 19 bands a replica at the least
    (5, 5404, 132, cb.MAX_SHARED_BYTES),   # the largest L: every SM a band
    (3, 6, 132, cb.MAX_SHARED_BYTES),      # bands of one row
    (4, 2048, 64, 100_000),                # another card: a wave a replica
)


def test_k1_global_plan_bands_tile_and_fit():
    """The banded plan at each of ``_BANDED_PLANS`` (R, L, SMs, shared
    bytes): its waves take every replica once, in order; a wave's CTAs (a
    band each) never exceed the SMs (one CTA an SM); each replica's bands
    tile ``[0, L)`` in rows that differ by at most one; and the largest band
    plus its two halo rows of both planes fits the shared memory budget."""
    for case in _BANDED_PLANS:
        R, L, n_sms, smem = case
        plan = cb.k1_global_plan(R, L, n_sms, smem)
        assert plan["path"] == "bands", case
        assert [r0 for r0, _, _ in plan["waves"]] == list(
            np.cumsum([0] + [count for _, count, _ in plan["waves"]])[:-1]), case
        assert sum(count for _, count, _ in plan["waves"]) == R, case
        for r0, count, nb in plan["waves"]:
            assert 1 <= count * nb <= n_sms and nb <= L, case
            rows = cb.band_rows(L, nb)
            assert rows[0][0] == 0 and rows[-1][1] == L, case
            assert all(a[1] == b[0] for a, b in zip(rows, rows[1:])), case
            sizes = {y1 - y0 for y0, y1 in rows}
            assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1, case
            assert cb.band_smem_bytes(L, max(sizes)) <= smem, case


_PLAN_SWITCH_POINTS = (
    (5404, 132, cb.MAX_SHARED_BYTES, "bands"),    # 41 rows a CTA: 132 bands
    (5406, 132, cb.MAX_SHARED_BYTES, "tiles"),    # 40 rows a CTA: 136 bands
    (6000, 132, cb.MAX_SHARED_BYTES, "tiles"),
    (5406, 136, cb.MAX_SHARED_BYTES, "bands"),    # a card with more SMs
    (2048, 18, cb.MAX_SHARED_BYTES, "tiles"),     # 19 bands needed
    (2048, 19, cb.MAX_SHARED_BYTES, "bands"),
    (2048, 2048, 3 * 2048 + cb.TABLE_BYTES, "bands"),   # one row and two halo rows
    (2048, 2048, 3 * 2048 + cb.TABLE_BYTES - 1, "tiles"),
    (8200, 10_000, 10**9, "tiles"),   # 16-byte path over 1024 column quads a row
    (8196, 10_000, 10**9, "bands"),   # the byte path (H odd) takes any width
)


def test_k1_global_plan_switch_points():
    """Where the banded plan gives way to the tiled variant, at each of
    ``_PLAN_SWITCH_POINTS`` (L, SMs, shared bytes, path): a replica's bands
    need more CTAs than the SMs, a CTA cannot hold one row and its halo, or
    the 16-byte path's row of column quads needs more than 1024 threads."""
    for L, n_sms, smem, path in _PLAN_SWITCH_POINTS:
        plan = cb.k1_global_plan(1, L, n_sms, smem)
        assert plan["path"] == path, (L, n_sms, smem)
        if path == "tiles":
            assert plan == {"path": "tiles"}, (L, n_sms, smem)


def test_banded_wrapper_launches_a_wave_each(monkeypatch):
    """The banded wrapper (kernel branch forced, nothing launched): one
    entry-point call a wave with its first replica, replica count and bands,
    a halo scratch of two slots of two rows a CTA and zeroed flags a CTA,
    each call counted; and an L past the card's resident shared memory
    raises before any launch."""
    calls = []
    monkeypatch.setattr(ops.checkerboard_multi_sweep_bands, "launches", 0)
    monkeypatch.setattr(_build, "use_kernel", lambda device: True)
    monkeypatch.setattr(_build, "launch", lambda name, *args: calls.append((name, args)))
    monkeypatch.setattr(_build, "sm_count", lambda device: 132)
    R, L = 3, 4096
    ops.checkerboard_multi_sweep_bands(torch.zeros((R, L, L), dtype=torch.bool), 7, 0.4,
                                       -1.0, 0.0, 2)
    assert [c[0] for c in calls] == ["ising_checkerboard_bands"] * 3
    assert ops.checkerboard_multi_sweep_bands.launches == 3
    for (_, args), (r0, count, nb) in zip(calls, cb.k1_global_plan(R, L, 132)["waves"]):
        halo, flags = args[2], args[3]
        assert args[7:] == (L, 2, r0, count, nb)
        assert halo.numel() == 2 * count * nb * 2 * (L // 2) and halo.dtype == torch.uint8
        assert flags.shape == (count * nb,) and not flags.any()
    with pytest.raises(ValueError, match="tiled variant"):
        ops.checkerboard_multi_sweep_bands(torch.zeros((1, 5406, 5406), dtype=torch.bool), 7,
                                           0.4, -1.0, 0.0, 2)
    assert ops.checkerboard_multi_sweep_bands.launches == 3


# (R, L, nsweeps, SMs, shared bytes) of the tiled plan's checks.
_TILE_PLANS = (
    (1, 5406, 1, 132, cb.MAX_SHARED_BYTES),    # the first L past the banded variant (H odd)
    (1, 6000, 2, 132, cb.MAX_SHARED_BYTES),    # phase 6b's call
    (2, 6000, 3, 132, cb.MAX_SHARED_BYTES),
    (1, 8192, 100, 132, cb.MAX_SHARED_BYTES),
    (3, 5410, 7, 132, cb.MAX_SHARED_BYTES),    # H % 4 == 1
    (4, 2048, 9, 18, cb.MAX_SHARED_BYTES),     # a small card
    (2, 16, 5, 132, cb.MAX_SHARED_BYTES),
    (1, 8192, 4, 64, 100_000),                 # another card
)


def test_k1_tile_plan_tiles_and_fits():
    """The tiled plan at each of ``_TILE_PLANS``, and forced: the interiors
    tile ``[0, L)^2`` exactly once a replica; halos of 2k rows and of at
    least 2k columns (whole 4-site groups of a plane, so column origins on
    multiples of 8, where L % 8 == 0); the launches run the sweeps in order,
    at most k each; a CTA's shared memory, and ``ctas_per_sm`` of them on an
    SM, fit (plane rows padded to whole words); threads are whole rows of
    column quads. A forced shape is kept,
    and one that does not fit, is misaligned or is given in part raises."""
    forced = [(2, 16, 3, 1, 3, 8), (3, 6, 5, 2, 4, 2), (1, 16, 2, 2, 16, 16)]
    plans = [(case, cb.k1_tile_plan(*case)) for case in _TILE_PLANS]
    plans += [((R, L, n), cb.k1_tile_plan(R, L, n, k=k, ty=ty, tx=tx))
              for R, L, n, k, ty, tx in forced]
    for case, plan in plans:
        R, L, nsweeps = case[:3]
        smem = case[4] if len(case) > 3 else cb.MAX_SHARED_BYTES
        k, ty, tx = plan["k"], plan["ty"], plan["tx"]
        # The tiles are the products of row and column intervals: each set
        # of intervals covers [0, L) once.
        for t, n in ((ty, plan["ny"]), (tx, plan["nx"])):
            cover = np.zeros(L, np.int64)
            for x0 in range(0, n * t, t):
                cover[x0:x0 + t] += 1
                assert x0 < L and (t != tx or L % 8 or x0 % 8 == 0), case
            assert (cover == 1).all(), case
        assert plan["ny"] * plan["nx"] * R == plan["ctas"], case
        assert plan["halo_rows"] == 2 * k and plan["halo_cols"] >= 2 * k, case
        assert L % 8 or (tx % 8 == 0 and plan["halo_cols"] % 8 == 0), case
        quads = -(-(tx // 2 + plan["halo_cols"]) // 4)  # of a loaded plane row
        assert plan["smem_bytes"] == cb.tile_smem_bytes(L, k, ty, tx) == (
            2 * (ty + 2 * plan["halo_rows"]) * 4 * quads + cb.TABLE_BYTES), case
        m = plan["ctas_per_sm"]
        assert m * (plan["smem_bytes"] + cb.BLOCK_RESERVED_BYTES) <= (
            smem + cb.BLOCK_RESERVED_BYTES), case
        assert plan["threads"] % quads == 0 and 0 < plan["threads"] <= 1024 // m, case
        assert plan["launches"] == cb.tile_launches(nsweeps, k), case
        assert [t for t, _ in plan["launches"]] == list(range(0, nsweeps, k)), case
        assert sum(n for _, n in plan["launches"]) == nsweeps, case
        assert all(1 <= n <= k for _, n in plan["launches"]), case
        if len(case) > 3:  # the default plan
            assert k <= nsweeps and plan["seconds"] > 0, case
        else:
            assert (k, ty, tx) == forced[plans.index((case, plan)) - len(_TILE_PLANS)][3:]
    assert cb.tile_launches(0, 3) == [(0, 0)]
    for bad in ({"k": 2, "ty": 4, "tx": 12},    # L % 8 == 0: tx a multiple of 8
                {"k": 2, "ty": 4},               # given in part
                {"k": 8, "ty": 400, "tx": 512},  # 253,992 bytes of shared memory
                {"k": 0, "ty": 4, "tx": 8}):
        with pytest.raises(ValueError, match="k1_tile_plan"):
            cb.k1_tile_plan(1, 8192, 10, **bad)


def _tile_schedule(spins, seed, beta, j, h, plan):
    """``csrc/checkerboard_tiles.cu``'s schedule in plain torch: for each
    launch of ``plan``, each replica and tile loads the tile and its halos
    of both colour planes from the field the launch started from (rows and
    plane columns wrapped past L), runs the launch's half-steps on the
    loaded rows ``[s + 1, rows - 1 - s)`` with the draws of the sites'
    global counters and side neighbours wrapped inside the tile, and writes
    back its interior alone, which it asserts no wrapped read or stale row
    reached."""
    R, L, _ = spins.shape
    H = L // 2
    ty, tx, hr, hc = plan["ty"], plan["tx"], plan["halo_rows"], plan["halo_cols"] // 2
    rows, W = ty + 2 * hr, tx // 2 + 2 * hc
    table = cb.accept_table(beta, j, h, "cpu")
    k0, k1 = cb.seed_words(seed)
    field = spins
    for sweep0, sweeps in plan["launches"]:
        eo = cb.split_colors(field)
        new = torch.empty_like(eo)
        for r, y0, x0 in itertools.product(range(R), range(0, L, ty), range(0, H, tx // 2)):
            ys = (y0 - hr + torch.arange(rows)) % L
            cs = (x0 - hc + torch.arange(W)) % H
            t = eo[r][:, ys][:, :, cs].clone()
            site = ys[:, None] * H + cs[None, :]
            # Sites whose value may be wrong: read from a side neighbour
            # wrapped inside the tile, from such a site, or left stale.
            bad = torch.zeros((2, rows, W), dtype=torch.bool)
            edge = torch.zeros((rows, W), dtype=torch.bool)
            for s in range(2 * sweeps):
                col, rng = s % 2, slice(s + 1, rows - 1 - s)
                words = torch.stack(cb.philox4x32(site // 4, sweep0 + s // 2, col, r, k0, k1), -1)
                u = (words.gather(-1, (site % 4)[..., None])[..., 0] >> 8).float() * 2.0 ** -24
                back = ((ys % 2 == 0) == (col == 0))[:, None]

                def around(x):
                    side = torch.where(back, torch.roll(x, 1, 1), torch.roll(x, -1, 1))
                    return torch.roll(x, 1, 0) + torch.roll(x, -1, 0) + x + side

                ups = around(t[1 - col].long())
                flip = (u < table[t[col].long(), ups]).to(torch.int8)
                t[col, rng] ^= flip[rng]
                edge[:, 0], edge[:, -1] = back[:, 0], ~back[:, 0]
                moved = (around(bad[1 - col].long()) > 0) | edge
                bad[col, :s + 1] = bad[col, rows - 1 - s:] = True
                bad[col, rng] = moved[rng]
            ry, rx = min(ty, L - y0), min(tx // 2, H - x0)
            assert not bad[:, hr:hr + ry, hc:hc + rx].any()
            new[r, :, y0:y0 + ry, x0:x0 + rx] = t[:, hr:hr + ry, hc:hc + rx]
        field = cb.merge_colors(new).to(torch.bool)
    return field


def test_tile_schedule_equals_plain():
    """The tiled variant's schedule (:func:`_tile_schedule`) is
    ``torch.equal`` to ``checkerboard_multi_sweep_plain`` at tiny L with
    forced tiles: ragged last tiles, halos wider than L, nsweeps not a
    multiple of k, H % 4 != 0 (L = 6, 10) and the word path's column halo
    (L = 16, 24); and at the default plan of L = 16."""
    cases = [(2, 16, 5, 2, 5, 8), (1, 6, 3, 2, 4, 2), (2, 10, 7, 3, 3, 4),
             (1, 24, 11, 5, 7, 16), (1, 16, 4, None, None, None)]
    for R, L, nsweeps, k, ty, tx in cases:
        sp = torch.from_numpy(np.random.default_rng(L + nsweeps).random((R, L, L)) < 0.5)
        plan = cb.k1_tile_plan(R, L, nsweeps, k=k, ty=ty, tx=tx)
        want = ops.checkerboard_multi_sweep_plain(sp, 99, 0.5, -1.0, 0.2, nsweeps)
        assert torch.equal(_tile_schedule(sp, 99, 0.5, -1.0, 0.2, plan), want), (L, plan)
        assert not torch.equal(want, sp)


def test_tiles_wrapper_launches_its_plan(monkeypatch):
    """The tiled wrapper (kernel branch forced, nothing launched): a call of
    its entry point a launch of the plan, each counted, with the launch's
    first sweep and sweeps and the plan's k, tile and threads; the first
    reads the input, each next one the last one's output, the last writes
    the result, and no launch writes what it reads. A forced shape that
    does not fit raises before any launch."""
    calls = []
    monkeypatch.setattr(ops.checkerboard_multi_sweep_tiles, "launches", 0)
    monkeypatch.setattr(_build, "use_kernel", lambda device: True)
    monkeypatch.setattr(_build, "launch", lambda name, *args: calls.append((name, args)))
    monkeypatch.setattr(_build, "sm_count", lambda device: 132)
    R, L, nsweeps = 1, 5406, 5
    sp = torch.zeros((R, L, L), dtype=torch.bool)
    total = 0
    for forced in ({}, {"k": 2, "ty": 300, "tx": 246}):
        calls.clear()
        plan = cb.k1_tile_plan(R, L, nsweeps, 132, **forced)
        out = ops.checkerboard_multi_sweep_tiles(sp, 7, 0.4, -1.0, 0.0, nsweeps, **forced)
        total += len(plan["launches"])
        assert [c[0] for c in calls] == ["ising_checkerboard_tiles"] * len(plan["launches"])
        srcs, dsts = [c[1][0] for c in calls], [c[1][1] for c in calls]
        assert srcs[0] is sp and dsts[-1] is out and srcs[1:] == dsts[:-1]
        assert all(a is not b for a, b in zip(srcs, dsts))
        for (_, args), (t, n) in zip(calls, plan["launches"]):
            assert args[5:] == (R, L, t, n, plan["k"], plan["ty"], plan["tx"], plan["threads"])
    assert ops.checkerboard_multi_sweep_tiles.launches == total
    calls.clear()
    with pytest.raises(ValueError, match="shared memory"):
        ops.checkerboard_multi_sweep_tiles(sp, 7, 0.4, -1.0, 0.0, nsweeps, k=8, ty=400,
                                           tx=512)
    assert calls == []


@pytest.mark.parametrize("R,L,n_sms,want", [
    (64, 256, 132, 2),   # 128 CTAs fit one wave; 256 would take two
    (256, 256, 132, 1),  # two waves whatever c: the fewest CTAs
    (2, 1024, 132, 8),   # a quarter of 1024^2 exceeds a CTA's shared memory
    (64, 6, 132, 2),     # 6 % 4 != 0: the largest c that divides L
    (1, 1360, 132, 8),   # the largest L
    (16, 64, 132, 8),
    (8, 64, 16, 2),
])
def test_cluster_size_rule(R, L, n_sms, want):
    assert cb.cluster_size(R, L, n_sms) == want
    assert want in cb.cluster_sizes(L)


def test_cluster_sizes_divide_l_and_fit_shared_memory(monkeypatch):
    assert cb.cluster_sizes(256) == [1, 2, 4, 8]
    assert cb.cluster_sizes(482) == [1, 2]
    assert cb.cluster_sizes(484) == [2, 4]
    assert cb.cluster_sizes(1360) == [8]
    assert cb.cluster_sizes(1362) == cb.cluster_sizes(2048) == []
    with pytest.raises(ValueError, match="even L"):
        cb.cluster_sizes(1361)
    # A cluster size that does not divide L is refused before any launch.
    monkeypatch.setattr(_build, "use_kernel", lambda device: True)
    with pytest.raises(ValueError, match="cluster size"):
        ops.checkerboard_multi_sweep(torch.zeros((1, 8, 8), dtype=torch.bool),
                                     0, 0.4, -1.0, 0.0, 1, cluster=3)


@pytest.mark.cuda
def test_cuda_banded_kernel_equals_plain():
    """K1's banded variant on the card against its plain version: called
    directly at small L (the byte path at L=6 and 10, words at L=8 and 16,
    bands of one row), and through the default dispatch at L=1362 (byte
    path), 2048 (one wave), 4096 at R=2 and R=3 (a wave a replica, bands of
    31 or 32 rows), each wave a launch; the tiled variant past the card's
    resident shared memory (L=6000), a launch each of its plan."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc")
    for R, L, nsweeps in ((3, 6, 5), (2, 10, 3), (1, 8, 3), (3, 16, 4)):
        sp = torch.rand((R, L, L), device="cuda") < 0.5
        want = ops.checkerboard_multi_sweep_plain(sp, 3, 0.4, -1.0, 0.3, nsweeps)
        assert torch.equal(ops.checkerboard_multi_sweep_bands(sp, 3, 0.4, -1.0, 0.3, nsweeps),
                           want), (R, L)
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    for R, L, entry in ((1, 1362, "bands"), (2, 2048, "bands"), (2, 4096, "bands"),
                        (3, 4096, "bands"), (1, 6000, "tiles")):
        sp = torch.rand((R, L, L), device="cuda") < 0.5
        want = ops.checkerboard_multi_sweep_plain(sp, 5, 0.4, -1.0, 0.1, 2)
        ops.reset_launch_counts()
        got = ops.checkerboard_multi_sweep(sp, 5, 0.4, -1.0, 0.1, 2)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (R, L)
        counts = ops.launch_counts()
        want_launches = (len(cb.k1_global_plan(R, L, n_sms)["waves"]) if entry == "bands"
                         else len(cb.k1_tile_plan(R, L, 2, n_sms)["launches"]))
        assert counts["checkerboard_multi_sweep_" + entry] == want_launches
        assert counts["checkerboard_multi_sweep"] == 0


@pytest.mark.cuda
def test_cuda_tiled_kernel_equals_plain():
    """K1's tiled variant on the card against its plain version: at forced
    small tiles (ragged last tiles, halos wider than L, nsweeps not a
    multiple of k, the byte path at L = 6 and 10, the word path at L = 16
    and 24), and through the default dispatch at L = 5406 (R=1, 1 sweep),
    6000 (R=2, 3 sweeps) and 8192 (R=1, 2 sweeps), a launch each of its plan
    and none of the other variants."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc")
    for R, L, nsweeps, k, ty, tx in ((2, 16, 5, 2, 5, 8), (1, 6, 3, 2, 4, 2),
                                     (2, 10, 7, 3, 3, 4), (1, 24, 11, 5, 7, 16)):
        sp = torch.rand((R, L, L), device="cuda") < 0.5
        want = ops.checkerboard_multi_sweep_plain(sp, 3, 0.4, -1.0, 0.3, nsweeps)
        got = ops.checkerboard_multi_sweep_tiles(sp, 3, 0.4, -1.0, 0.3, nsweeps, k=k, ty=ty,
                                                 tx=tx)
        assert torch.equal(got, want), (R, L, k, ty, tx)
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    for R, L, nsweeps in ((1, 5406, 1), (2, 6000, 3), (1, 8192, 2)):
        sp = torch.rand((R, L, L), device="cuda") < 0.5
        want = ops.checkerboard_multi_sweep_plain(sp, 5, 0.4, -1.0, 0.1, nsweeps)
        ops.reset_launch_counts()
        got = ops.checkerboard_multi_sweep(sp, 5, 0.4, -1.0, 0.1, nsweeps)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (R, L)
        counts = ops.launch_counts()
        assert counts["checkerboard_multi_sweep_tiles"] == len(
            cb.k1_tile_plan(R, L, nsweeps, n_sms)["launches"])
        assert sum(counts.values()) == counts["checkerboard_multi_sweep_tiles"]


@pytest.mark.cuda
def test_cuda_kernel_equals_plain_and_refuses_large_l():
    """K1 against its plain version at every cluster size of L=8 and L=6
    (16-byte and byte paths), at R=64, L=256, and at L=1024 (c=8 only); its
    global variant at L=6, 8, 10 and 1368 (through the default dispatch);
    a cluster asked for at L=1368 raises."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc")
    for R, L, nsweeps in ((3, 8, 5), (3, 6, 5), (64, 256, 4), (2, 1024, 2)):
        sp = torch.rand((R, L, L), device="cuda") < 0.5
        want = ops.checkerboard_multi_sweep_plain(sp, 3, 0.4, -1.0, 0.3, nsweeps)
        for c in cb.cluster_sizes(L):
            got = ops.checkerboard_multi_sweep(sp, 3, 0.4, -1.0, 0.3, nsweeps, cluster=c)
            assert torch.equal(got, want), (R, L, c)
    for R, L, nsweeps in ((3, 6, 5), (3, 8, 5), (2, 10, 3), (1, 1368, 2)):
        sp = torch.rand((R, L, L), device="cuda") < 0.5
        want = ops.checkerboard_multi_sweep_plain(sp, 3, 0.4, -1.0, 0.3, nsweeps)
        got = ops.checkerboard_multi_sweep_global(sp, 3, 0.4, -1.0, 0.3, nsweeps)
        assert torch.equal(got, want), (R, L)
    assert torch.equal(ops.checkerboard_multi_sweep(sp, 3, 0.4, -1.0, 0.3, nsweeps), want)
    with pytest.raises(ValueError, match="shared memory"):
        ops.checkerboard_multi_sweep(torch.zeros((1, 1368, 1368), dtype=torch.bool,
                                                 device="cuda"), 0, 0.4, -1.0, 0.0, 1,
                                     cluster=8)


def _exact_mean_energy(L, beta, j, h):
    """<E> on the periodic L x L lattice by enumerating all 2^(L*L) states."""
    n = L * L
    idx = np.arange(1 << n, dtype=np.int64)
    s = (((idx[:, None] >> np.arange(n)) & 1) * 2 - 1).reshape(-1, L, L).astype(np.float64)
    e = j * ((s * np.roll(s, -1, 2)).sum((1, 2)) + (s * np.roll(s, -1, 1)).sum((1, 2)))
    e -= h * s.sum((1, 2))
    w = np.exp(-beta * (e - e.min()))
    return float((e * w).sum() / w.sum())


@pytest.mark.parametrize("beta,h", [(0.3, 0.0), (0.6, 0.3)])
def test_lattice_ising_matches_exact_enumeration(beta, h):
    """K1's plain version through ``LatticeIsing``: the mean energy of a 4x4
    lattice within 5 standard errors (over replicas) of exact enumeration.
    At beta=0.6 the chains start ordered along the field: from a random
    start half of them would sit in the reversed phase, whose escape over a
    16-bond domain-wall barrier takes ~10^4 sweeps."""
    L, R, j = 4, 256, -1.0
    state = None if beta < 0.5 else np.ones((L, L), bool)
    g = LatticeIsing(L, j=j, h=h, replicas=R, seed=5, state=state, device="cpu")
    g.run_sweeps(50, beta)
    es = []
    for _ in range(100):
        g.run_sweeps(2, beta)
        es.append(np_(g.get_energy()))
    per_replica = np.mean(es, axis=0)
    mean, se = per_replica.mean(), per_replica.std(ddof=1) / np.sqrt(R)
    exact = _exact_mean_energy(L, beta, j, h)
    assert abs(mean - exact) < 5 * se, (mean, se, exact)
    assert g.state_ref().shape == (R, L, L) and g.clone_state().dtype == bool
    assert np_(g.get_magnetization()).shape == (R,)
