"""Rank functions of the sharded tempering tests (``tests/test_torch_sharded.py``),
run by ``isingmontecarlo_tpu_torch.parallel._dist.spawn`` in spawned gloo
ranks on the CPU. This module imports torch and the port only: a spawned
rank imports it by name, and must not import JAX."""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from isingmontecarlo_tpu_torch import checkpoint, convert, lattice
from isingmontecarlo_tpu_torch.parallel import tempering as tpt
from isingmontecarlo_tpu_torch.parallel.tempering import TemperingContainer
from isingmontecarlo_tpu_torch.sse.ising import QmcIsingGraph

MODEL_LEAVES = ("bond_vars", "is_constant", "diag_w", "full_w", "cls", "wtab",
                "cls_full", "wtab_full")


class ListDraws:
    """One timestep's draws of one rank, computed beforehand: ``diagonal``,
    ``cluster`` (by shape), ``free_spins`` and ``swap`` tensors."""

    def __init__(self, draws: dict):
        self.d = draws

    def _take(self, name, shape):
        t = self.d[name] if name != "cluster" else self.d["cluster"][tuple(shape)]
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: drawn for {tuple(t.shape)}, asked for {tuple(shape)}")
        return t

    def diagonal(self, shape):
        return self._take("diagonal", shape)

    def cluster(self, shape):
        return self._take("cluster", shape)

    def free_spins(self, shape):
        return self._take("free_spins", shape)

    def swap(self, shape):
        return self._take("swap", shape)


def _local(case: dict, rank: int, world: int) -> dict:
    """The rank's block of a case's global numpy inputs, as tensors."""
    R = case["betas"].shape[0]
    cols = slice(rank * R // world, (rank + 1) * R // world)
    blk = {"sse": convert.sse_state_from_numpy(
        bond=case["bond"][:, cols], inputs=case["inputs"][:, :, cols],
        outputs=case["outputs"][:, :, cols], state=case["state"][cols], device="cpu")}
    for name in ("betas", "scales", "xors", "cum_max_w", "total"):
        blk[name] = None if case.get(name) is None else torch.from_numpy(
            np.ascontiguousarray(case[name][cols]))
    return blk


def run_chunk_cases(rank: int, world: int, cases: list) -> list:
    """``tempering_sweep_chunk_sharded`` on each case's block, drawing from
    ``case["draws"][rank]`` (a :class:`ListDraws` per timestep) or, where
    that is None, from :class:`~tempering.BlockDraws` on a generator seeded
    with ``case["seed"]``. Returns each case's rank outputs."""
    outs = []
    for case in cases:
        blk = _local(case, rank, world)
        model = convert.model_from_numpy(**{k: case["model"][k] for k in MODEL_LEAVES},
                                         offset=case["model"]["offset"],
                                         nvars=case["model"]["nvars"], device="cpu")
        hb = None
        if blk["cum_max_w"] is not None:
            hb = convert.heatbath_tables_from_numpy(blk["cum_max_w"].numpy(),
                                                    blk["total"].numpy(), device="cpu")
        if case["draws"] is not None:
            steps = iter([ListDraws(d) for d in case["draws"][rank]])
            next_draws = steps.__next__
        else:
            R = case["betas"].shape[0]
            R_l = R // world
            block = tpt.BlockDraws(torch.Generator().manual_seed(case["seed"]),
                                   rank * R_l, R_l, R)
            next_draws = lambda: block  # noqa: E731
        out = tpt.tempering_sweep_chunk_sharded(
            blk["sse"], blk["betas"], blk["scales"], case["parity"], case["do_swap"], model,
            len(case["do_swap"]), next_draws, hb=hb, heatbath=case["heatbath"],
            hetero=case["hetero"], collect_states=True, xors=blk["xors"],
            debug_rep_check=True)
        sse, betas, scales, xors, hb, parity, nswaps, ns, states, betas_t, fp = out
        outs.append({"bond": sse.ops.bond, "inputs": sse.ops.inputs,
                     "outputs": sse.ops.outputs, "state": sse.state, "betas": betas,
                     "scales": scales, "xors": xors,
                     "cum_max_w": None if hb is None else hb.cum_max_w,
                     "total": None if hb is None else hb.total,
                     "parity": int(parity), "nswaps": int(nswaps), "ns": ns,
                     "states": states, "betas_t": betas_t, "fingerprint": fp})
    return outs


def _ring_edges(js):
    return [((i, (i + 1) % 4), j) for i, j in enumerate(js)]


def container_oracles(rank: int, world: int, workdir: str) -> dict:
    """The JAX package's sharded oracles (``tests/test_tempering_sharded.py``)
    on the port's container and chunk, at 4x4 and the 4-site ring, R=16.
    Checks what one rank can check; returns what the ranks must agree on."""
    res = {}
    # Engaged after growth; labels conserved; every rank grows alike.
    calls = []
    orig = tpt.tempering_sweep_chunk_sharded

    def counting(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    tpt.tempering_sweep_chunk_sharded = counting
    try:
        bet = [0.5, 0.8, 1.1, 1.4, 1.7, 2.0, 2.3, 2.6]
        c = TemperingContainer(lattice.square(4, 4, j=1.0), 1.0, betas=bet,
                               replicas_per_beta=2, seed=3,
                               transverse_scales=[1.0 + 0.02 * i for i in range(8)],
                               device="cpu")
        c.shard_over()
        states, bets = c.timesteps_sample(48, swap_freq=2, sampling_freq=8)
    finally:
        tpt.tempering_sweep_chunk_sharded = orig
    assert calls, "the sharded chunk never ran after the growth phase"
    assert c.verify()
    want = sorted(np.repeat(np.asarray(bet, np.float32), 2).tolist())
    assert sorted(c._global(c.betas).tolist()) == want
    assert tuple(states.shape) == (6, 16, 16) and tuple(bets.shape) == (6, 16)
    assert c.graph.replicas == 4 and c.replicas == 16 and c.num_graphs() == 16
    res["grown"] = (c.graph.cutoff, c.graph._cluster_caps, c.graph._growth_pending,
                    c._parity, c.get_total_swaps())
    res["samples"] = (states, bets)
    res["by_temperature"] = c.states_by_temperature()
    res["class_scales"] = c.class_scales

    # A signed ladder swaps, and its sign patterns are conserved.
    tc = tpt.new_with_rng(seed=13, device="cpu")
    tc.add_qmc_stepper(QmcIsingGraph(_ring_edges([1.0] * 4), 1.0, replicas=8, seed=3,
                                     device="cpu"), 1.0)
    tc.add_qmc_stepper(QmcIsingGraph(_ring_edges([-1.0, 1.0, 1.0, 1.0]), 1.0, replicas=8,
                                     seed=4, device="cpu"), 1.0)
    tc.shard_over()
    tc.timesteps_sample(32, swap_freq=2, chunk=8)
    assert tc.verify()
    assert tc.get_total_swaps() > 0, "the signed sharded ladder never swapped"
    x0 = np.sort(tc._global(tc.xors)[:, 0].numpy())
    np.testing.assert_array_equal(x0, np.r_[np.zeros(8), np.ones(8)])
    res["signed_swaps"] = tc.get_total_swaps()

    def flat(betas, seed):
        t = TemperingContainer(lattice.square(4, 4, j=1.0), 1.0, betas=betas, seed=seed,
                               device="cpu")
        t.graph.set_cutoff(64)
        t.shard_over()
        return t

    # Equal betas: log p = 0, so every pair of each parity swaps.
    t = flat([1.0] * 16, 0)
    g = t.graph
    out = tpt.tempering_sweep_chunk_sharded(g.sse, t.betas, t.scales, 0, [True] * 4, g.model,
                                            4, t._draws)
    assert int(out[6]) == 8 + 7 + 8 + 7, int(out[6])

    # Replicas on other ranks and lanes of one rank draw other streams.
    t = flat([1.2] * 16, 5)
    g = t.graph
    out = tpt.tempering_sweep_chunk_sharded(g.sse, t.betas, t.scales, 0, [False] * 6, g.model,
                                            6, t._draws)
    res["independent_bond"] = out[0].ops.bond

    # The fingerprints of what every rank computed alike agree.
    t = flat(np.linspace(0.6, 2.0, 16), 9)
    g = t.graph
    out = tpt.tempering_sweep_chunk_sharded(g.sse, t.betas, t.scales, 0, [True] * 4, g.model,
                                            4, t._draws, debug_rep_check=True)
    fp = out[-1]
    assert tuple(fp.shape) == (world, 4) and torch.equal(fp, fp[:1].expand_as(fp)), fp
    res["fingerprint"] = fp

    # Refusal: R not a multiple of the world size.
    try:
        flat([1.0] * 6, 0)
    except ValueError as e:
        assert "not divisible" in str(e)
    else:
        raise AssertionError("shard_over took 6 replicas over 4 ranks")

    # Round trip: saved, run, loaded, sharded again and run: equal.
    c = TemperingContainer(lattice.square(4, 4, j=1.0), 1.0, betas=np.linspace(0.5, 2.0, 8),
                           replicas_per_beta=2, transverse_scales=np.linspace(0.7, 1.3, 8),
                           seed=5, device="cpu")
    c.set_enable_heatbath(True)
    c.shard_over()
    c.timesteps_sample(12, chunk=4)
    path = f"{workdir}/sharded.npz"
    checkpoint.save_tempering(path, c)

    def parts(x):
        return (*x.graph.sse.ops, x.graph.sse.state, x.betas, x.scales, x._hb.cum_max_w,
                torch.tensor([x._parity, x.total_swaps]))

    c.timesteps_sample(6, chunk=3)
    r = checkpoint.load_tempering(path, device="cpu")
    r.shard_over()
    r.timesteps_sample(6, chunk=3)
    assert all(torch.equal(a, b) for a, b in zip(parts(c), parts(r))), "resumed chain differs"
    assert r.graph._cluster_caps == c.graph._cluster_caps
    res["resumed_swaps"] = r.total_swaps

    # Loaded with a seed, the ranks draw from that seed: two seeds, two
    # chains; one seed twice, one chain.
    def reseeded(seed):
        x = checkpoint.load_tempering(path, seed=seed, device="cpu")
        x.shard_over()
        x.timesteps_sample(6, chunk=3)
        return parts(x)

    a, b, a2 = reseeded(1), reseeded(2), reseeded(1)
    assert all(torch.equal(x, y) for x, y in zip(a, a2)), "one seed gave two chains"
    assert not torch.equal(a[0], b[0]), "seeds 1 and 2 gave one chain"

    # The file holds four ranks' generators: two ranks refuse them, and take
    # a seed.
    pair = dist.new_group([0, 1])
    if rank < 2:
        x = checkpoint.load_tempering(path, device="cpu")
        try:
            x.shard_over(pair)
        except ValueError as e:
            assert "generators of 4 ranks" in str(e)
        else:
            raise AssertionError("shard_over resumed four ranks' generators on two")
        assert x._shard is None and x.graph.replicas == 16
        x = checkpoint.load_tempering(path, seed=1, device="cpu")
        x.shard_over(pair)
        x.timesteps_sample(3, chunk=3)
        assert x.verify()
    return res
