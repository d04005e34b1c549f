"""What decides ``correct``: chunks of the window, drawn from the seed, are
captured as the program enters and leaves them, and the plain reference
(:mod:`benchmark.reference`) replays each from the program's state at its
start on the same uniforms. Every number compared is a count of elements
that differ, with the limit 0.

The reference follows the program chunk by chunk from the program's own
state (its op string, spins, labels and cluster caps as the chunk begins):
the window's history is too long to replay. Within a chunk it takes nothing
from the program."""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from benchmark import draws
from benchmark.reference import sse as ref
from benchmark.reference import tempering as ref_pt

# Every comparison is exact.
LIMIT = 0


def snapshot(sse, **extra) -> dict:
    """Device copies of an ``SseState`` (op string and spins), and ``extra``."""
    ops, state = sse
    return {"bond": ops.bond.clone(), "ins": ops.inputs.clone(), "outs": ops.outputs.clone(),
            "state": state.clone(), **extra}


def to_host(snap: dict) -> dict:
    """Host arrays of a snapshot's tensors; generator states (keys ending in
    ``gen``) stay tensors."""
    return {k: (v.cpu().numpy() if isinstance(v, torch.Tensor) and not k.endswith("gen") else v)
            for k, v in snap.items()}


def _differ(a: np.ndarray, b: np.ndarray) -> int:
    """Elements that differ; every element where the shapes differ."""
    if a.shape != b.shape:
        return max(a.size, b.size)
    return int((a != b).sum())


def _restored(gen_state: torch.Tensor, device) -> Callable:
    """The uniforms a benchmark generator gave from ``gen_state`` on."""
    gen = torch.Generator(device=torch.device(device))
    gen.set_state(gen_state)
    return lambda shape: draws.uniform(gen, shape)


def _end(ops: ref.Ops, state: np.ndarray, **extra) -> dict:
    return {"bond": ops.bond, "ins": ops.ins, "outs": ops.outs, "state": state, **extra}


def graph_chunk(start: dict, model: ref.Tfim, beta: float, nsteps: int, device,
                precision: str = "float32") -> dict:
    """The reference's end of one chunk of a single graph: ``nsteps``
    timesteps from the program's state at the chunk's start, then the
    growth; the keys of the program's end snapshot."""
    ops = ref.Ops(start["bond"], start["ins"], start["outs"])
    state = start["state"]
    betas = np.full(state.shape[0], beta, np.float32)
    draw = _restored(start["gen"], device)
    ns = []
    for _ in range(nsteps):
        ops, state = ref.timestep(ops, state, betas, model, draw, start["caps"], device, precision)
        ns.append(ref.op_count(ops))
    caps = ref.cluster_caps(ops, model, start["caps"])
    return _end(ref.grow(ops), state, ns=np.stack(ns), caps=caps)


def ladder_chunk(start: dict, model: ref.Tfim, nsteps: int, lo: int, exchange: ref_pt.Exchange,
                 device, precision: str = "float32") -> dict:
    """The reference's end of one chunk of a rank's block of a sharded beta
    ladder: ``nsteps`` timesteps of the block at its labels, each followed by
    a neighbour swap over every rank's replicas (``exchange`` gathers the
    reference's own op counts and labels), then the growth on maxima over
    the ranks; the last timestep's spins and labels are the chunk's sample."""
    ops = ref.Ops(start["bond"], start["ins"], start["outs"])
    state = start["state"]
    betas = start["betas"].astype(np.float32)
    R_l = state.shape[0]
    parity = start["parity"]
    draw = _restored(start["gen"], device)
    draw_swap = _restored(start["swap_gen"], device)
    swaps = 0
    for _ in range(nsteps):
        ops, state = ref.timestep(ops, state, betas, model, draw, start["caps"], device, precision)
        n_all, b_all = exchange(ref.op_count(ops)), exchange(betas)
        perm, accepted = ref_pt.neighbour_swap(n_all, b_all, draw_swap((len(b_all),)), parity,
                                               device)
        betas = b_all[perm[lo:lo + R_l]]
        parity = 1 - parity
        swaps += accepted
    caps = ref.cluster_caps(ops, model, start["caps"])
    # The program takes the growth and the caps on maxima over the ranks.
    grown_m = int(exchange(np.array([ref.grow(ops).bond.shape[0]])).max())
    caps = tuple(int(c) for c in exchange(np.array(caps)).reshape(-1, 2).max(axis=0))
    pad = grown_m - ops.bond.shape[0]
    if pad > 0:
        ops = ref.Ops(np.concatenate([ops.bond, np.full((pad, R_l), -1, np.int32)]),
                      np.concatenate([ops.ins, np.zeros((2, pad, R_l), bool)], axis=1),
                      np.concatenate([ops.outs, np.zeros((2, pad, R_l), bool)], axis=1))
    return _end(ops, state, betas=betas, sample_state=state, sample_betas=betas, swaps=swaps,
                caps=caps)


def compare(want: dict, got: dict) -> dict:
    """Elements of ``got`` (what the program left) that differ from ``want``
    (the reference's end), by what they are: the op string and spins
    (``state``), the op count after every timestep (``ns``), the labels
    (``labels``), the chunk's sample (``sample``), the swaps accepted
    (``swaps``), the cluster caps (``growth``; the cutoff's growth shows in
    the op string's shape). The keys present in ``want`` are compared."""
    out = {"state": sum(_differ(want[k], got[k]) for k in ("bond", "ins", "outs", "state"))}
    if "ns" in want:
        out["ns"] = _differ(want["ns"], got["ns"])
    if "betas" in want:
        out["labels"] = _differ(want["betas"], got["betas"])
        out["sample"] = (_differ(want["sample_state"], got["sample_state"])
                         + _differ(want["sample_betas"], got["sample_betas"]))
        out["swaps"] = abs(int(want["swaps"]) - int(got["swaps"]))
    out["growth"] = int(tuple(want["caps"]) != tuple(got["caps"]))
    return out
