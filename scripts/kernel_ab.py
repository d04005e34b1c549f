#!/usr/bin/env python3
"""Time kernels K1, K2, K3, K3-hb and K4 and the 32x32 SSE sweeps of one
checkout of the PyTorch port on one CUDA GPU, for comparing two checkouts
on one card.

    python3 scripts/kernel_ab.py CHECKOUT LABEL

imports ``isingmontecarlo_tpu_torch`` from the directory CHECKOUT (its
kernels build there at first use) and prints lines of results and, last,
one JSON object tagged LABEL. Run it in turns, for example parent, change,
change, parent, in one session on one card: times move between cards and
with the host's load. What it measures, each on the card:

- K1 at L=256, 100 sweeps, J=-1, beta=0.4, R=64 and R=256, with the
  checkout's own launch geometry: device ms per call (``torch.profiler``)
  and ms per call from CUDA events (host included);
- K2 (``parity_bits``) at K=2, M=7000, R=256, N=1024 on random inputs
  (distinct legs a slot, 10% sentinels), device ms per call (all of a
  call's kernels), and its device ms per sweep in the 32x32 Metropolis
  sweep (by kernel name);
- K4's ``take0`` on one [7000, 256] grid into an [8000, 256] table, device
  ms, beside ``torch.gather``'s;
- K3 and K3-hb (``carry_decisions``, ``carry_decisions_heatbath``) at
  M=7000, R=256 on random inputs, device ms per call, and at R=32, 1024
  and 4224 (one CTA, 32 CTAs and one on each of 132 SMs in this design);
- one hook-and-compress round on 8000 labels, 7000 edges, R=256, as the
  checkout's ``hook_compress_labels`` runs it (without the host read),
  device ms;
- the SSE 32x32 Metropolis sweep (Gamma=1, beta=1, R=256, cluster update
  every sweep): wall ms per sweep over 16 sweeps (host clock around work
  that ends in a synchronize), and under the profiler the device ms per
  sweep, the device events per sweep, and the label stage's device ms per
  sweep: K4's kernels by name, and the kernels that PyTorch's operators
  launched inside ``hook_compress_labels`` and inside the flip decisions'
  gathers (the profiler ties a kernel to an enclosing range only when an
  operator launched it, not a ctypes call, so the K4 kernels are counted
  by name); and, from the same profile of the Metropolis sweep and of a
  heat-bath sweep (``set_enable_heatbath(True)``, cutoff hint 6944), K3's
  and K3-hb's device ms per sweep by kernel name.

Imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch


K4_KERNELS = ("take0_kernel", "hook_min_kernel", "pointer_jump_kernel")


# K2's kernels in a profile: this design's three (``parity_segments``,
# ``parity_prefix``, ``parity_bits``) or the earlier design's two.
K2_KERNELS = ("parity_", "segment_toggles_kernel")

# The carry kernels' names in a profile: this design's (template argument)
# or the earlier one's.
CARRY_KERNELS = {"k3": ("Metropolis", "carry_metropolis_kernel"),
                 "k3hb": ("HeatBath", "carry_heatbath_kernel")}


def device_ms(fn, reps: int, ranges: tuple[str, ...] = ()) -> tuple[float, dict, float, float,
                                                                     dict]:
    """Device ms per call over ``reps`` calls (after one warm-up), the
    device ms per call of the operators' kernels inside each
    ``record_function`` range named in ``ranges``, the device events per
    call, the device ms per call of K4's kernels, and that of K2's, K3's
    and K3-hb's (by the keys of CARRY_KERNELS, and "k2")."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    # A range shows twice: as a host event, whose device time is that of the
    # kernels launched inside it, and as a span on the device timeline
    # (gaps included), which is left out.
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    events = prof.key_averages()
    dev = [e for e in events if e.device_type == cuda and e.key not in ranges]
    per_range = {e.key: e.device_time_total / 1e3 / reps for e in events
                 if e.key in ranges and e.device_type == cpu}
    k4 = sum(e.self_device_time_total for e in dev if any(k in e.key for k in K4_KERNELS))
    carry = {name: sum(e.self_device_time_total for e in dev if any(k in e.key for k in keys))
             / 1e3 / reps for name, keys in {**CARRY_KERNELS, "k2": K2_KERNELS}.items()}
    return (sum(e.self_device_time_total for e in dev) / 1e3 / reps, per_range,
            sum(e.count for e in dev) / reps, k4 / 1e3 / reps, carry)


def events_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def main() -> None:
    checkout, label = sys.argv[1], sys.argv[2]
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: needs a CUDA GPU")
    sys.path.insert(0, checkout)
    from isingmontecarlo_tpu_torch import lattice, ops
    from isingmontecarlo_tpu_torch.sse import QmcIsingGraph, multi_sweep
    from isingmontecarlo_tpu_torch.sse import cluster as cl

    if not cl.__file__.startswith(checkout.rstrip("/")):
        raise SystemExit(f"kernel_ab: imported {cl.__file__}, not from {checkout}")
    dev = torch.device("cuda", 0)
    out = {"label": label, "checkout": checkout}
    gen = torch.Generator(device=dev).manual_seed(0)

    for R in (64, 256):
        sp = torch.rand((R, 256, 256), generator=gen, device=dev) < 0.5

        def k1():
            return ops.checkerboard_multi_sweep(sp, 1, 0.4, -1.0, 0.0, 100)

        out[f"k1_R{R}_device_ms"] = device_ms(k1, 10)[0]
        out[f"k1_R{R}_call_ms"] = events_ms(k1, 10)

    rng = np.random.default_rng(0)
    S, E, R = 8000, 7000, 256

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(dev)

    table = t(rng.integers(0, S, size=(S, R)))
    idx = t(rng.integers(0, S, size=(E, R)))
    idx64 = idx.long()
    out["take0_one_grid_device_ms"] = device_ms(lambda: ops.take0(table, idx), 100)[0]
    out["gather_one_grid_device_ms"] = device_ms(lambda: torch.gather(table, 0, idx64), 100)[0]

    # K2 at the 32x32 shape: the two legs of a slot name different variables.
    K2, M2, N2 = 2, 7000, 1024
    v0 = rng.integers(0, N2, size=(M2, R))
    v_idx = np.stack([v0, (v0 + 1 + rng.integers(0, N2 - 1, size=(M2, R))) % N2])
    v_idx[rng.random((K2, M2, R)) < 0.1] = N2
    vq = rng.integers(0, N2, size=(K2, M2, R))
    vq[rng.random((K2, M2, R)) < 0.1] = N2
    k2_args = (torch.from_numpy(rng.random((R, N2)) < 0.5).to(dev), t(v_idx),
               torch.from_numpy(rng.random((K2, M2, R)) < 0.3).to(dev), t(vq))
    out["k2_device_ms"] = device_ms(lambda: ops.parity_bits(*k2_args), 50)[0]

    # K3 and K3-hb at the 32x32 shape: n0 near 0.6 M, masks and numerators
    # on the scale of M - n, so both outcomes occur.
    M = 7000
    for Rc in (R, 32, 1024, 4224):
        n0 = t(rng.integers(M // 2, 2 * M // 3, size=Rc))
        u0 = torch.from_numpy(rng.random((M, Rc), dtype=np.float32)).to(dev)
        idp = torch.from_numpy(rng.random((M, Rc)) < 0.4).to(dev)
        dgp = ~idp & torch.from_numpy(rng.random((M, Rc)) < 0.9).to(dev)
        num_ins = torch.from_numpy(rng.uniform(0, 0.6 * M, (M, Rc)).astype(np.float32)).to(dev)
        num_rem = torch.from_numpy(rng.uniform(0, 1.2 * M, (M, Rc)).astype(np.float32)).to(dev)
        insw = torch.from_numpy(rng.random((M, Rc)) < 0.7).to(dev)
        bwt = torch.from_numpy(rng.uniform(0.5 * M, 0.9 * M, Rc).astype(np.float32)).to(dev)
        tag = "" if Rc == R else f"_R{Rc}"
        out[f"k3{tag}_device_ms"] = device_ms(
            lambda: ops.carry_decisions(n0, u0, idp, dgp, num_ins, num_rem), 50)[0]
        out[f"k3hb{tag}_device_ms"] = device_ms(
            lambda: ops.carry_decisions_heatbath(n0, u0, idp, dgp, insw, bwt), 50)[0]

    # One round's body as the checkout's hook_compress_labels runs it, on
    # valid labels (P[x] <= x), without the host read.
    u, v = t(rng.integers(0, S - 1, size=(E, R))), t(rng.integers(0, S - 1, size=(E, R)))
    P1 = cl.hook_compress_labels(u, v, S)
    if hasattr(ops, "hook_min"):
        flag = torch.zeros(1, dtype=torch.int32, device=dev)

        def round_():
            return ops.pointer_jump(ops.hook_min(P1, u, v), P1, cl.N_COMPRESS, flag, 1)
    else:
        def round_():
            pu, pv = ops.take0(P1, u), ops.take0(P1, v)
            Pn = P1.scatter_reduce(0, torch.maximum(pu, pv).long(), torch.minimum(pu, pv),
                                   reduce="amin")
            for _ in range(cl.N_COMPRESS):
                Pn = ops.take0(Pn, Pn)
            return Pn, (Pn != P1).any()
    out["hook_round_device_ms"] = device_ms(round_, 50)[0]

    g = QmcIsingGraph(lattice.bench_two_d_periodic(32), 1.0, cutoff=6500, replicas=256,
                      seed=7, device=dev)
    g.timesteps(48, 1.0)

    def sweeps(n):
        # The checkout's multi_sweep returns (sse, ns, states) or, with RVB,
        # (sse, ns, states, successes).
        out = multi_sweep(g.sse, 1.0, g.model, n, lambda: g.draws,
                          cluster_caps=g._cluster_caps, **g._diag_args())
        g.sse = out[0]
        return out[1]

    sweeps(16).cpu()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sweeps(16).cpu()
    out["sse_wall_ms_per_sweep"] = 1e3 * (time.perf_counter() - t0) / 16

    # Label the stages: the hook, and the flip decisions' gathers (every
    # take0 outside the hook).
    from torch.profiler import record_function

    # The hook rounds run eagerly (hook_rounds, or hook_compress_labels in a
    # checkout before the stage graphs). A checkout that replays the
    # timestep's stages as CUDA graphs launches the flip gathers from the
    # graph, where no Python range reaches: its flip-gathers range reads 0.
    hook_name = "hook_rounds" if hasattr(cl, "hook_rounds") else "hook_compress_labels"
    hook, take0, in_hook = getattr(cl, hook_name), cl.take0, [False]

    def hook_ranged(*a, **k):
        in_hook[0] = True
        try:
            with record_function("labels: hook_compress_labels"):
                return hook(*a, **k)
        finally:
            in_hook[0] = False

    def take0_ranged(*a, **k):
        if in_hook[0]:
            return take0(*a, **k)
        with record_function("labels: flip gathers"):
            return take0(*a, **k)

    setattr(cl, hook_name, hook_ranged)
    cl.take0 = take0_ranged
    names = ("labels: hook_compress_labels", "labels: flip gathers")
    total, ranges, n_events, k4, carry = device_ms(lambda: sweeps(1), 4, names)
    setattr(cl, hook_name, hook)
    cl.take0 = take0
    out["sse_device_ms_per_sweep"] = total
    out["sse_device_events_per_sweep"] = n_events
    out["sse_k4_kernels_device_ms_per_sweep"] = k4
    out["sse_k3_device_ms_per_sweep"] = carry["k3"]
    out["sse_k2_device_ms_per_sweep"] = carry["k2"]
    out["sse_hook_operators_device_ms_per_sweep"] = ranges.get(names[0], 0.0)
    out["sse_flip_gathers_operators_device_ms_per_sweep"] = ranges.get(names[1], 0.0)
    out["sse_label_stage_device_ms_per_sweep"] = k4 + sum(ranges.values())
    # The sweep again without the ranges, as a check that they move nothing.
    total2 = device_ms(lambda: sweeps(1), 4)[0]
    out["sse_device_ms_per_sweep_without_ranges"] = total2

    # The heat-bath sweep: its device ms and K3-hb's, per sweep.
    g = QmcIsingGraph(lattice.bench_two_d_periodic(32), 1.0, cutoff=6944, replicas=256,
                      seed=7, device=dev)
    g.set_enable_heatbath(True)
    g.timesteps(48, 1.0)
    sweeps(16).cpu()
    total, _, n_events, _, carry = device_ms(lambda: sweeps(1), 4)
    out["sse_hb_device_ms_per_sweep"] = total
    out["sse_hb_device_events_per_sweep"] = n_events
    out["sse_hb_k3hb_device_ms_per_sweep"] = carry["k3hb"]
    out["card"] = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                  "--format=csv,noheader"], capture_output=True,
                                 text=True).stdout.strip()
    for k, val in out.items():
        print(f"{k}: {val}")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
