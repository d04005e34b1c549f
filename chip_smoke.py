#!/usr/bin/env python3
"""Drive the PyTorch port's SSE timestep, its generic engine, its classical
engine and its parallel tempering on one CUDA GPU and check them.

    python3 chip_smoke.py        # from the repository root, on a CUDA host

Phases, in order; any failed check raises, so the exit code is nonzero:

1. Host facts: the card's name and power limit (nvidia-smi), CUDA, nvcc.
2. Build the kernels from ``isingmontecarlo_tpu_torch/csrc``.
3. Each kernel against its plain PyTorch version on the card, at a small
   ragged shape and at the shapes of its main path (K2-K4: the 32x32 SSE
   slice; K1: the 256^2 lattice at R=64, 100 sweeps, at every cluster
   size, and 1024^2 at R=2): equal (``torch.equal``), with both times at
   the latter, and each kernel's bound (bytes or operations at the card's
   published peaks; for K1 also the instruction-issue bound of its inner
   loop's SASS, for K3 and K3-hb the bound of their carry chain in the
   SASS, for K2 the issue bound of its three kernels' loops). K1's banded
   variant at ragged L (called directly) and, through the default dispatch
   with its launches asserted, at L=1362, 2048 (R=2), 4096 (R=2 and 3: a
   launch a wave), timed at 2048^2, R=2 in turns with the global-memory
   variant (whose split between plane passes and half-steps is printed).
   K1's tiled variant, past the card's resident shared memory, at forced
   small tiles (ragged last tiles, halos wider than L, nsweeps not a
   multiple of k, H % 4 != 0) and, through the default dispatch with its
   launches asserted, at L=5406 (R=1, 1 sweep), 6000 (R=2, 3 sweeps) and
   8192 (R=1, 2 sweeps); timed in turns with the global-memory variant,
   which dispatch no longer reaches, at 5406^2 (the byte path) and 6000^2,
   R=1, 2 sweeps and at 8192^2, R=1, 100 sweeps (marginal attempts/s
   against 500 sweeps, and the tiled kernel's SASS issue bound). K2 at
   K = 1..6 on ragged shapes, each with distinct legs
   and with slots naming one variable on two and three toggled legs. K3
   and K3-hb also at ragged shapes and on tie-heavy inputs, whose slots sit
   on the comparisons' edge, timed on those too. K2's wide and
   global-memory variants at K = 1..6 on ragged shapes (the same two kinds
   of legs) and, through ``parity_bits`` with the launches asserted, at
   K=2, M=7000, R=64, N=36,864 (the wide variant, timed in turns with the
   global one) and N=60,000 (the global variant, timed). K4's three
   entry points (``take0`` on one and on two grids, ``hook_min``,
   ``pointer_jump``) beside ``torch.gather``, and one
   hook round as the port ran it before (gathers, ``scatter_reduce``,
   single jumps) beside the new one; K1's time at each cluster size at
   R=64 and R=256.
4. Physics: ``QmcIsingGraph`` on an 8-site TFIM chain against exact
   diagonalization, and ``verify()``.
5. The SSE main path: ``QmcIsingGraph`` on the 32x32 benchmark lattice at
   R=256, grown to steady state, then 16-step chunks; K2, K3 and K4's three
   entry points must have been launched by this run. Then the labels of
   the grown op string from the card equal those of the plain versions.
5b. The SSE heat-bath path: the same lattice and run with
   ``set_enable_heatbath(True)``; K2, K3-hb and K4 must have been launched
   and K3 (Metropolis) not. Its mean op count must agree with phase 5's
   (both chains sample one distribution) within 5 combined standard errors
   and 0.5%, and an 8-site heat-bath chain must match exact
   diagonalization. K3 and K3-hb equal their plain versions on the
   arguments of one call each recorded from the grown chains, and are timed
   on them. Then both 32x32 paths are timed in turns, and run 4 more sweeps
   each under ``torch.profiler``: device time by kernel (K3's and K3-hb's
   by name) and the busy share; no ``scatter_reduce`` may run.
6. The classical main path: ``LatticeIsing(256, j=-1, replicas=64)``
   against Onsager's energy and Yang's magnetization, its marginal
   spin-flip attempts/s, then the README's ``GraphState`` quickstart on the
   same lattice and worms on a small frustrated lattice; K1 must have been
   launched by this run.
6b. The classical path past shared memory: ``LatticeIsing(6000)`` and
   ``LatticeIsing(8192)`` through K1's tiled variant, each equal to the
   plain version on one call, and ``LatticeIsing(2048, replicas=2)``
   through its banded variant, equal to the plain version on one call,
   then its energy per site against Onsager's at beta=0.3; the banded
   variant and the tiled variant's planned launches, and neither the
   cluster kernel nor the global-memory variant, must have been
   launched.
7. The RVB path: ``QmcIsingGraph`` on the 16x16 benchmark lattice at
   R=16, beta=10, cutoff hint 14000, grown without RVB, then with
   ``set_run_rvb(True)`` (128 updates a timestep, the JAX suite's
   ``two_d_rvb_16`` row): ``verify()`` after every measured timestep, the
   op count unchanged across every RVB stage, the success rate in (0, 1),
   and K2, K3 and K4's three entry points launched. Prints ms per
   timestep and per RVB stage (host clock), host reads per timestep (the
   synchronising operations PyTorch reports), and under ``torch.profiler``
   the device ms per timestep split into the RVB stage and the rest, the
   device events and the busy share; the footprint of the largest RVB
   tensors here and for ``two_d_rvb_32``. Then a 4-site ring with RVB
   against exact diagonalization at h = 0 and h = 0.4, and a verify soak
   on 3x3 and frustrated 4x4 lattices.
8. The generic engine (``Qmc``, directed loops). (a) Phase 5's grown
   32x32 graph through ``into_qmc()`` with loops and clusters, R=256,
   beta=1: warm and measured timesteps, ``verify()`` after every measured
   one, K2, K3 and K4's three entry points launched, the mean op count
   against phase 5's (5 combined standard errors and 0.5%); then a short
   heat-bath run, K3-hb launched and K3 not. (b) The XXZ exchange of the
   JAX package's ``tests/test_sse.py:219-226`` on the lattice's 2048
   edges, R=256, beta=1, loops only, from a cold cutoff: ``verify()``
   after every timestep, K2 and K3 launched and K4 not, revert
   rate below 1. Each prints ms per timestep, ms per stage (diagonal,
   loops, cluster, free spins; host clock between synchronisations, in
   timesteps apart from the measured ones), the walks' hops an update
   (the longest walk and the mean), host reads an update and a timestep,
   the revert rate, device ms, events and busy share under the profiler
   (a timestep, and one loop update per hop run), and peak device memory.
   (c) Against dense ED within 5 standard errors: an 8-site XXZ chain
   with loops, the same with a forced cap of 16 hops (revert rate in
   (0.005, 0.95)), and a 3-spin model on a 6-site ring with a transverse
   field, whose diagonal update runs K2 at K=3.
9. Parallel tempering on one card (``TemperingContainer``). (a) 64 betas
   in [0.5, 1.5], 4 replicas each (R=256), on the 32x32 lattice,
   Metropolis: grown, warm, then 64 sweep+swap steps
   (``timesteps_sample(swap_freq=1)`` in chunks of 32), ``verify()``;
   K2, K3 and K4 launched; ms per sweep+swap, the neighbour levels'
   acceptance (min, median, max), host reads per chunk and of one swap
   alone beside the chunk's label hook rounds (a read each), the chunk in turns against a bare chunk (the same
   ``timesteps_sample`` entry with ``swap_freq`` past the chunk, so no
   swap) at the same labels, device ms, events and busy share under the
   profiler. (b) The same lattice at beta=1 with 64
   transverse scales in [0.5, 2] (geometric), 4 replicas each, heat-bath:
   K3-hb with per-replica tables and not K3. (c) Two 128-replica graphs at
   beta=1, the second with a seeded random half of the edges' signs
   flipped: sign patterns through the sweeps and swaps by
   ``log_weight_delta``; K4 launched more often than in (a) by
   ``fetch_xor``. (d) The 4-site heat-bath transverse ladder and the
   signed ladder of ``tests/test_tempering_hetero.py`` against ED within
   5 SE. (e) 9a's container, phase 5's graph and a ``Qmc`` saved, run,
   loaded and run again: ``torch.equal``. (f) The 176x176 benchmark
   lattice (N = 30,976, past K2's shared variant's limit) at beta=0.1,
   R=32, ``verify()`` after each timestep, N x M below 2^30, K2 through its
   wide variant alone; then ``parity_bits`` on the arguments of one call
   recorded from one more sweep: the wide variant alone, ``torch.equal`` to
   its plain version, timed there in turns with the global variant and
   split by pass: its row in the ``kernels`` line.
10. Parallel tempering sharded over the ranks of a ``torch.distributed``
   process group (``TemperingContainer.shard_over``), the ranks spawned by
   ``parallel._dist.spawn``. (a) 9a's ladder over four gloo ranks sharing
   the card, 64 replicas a rank: grown, warm, 64 measured sweep+swap steps
   in chunks of 32, then a fingerprinted chunk; every rank's ``verify()``,
   the gathered beta multiset, equal fingerprints and growth decisions, K2,
   K3 and K4 launched on every rank, the swap's gathered bytes equal to
   ``8 R`` a swap (``n i32[R]``, ``betas f32[R]``) and no ``[M, R_l]``
   tensor gathered; ms per sweep+swap per rank beside 9a's, the gathers of
   one swap timed alone (gloo through the host, on one card: no NVLink or
   NCCL number), and the same gathers of host copies, the neighbour
   levels' acceptance. (b) 9a's and 9c's grown
   containers: the sharded chunk on four gloo ranks, each on its block of
   one unsharded run's uniforms (``tempering.BlockDraws``), cap-less,
   ``torch.equal`` to ``tempering_sweep_chunk`` on those uniforms. (c) (a)
   through NCCL at world size 1, and over up to four cards where the host
   has them (else a line saying it ran on one card only). (d)
   ``tempering.dryrun_sharded`` on four gloo ranks of the card: a
   heterogeneous heat-bath ladder with per-replica tables, sharded, one
   chunk of two sweep+swap steps, then one RVB sweep; every rank verifies
   and agrees on the gathered op counts, betas and swap count, launched K2,
   K3-hb and K4, and gathered per swap the heat-bath rows and bond counts
   beside ``n``, ``betas`` and the scales.

Then one JSON line of per-kernel results, a line with the card's name and
power limit, and last a JSON line with the device. The script needs no
network and imports nothing of JAX.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time
import warnings

import numpy as np
import torch
import torch.distributed as dist

from isingmontecarlo_tpu_torch import GraphState, LatticeIsing, checkpoint, lattice, ops
from isingmontecarlo_tpu_torch.analysis import (
    effective_sample_size, integrated_autocorrelation_time,
)
from isingmontecarlo_tpu_torch.classical import metropolis, worm
from isingmontecarlo_tpu_torch.ops import _build
from isingmontecarlo_tpu_torch.ops import checkerboard as cb
from isingmontecarlo_tpu_torch.ops.diag_carry import tie_heavy_carry_inputs
from isingmontecarlo_tpu_torch.parallel import TemperingContainer, _dist, tempering
from isingmontecarlo_tpu_torch.sse import Qmc, QmcIsingGraph, multi_sweep, tfim_model
from isingmontecarlo_tpu_torch.sse import cluster as sse_cluster
from isingmontecarlo_tpu_torch.sse import diagonal as sse_diagonal
from isingmontecarlo_tpu_torch.sse import loops as sse_loops
from isingmontecarlo_tpu_torch.sse import runner as sse_runner
from isingmontecarlo_tpu_torch.sse import ising as sse_ising
from isingmontecarlo_tpu_torch.sse import rvb as sse_rvb
from isingmontecarlo_tpu_torch.sse.cluster import (
    N_COMPRESS, hook_compress_labels, segment_graph,
)
from isingmontecarlo_tpu_torch.sse.opstring import op_count

# Kernel shapes of the 32x32 slice at R=256: M ~ 7000 slots, N = 1024 spins,
# label problems of C ~ 8000 labels and E ~ 7000 edges, whose tables are
# gathered at the two [M, R] grids of the op sides.
K, M, R, N = 2, 7000, 256, 1024
C_TAKE, E_TAKE = 8000, 7000
# K1's main path: the 256^2 lattice, 64 replicas, J=-1, beta=0.4, calls of
# 100 sweeps (the JAX package's classical benchmark, bench.py:141-197).
L_CB, R_CB, SWEEPS_CB, BETA_CB = 256, 64, 100, 0.4
# K1 beyond one block's shared memory: only c = 8 CTAs a replica hold it.
L_BIG, R_BIG, SWEEPS_BIG = 1024, 2, 4
# K1 beyond every cluster's shared memory: its banded variant.
L_HUGE, R_HUGE, SWEEPS_HUGE = 2048, 2, 4
# K1 past the card's resident shared memory (one replica's bands would need
# more CTAs than SMs): its tiled variant, at 6000^2 and at 8192^2, the large
# periodic lattices of finite-size scaling (timed at 100 sweeps, and at 500
# for the marginal rate).
L_PAST, R_PAST, SWEEPS_PAST = 6000, 1, 2
L_FSS, SWEEPS_FSS = 8192, 100

# The RVB path: the JAX suite's two_d_rvb_16 row (bench.py:443-449, 285):
# Gamma=1, beta=10, R=16, (N + 1) // 2 = 128 updates a timestep, cutoff
# hint 14000; grown without RVB, then warm and measured timesteps with it.
RVB_L, RVB_R, RVB_BETA, RVB_CUTOFF = 16, 16, 10.0, 14000
RVB_GROW, RVB_WARM, RVB_STEPS = 200, 2, 6
# The deepest RVB row, two_d_rvb_32 (bench.py:297): footprint only.
RVB32_L, RVB32_R, RVB32_M = 32, 4, 68000

# The generic engine (phase 8): phase 5's grown 32x32 graph through
# into_qmc with loops (8a: warm, measured and staged timesteps, then a short
# heat-bath run), and the XXZ exchange of tests/test_sse.py:219-226 on the
# 2048 edges of the same lattice, loops only, from a cold cutoff (8b).
GEN_BETA, GEN_WARM, GEN_STEPS, GEN_STAGED, GEN_HB = 1.0, 4, 16, 4, 4
XXZ_GROW, XXZ_STEPS, XXZ_STAGED = 24, 8, 4
W_XXZ = np.array([[0.5, 0, 0, 0], [0, 1.0, 0.7, 0], [0, 0.7, 1.0, 0], [0, 0, 0, 0.5]])
# An Ising-symmetric diagonal 3-spin weight (entry i equals entry ~i).
W_3SPIN = np.array([1.5, 0.5, 1.0, 0.25, 0.25, 1.0, 0.5, 1.5])

# Published H100 SXM peaks (NVIDIA's data sheet): HBM bytes/s, and the
# float32 rate outside the tensor cores, used for K1's 32-bit integer work.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# K1's operations per attempt: a quarter of a Philox4x32-10 call (10 rounds
# of 2 mul-hi, 2 mul-lo and 4 XORs, 9 key bumps of 2 adds: 98) plus the
# neighbour sum (3 adds), table index, shift, int-to-float, multiply,
# compare and XOR (6).
K1_OPS_PER_ATTEMPT = 98 / 4 + 9
# Hopper issues one warp instruction per clock on each of an SM's four
# schedulers.
WARP_ISSUE_PER_CLOCK_PER_SM = 4

KERNEL_INFO = {
    "checkerboard_multi_sweep": ("isingmontecarlo_tpu_torch/csrc/checkerboard.cu",
                                 "isingmontecarlo_tpu/ops/checkerboard.py:117"),
    "checkerboard_multi_sweep_bands": ("isingmontecarlo_tpu_torch/csrc/checkerboard_bands.cu",
                                       "isingmontecarlo_tpu/ops/checkerboard.py:117"),
    "checkerboard_multi_sweep_tiles": ("isingmontecarlo_tpu_torch/csrc/checkerboard_tiles.cu",
                                       "isingmontecarlo_tpu/ops/checkerboard.py:117"),
    # No longer dispatched: timed in turns beside the tiled variant.
    "checkerboard_multi_sweep_global": ("isingmontecarlo_tpu_torch/csrc/checkerboard_global.cu",
                                        "isingmontecarlo_tpu/ops/checkerboard.py:117"),
    "parity_bits": ("isingmontecarlo_tpu_torch/csrc/parity_bits.cu",
                    "isingmontecarlo_tpu/ops/parity_kernel.py:95"),
    "parity_bits_wide": ("isingmontecarlo_tpu_torch/csrc/parity_bits.cu",
                         "isingmontecarlo_tpu/ops/parity_kernel.py:95"),
    "parity_bits_global": ("isingmontecarlo_tpu_torch/csrc/parity_bits_global.cu",
                           "isingmontecarlo_tpu/ops/parity_kernel.py:95"),
    "carry_decisions": ("isingmontecarlo_tpu_torch/csrc/carry_metropolis.cu",
                        "isingmontecarlo_tpu/ops/diag_carry.py:95"),
    "carry_decisions_heatbath": ("isingmontecarlo_tpu_torch/csrc/carry_heatbath.cu",
                                 "isingmontecarlo_tpu/ops/diag_carry.py:59"),
    # K4: the gather, and the hook and the jumps that took the TPU kernel
    # (through _take0_fast) in the hook of isingmontecarlo_tpu/sse/cluster.py:561-570.
    "take0": ("isingmontecarlo_tpu_torch/csrc/take0.cu",
              "isingmontecarlo_tpu/ops/take_kernel.py:84"),
    "hook_min": ("isingmontecarlo_tpu_torch/csrc/take0.cu",
                 "isingmontecarlo_tpu/ops/take_kernel.py:84"),
    "pointer_jump": ("isingmontecarlo_tpu_torch/csrc/take0.cu",
                     "isingmontecarlo_tpu/ops/take_kernel.py:84"),
}
SSE_K4 = ("take0", "hook_min", "pointer_jump")


T_START = time.perf_counter()


def phase(title: str) -> None:
    print(f"\n== {title} (at {time.perf_counter() - T_START:.1f} s)", flush=True)


def run(cmd: list[str]) -> str:
    return subprocess.run(cmd, check=True, capture_output=True, text=True).stdout.strip()


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call over ``reps`` calls after one warm-up,
    from CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_rows(prof, what: str) -> list:
    """The device-side rows (kernels, copies, memsets) of a finished
    ``torch.profiler`` session. Raises if it holds none or their time sums
    to 0: a device time is then not measured, and none is reported."""
    rows = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not rows or sum(e.self_device_time_total for e in rows) <= 0:
        raise AssertionError(f"the profile of {what} holds no device time")
    return rows


def profiled_rows(fn, reps: int, what: str, attempts: int = 3) -> list:
    """The device-side rows of ``reps`` calls of ``fn`` under
    ``torch.profiler``, after one warm-up. A session that records no device
    time, or fewer device events than half the calls (the profiler drops a
    short session's events now and then), is run again, up to ``attempts``
    sessions in all, and said so; then it raises."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(1, attempts + 1):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        try:
            rows = device_rows(prof, what)
            if 2 * sum(e.count for e in rows) < reps:
                raise AssertionError(f"the profile of {what} holds "
                                     f"{sum(e.count for e in rows)} device events")
            return rows
        except AssertionError:
            if attempt == attempts:
                raise
            print(f"profiler session {attempt} of {what} recorded no device time or too "
                  f"few device events; profiling again", flush=True)


def device_ms(fn, reps: int, attempts: int = 3) -> float:
    """Mean device milliseconds per call over ``reps`` calls after one
    warm-up: the kernels, copies and memsets they ran, summed from
    :func:`profiled_rows`, without the host's time between launches (which
    CUDA events around a short kernel would measure instead)."""
    rows = profiled_rows(fn, reps, f"{reps} calls", attempts)
    return sum(e.self_device_time_total for e in rows) / 1e3 / reps


def device_split(fn, reps: int, parts: dict, what: str) -> dict:
    """Device ms a call of ``fn`` by kernel, summed from
    :func:`profiled_rows` over ``reps`` calls into the parts of ``parts``
    ({part: a substring of the kernel's name}; every other row under
    "other")."""
    split = {}
    for e in profiled_rows(fn, reps, what):
        part = next((p for p, key in parts.items() if key in e.key), "other")
        split[part] = split.get(part, 0.0) + e.self_device_time_total / 1e3 / reps
    return split


def in_turns(fns: dict, reps: int) -> dict:
    """Device ms a call (:func:`device_ms`) of each of two entry points,
    timed in turns (a, b, b, a); returns {name: [both readings]}."""
    (a, fa), (b, fb) = fns.items()
    out = {a: [], b: []}
    for name, fn in ((a, fa), (b, fb), (b, fb), (a, fa)):
        out[name].append(device_ms(fn, reps))
    return out


def exact_tfim_energy(edges, gamma: float, beta: float, nvars: int,
                      h: float = 0.0) -> float:
    """<H> of ``sum J sz sz - gamma sum sx - h sum sz`` at ``beta`` by
    dense ED (spin true is sz = +1)."""
    dim = 1 << nvars
    idx = np.arange(dim)
    sz = np.where((idx[:, None] >> np.arange(nvars)) & 1, 1.0, -1.0)
    H = np.diag(sum(j * sz[:, a] * sz[:, b] for (a, b), j in edges) - h * sz.sum(axis=1))
    for v in range(nvars):
        H[idx ^ (1 << v), idx] -= gamma
    w = np.linalg.eigvalsh(H)
    z = np.exp(-beta * (w - w.min()))
    return float((w * z).sum() / z.sum())


def kernel_inputs(rng, dev, K, M, R, N) -> dict:
    """Random arguments of each kernel at one shape, with sentinel legs."""

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    v0 = rng.integers(0, N, size=(M, R))
    v_idx = np.stack([v0, (v0 + 1 + rng.integers(0, N - 1, size=(M, R))) % N])
    v_idx[rng.random((K, M, R)) < 0.1] = N
    vq = rng.integers(0, N, size=(K, M, R))
    vq[rng.random((K, M, R)) < 0.1] = N
    idp = rng.random((M, R)) < 0.4
    args = {
        "parity_bits": (t(rng.random((R, N)) < 0.5), t(v_idx.astype(np.int32)),
                        t(rng.random((K, M, R)) < 0.3), t(vq.astype(np.int32))),
        "carry_decisions": (
            t(rng.integers(M // 2, 2 * M // 3, size=R).astype(np.int32)),
            t(rng.random((M, R), dtype=np.float32)), t(idp),
            t(~idp & (rng.random((M, R)) < 0.9)),
            t(rng.uniform(0, 0.6 * M, (M, R)).astype(np.float32)),
            t(rng.uniform(0, 1.2 * M, (M, R)).astype(np.float32)),
        ),
    }
    # K3-hb shares K3's counts, uniforms and masks, and draws the rest from
    # a generator of its own. bwt = beta * sum_b max_w(b) is 5120 on the
    # 32x32 lattice at beta = 1, Gamma = 1: on the scale of M - n, so both
    # outcomes occur.
    hb_rng = np.random.default_rng(M * R)
    args["carry_decisions_heatbath"] = (
        *args["carry_decisions"][:4], t(hb_rng.random((M, R)) < 0.7),
        t(hb_rng.uniform(0.5 * M, 0.9 * M, R).astype(np.float32)),
    )
    return args


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(bytes_moved: float, operations: float = 0.0) -> dict:
    """The least time the card could take: the larger of the bytes over HBM
    bandwidth and the operations over the peak rate."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = operations / F32_OPS_PER_S
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


# Hopper's dependent-issue latency of the FP32 and integer ALU pipes, in
# clocks: the cost of each instruction on K3's carry chain.
ALU_LATENCY_CLOCKS = 4
# The carry kernels' template arguments, which name them in the SASS and in
# a profile.
CARRY_CHAINS = {"carry_decisions": "Metropolis", "carry_decisions_heatbath": "HeatBath"}

# An instruction, and the upper word of its encoding, whose bits 41-44 are
# the stall count that the compiler scheduled after it.
SASS_OP = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)\s*([^;]*);"
                     r"(?:\s*/\* 0x[0-9a-f]{16} \*/\s*/\* (0x[0-9a-f]{16}) \*/)?")
SASS_REG = re.compile(r"(?<![\w.])[-!|]?(U?R\d+|U?P\d)\b")
# Opcodes with no register result, and those with two predicate results.
SASS_NO_DEST = ("ST", "RED", "ATOM", "BRA", "BAR", "SYNCS", "EXIT", "NOP", "WARPSYNC", "RET",
                "CALL", "LDGSTS", "MEMBAR", "DEPBAR", "BSYNC", "BSSY", "YIELD", "UTMALDG")
SASS_TWO_DEST = ("FSETP", "ISETP", "DSETP", "HSETP2", "PSETP", "PLOP3")


def carry_chain(sass: str, chain: str) -> tuple[int, int, int, int] | None:
    """The carry chain of K3 or K3-hb (``chain`` names the kernel's template
    argument) in a ``cuobjdump -sass`` listing: in the straight-line block
    with the most byte stores to shared memory (the unrolled walk of a full
    tile, one code byte a slot), the longest run of dependent instructions
    from the registers that the block carries from one trip to the next
    (read before written) back to them. Returns (slots in the block, that
    run's length, the block's instructions, the clocks its compiled
    schedule stalls in all), or None."""
    func = re.search(r"Function : (\S*" + chain + r"\S*)\n(.*?)(?=\n\s*Function :|\Z)",
                     sass, re.S)
    if func is None:
        return None
    blocks, cur = [], []
    for m in SASS_OP.finditer(func.group(2)):
        op, args = m.group(3), [a for a in m.group(4).split(",") if a.strip()]
        nd = 0 if op.startswith(SASS_NO_DEST) else 2 if op.startswith(SASS_TWO_DEST) else 1
        dests = [r.group(1) for a in args[:nd] if (r := SASS_REG.search(a))]
        srcs = [r for a in args[nd:] for r in SASS_REG.findall(a)]
        if m.group(2):  # a guarded instruction also reads its guard and old result
            srcs += [m.group(2).strip().lstrip("@!")] + dests
        stall = int(m.group(5), 16) >> 41 & 0xF if m.group(5) else 0
        cur.append((op, dests, srcs, stall))
        if op.startswith(("BRA", "EXIT", "SYNCS.PHASECHK")):
            blocks.append(cur)
            cur = []
    block = max(blocks + [cur], key=lambda b: sum(i[0].startswith("STS.U8") for i in b))
    slots = sum(i[0].startswith("STS.U8") for i in block)
    written = {d for _, ds, _, _ in block for d in ds}
    seen, carried = set(), set()
    for _, ds, ss, _ in block:
        carried |= {r for r in ss if r in written and r not in seen}
        seen |= set(ds)
    depth = dict.fromkeys(carried, 0)
    for _, ds, ss, _ in block:
        on_chain = [depth[r] for r in ss if r in depth]
        for d in ds:
            if on_chain:
                depth[d] = max(on_chain) + 1
            else:
                depth.pop(d, None)
    ends = [depth[r] for r in carried if r in depth]
    stalls = sum(i[3] for i in block)
    return (slots, max(ends), len(block), stalls) if slots and ends else None


def carry_chain_bounds(M: int) -> dict:
    """Each carry kernel's chain bound, printed: M slots times its dependent
    instructions a slot (:func:`carry_chain` of ``cuobjdump -sass`` of the
    built library) times ALU_LATENCY_CLOCKS, at the card's maximum SM clock
    (nvidia-smi); or why it was not measured. Returns {name: ms}."""
    from pathlib import Path

    try:
        tool = Path(_build.nvcc_path()).parent / "cuobjdump"
        sass = run([str(tool), "-sass", str(_build.library_path())])
    except (OSError, RuntimeError, subprocess.CalledProcessError) as e:
        print(f"carry chain bounds: not measured ({e})", flush=True)
        return {}
    f_sm = 1e6 * float(run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                            "--format=csv,noheader,nounits"]))
    out = {}
    for name, chain in CARRY_CHAINS.items():
        found = carry_chain(sass, chain)
        if found is None:
            print(f"{name} chain bound: not measured (no carry walk found in the listing)",
                  flush=True)
            continue
        slots, length, issued, stalls = found
        out[name] = 1e3 * M * length / slots * ALU_LATENCY_CLOCKS / f_sm
        print(f"{name} chain bound: {length} dependent instructions over the {slots} slots of "
              f"a tile ({length / slots:.3f} a slot), x {ALU_LATENCY_CLOCKS} clocks at "
              f"{f_sm / 1e6:.0f} MHz, M={M}: {out[name]:.4f} ms; the walk issues {issued} "
              f"instructions a tile ({issued / slots:.2f} a slot), which its compiled "
              f"schedule spreads over {stalls / slots:.2f} clocks a slot", flush=True)
    return out


def sass_loops(sass: str, kernel: str) -> list[list[str]]:
    """The opcodes of each loop of the first function whose mangled name
    contains ``kernel`` in a ``cuobjdump -sass`` listing: every span from a
    backward branch's target to the branch."""
    func = re.search(r"Function : (\S*" + kernel + r"\S*)\n(.*?)(?=\n\s*Function :|\Z)", sass, re.S)
    if func is None:
        return []
    body = func.group(2)
    instrs = [(int(a, 16), op) for a, op in
              re.findall(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", body)]
    labels = {}
    for m in re.finditer(r"^\s*(\.L_x_\d+):", body, re.M):
        nxt = re.search(r"/\*([0-9a-f]{4,})\*/", body[m.end():])
        if nxt:
            labels[m.group(1)] = int(nxt.group(1), 16)
    loops = []
    # A branch names its target by label or by address, as the toolkit prints it.
    for m in re.finditer(r"/\*([0-9a-f]{4,})\*/[^\n]*?\bBRA\s+(?:`\((\.L_x_\d+)\)|0x([0-9a-f]+))",
                         body):
        at = int(m.group(1), 16)
        target = labels.get(m.group(2)) if m.group(2) else int(m.group(3), 16)
        if target is not None and target < at:
            loops.append([op for a, op in instrs if target <= a <= at])
    return loops


def inner_loop_instructions(sass: str, kernel: str = "checkerboard_kernelILb1E"
                            ) -> list[str] | None:
    """The opcodes of a K1 kernel's inner loop in a ``cuobjdump -sass``
    listing: in its 16-byte path (``checkerboard_kernel<true>``, or
    ``kernel``), the shortest loop that holds Philox's 20 multiplies (one
    4-site group per trip: the loop is not unrolled)."""
    loops = [span for span in sass_loops(sass, kernel)
             if sum(op.startswith("IMAD") for op in span) >= 20]
    return min(loops, key=len) if loops else None


def k1_issue_bound(attempts: int, kernel: str = "checkerboard_kernelILb1E",
                   label: str = "K1") -> float | None:
    """Print and return a K1 kernel's instruction-issue bound in ms: the
    SASS instructions of its inner loop (:func:`inner_loop_instructions` of
    ``cuobjdump -sass`` of the built library) for every 4-site group of
    ``attempts``, over four warp instructions per clock per SM at the card's
    maximum SM clock (nvidia-smi); or print why it was not measured."""
    from pathlib import Path

    try:
        tool = Path(_build.nvcc_path()).parent / "cuobjdump"
        loop = inner_loop_instructions(run([str(tool), "-sass", str(_build.library_path())]),
                                       kernel)
    except (OSError, RuntimeError, subprocess.CalledProcessError) as e:
        print(f"{label} issue bound: not measured ({e})", flush=True)
        return None
    if loop is None:
        print(f"{label} issue bound: not measured (no inner loop found in the listing)",
              flush=True)
        return None
    clocks = run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                  "--format=csv,noheader,nounits"]).split(",")
    f_sm = 1e6 * float(clocks[1])
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    warp_instrs = attempts / 4 / 32 * len(loop)
    ms = 1e3 * warp_instrs / (WARP_ISSUE_PER_CLOCK_PER_SM * n_sms * f_sm)
    print(f"{label} issue bound: {len(loop)} SASS instructions per 4-site group in the inner "
          f"loop ({len(loop) / 4:.2f} per attempt), {n_sms} SMs at {clocks[1].strip()} MHz "
          f"(now {clocks[0].strip()} MHz): {ms:.4f} ms for {attempts:.4e} attempts", flush=True)
    return ms


# K2's slots a warp walks per trip of its tile loop (kTileSlots in
# csrc/parity_bits.cu) and segment rows per trip of its prefix loop (kBatch).
K2_TILE_SLOTS = {1: 32, 2: 16}
K2_PREFIX_BATCH = 32


def k2_issue_bound(K: int, M: int, R: int, N: int) -> float | None:
    """Print K2's instruction-issue bound at (K, M, R, N) and return it in
    ms: for each of its three kernels, the SASS instructions of its longest
    loop (a tile of slots in ``parity_segments_kernel<K>`` and
    ``parity_bits_kernel<K, true>``, a batch of segment rows in
    ``parity_prefix_kernel``; from ``cuobjdump -sass`` of the built
    library) times the trips of this call's segments, over four warp
    instructions per clock per SM at the card's maximum SM clock. Or None,
    printing why it was not measured."""
    from pathlib import Path

    from isingmontecarlo_tpu_torch.ops import parity_kernel

    try:
        tool = Path(_build.nvcc_path()).parent / "cuobjdump"
        sass = run([str(tool), "-sass", str(_build.library_path())])
    except (OSError, RuntimeError, subprocess.CalledProcessError) as e:
        print(f"K2 issue bound: not measured ({e})", flush=True)
        return None
    names = {"segments": f"parity_segments_kernelILi{K}E", "walk": f"parity_bits_kernelILi{K}ELb1E",
             "prefix": "parity_prefix_kernel"}
    loops = {k: max(sass_loops(sass, v), key=len, default=None) for k, v in names.items()}
    if any(v is None for v in loops.values()):
        print(f"K2 issue bound: not measured (no loop found for "
              f"{[k for k, v in loops.items() if v is None]})", flush=True)
        return None
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    f_sm = 1e6 * float(run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                            "--format=csv,noheader,nounits"]))
    seg_len = parity_kernel.segment_length(M, R, n_sms)
    nseg, rgroups, tile = -(-M // seg_len), -(-R // 32), K2_TILE_SLOTS.get(K, 8)
    trips = {"segments": rgroups * (nseg - 1) * -(-seg_len // tile),
             "walk": rgroups * nseg * -(-seg_len // tile),
             "prefix": -(-(-(-N // 32) * R) // 32) * -(-nseg // K2_PREFIX_BATCH)}
    warp_instrs = sum(len(loops[k]) * trips[k] for k in loops)
    ms = 1e3 * warp_instrs / (WARP_ISSUE_PER_CLOCK_PER_SM * n_sms * f_sm)
    print(f"K2 issue bound at K={K}, M={M}, R={R}, N={N} ({nseg} segments of {seg_len} "
          f"slots): loops of {len(loops['segments'])}, {len(loops['walk'])} and "
          f"{len(loops['prefix'])} SASS instructions (a tile of {tile} slots, a tile of "
          f"{tile} slots, {K2_PREFIX_BATCH} segment rows) in the segments, walk and prefix "
          f"kernels, {warp_instrs:.4e} warp instructions over {n_sms} SMs at "
          f"{f_sm / 1e6:.0f} MHz: {ms:.4f} ms", flush=True)
    return ms


def parity_inputs(rng, dev, K: int, M: int, R: int, N: int, dup: bool = False) -> tuple:
    """Random arguments of K2 at any K, ~10% sentinel legs and queries. The
    K legs of a slot name distinct variables (``v0 + k * step`` mod N with
    ``K * step <= N``, as every TFIM bond's are distinct); with ``dup``, a
    fifth of the slots name leg 0's variable on leg 1 too, and (K >= 3) a
    tenth on legs 1 and 2 and another tenth on leg K - 1, with those legs
    toggled (a generic bond such as ``make_interaction(mat, [v, v])`` makes
    such slots)."""
    v0 = rng.integers(0, N, size=(M, R))
    step = rng.integers(1, max(1, N // K) + 1, size=(M, R))
    v = ((v0 + np.arange(K)[:, None, None] * step) % N).astype(np.int32)
    vq = rng.integers(0, N, size=(K, M, R)).astype(np.int32)
    tog = rng.random((K, M, R)) < 0.3
    if dup and K >= 2:
        for legs, frac in (([1], 0.2), ([1, 2], 0.1), ([K - 1], 0.1)):
            if max(legs) >= K:
                continue
            m = rng.random((M, R)) < frac
            for leg in legs:
                v[leg][m] = v[0][m]
                tog[leg][m] = True
            tog[0][m] = True
    v[rng.random((K, M, R)) < 0.1] = N
    vq[rng.random((K, M, R)) < 0.1] = N + 5
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in
                 (rng.random((R, N)) < 0.5, v, tog, vq))


def parity_equal(fn, label: str, cases, rng, dev) -> None:
    """``fn`` (a K2 entry point) ``torch.equal`` to the plain version at K =
    1..6 on each (M, R, N) of ``cases``, on inputs that hold slots with
    distinct legs and slots that name one variable on two and three toggled
    legs."""
    for k in range(1, 7):
        for m, r, n in cases:
            args = parity_inputs(rng, dev, k, m, r, n, dup=True)
            got, want = fn(*args), ops.parity_bits_plain(*args)
            torch.cuda.synchronize()
            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                raise AssertionError(f"{label} differs from its plain version at K={k}, "
                                     f"M={m}, R={r}, N={n}")
    print(f"{label} equal to plain at K = 1..6 on (M, R, N) in {list(cases)}, with distinct "
          f"legs and with slots naming one variable on two and three toggled legs", flush=True)


def check_parity(dev, rng, full: tuple) -> dict:
    """Phase 3 for K2: equal to the plain version at K = 1..6 on ragged
    shapes (R not a multiple of 4 or 32, M not a multiple of 4, N not a
    multiple of 32, one segment and many; distinct legs, and slots naming
    one variable on two and three toggled legs), and at the 32x32 shape (K=2,
    M=7000, R=256, N=1024), where both are timed (device ms by
    ``torch.profiler``, the three kernels of a call summed; CUDA events for
    a call), beside the byte bound and the SASS issue bound."""
    ragged = ((37, 5, 9), (301, 48, 40), (130, 33, 37), (7, 1, 6), (1000, 64, 70),
              (700, 256, 1024))
    parity_equal(ops.parity_bits, "parity_bits", ragged, rng, dev)
    got, want = ops.parity_bits(*full), ops.parity_bits_plain(*full)
    torch.cuda.synchronize()
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise AssertionError("parity_bits differs from its plain version at the 32x32 shape")
    err = max(float((g.to(torch.int64) - w.to(torch.int64)).abs().max())
              for g, w in zip(got, want))
    ms = device_ms(lambda: ops.parity_bits(*full), 50)
    call_ms = cuda_ms(lambda: ops.parity_bits(*full), 50)
    plain_ms = cuda_ms(lambda: ops.parity_bits_plain(*full), 3)
    # Each input read once and each output written once; K2 does a few
    # integer operations per byte, so bytes set this bound.
    res = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           **bound(nbytes(*full, *got)), "library_ms": None}
    K2, M2, R2 = full[1].shape
    issue = k2_issue_bound(K2, M2, R2, full[0].shape[1])
    print(f"parity_bits: equal to plain (max_abs_err {err}); kernels {ms:.4f} ms on the device "
          f"({call_ms:.4f} ms a call, CUDA events), plain {plain_ms:.4f} ms, bound "
          f"{res['bound_ms']:.4f} ms ({res['bound_by']}), issue bound "
          f"{issue if issue is None else f'{issue:.4f} ms'}; input shapes "
          f"{[tuple(a.shape) for a in full]}", flush=True)
    return res


def check_checkerboard(dev) -> dict:
    """Phase 3 for K1: kernel equals plain, at every cluster size, at
    ragged shapes (R=3, 5 sweeps, h != 0; L=6: the byte path, L=8: bands
    of 8 down to 1 rows), at the main-path shape, where both are timed, and
    at L=1024; then the kernel's time at each cluster size for R=64 and
    R=256."""
    gen = torch.Generator(device=dev).manual_seed(0)
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    cases = [
        (torch.rand((3, 6, 6), generator=gen, device=dev) < 0.5, 5, 0.7, -1.0, 0.3),
        # bands of one and two rows at c=8 and 4: both edge rows remote
        (torch.rand((3, 8, 8), generator=gen, device=dev) < 0.5, 5, 0.7, -1.0, 0.3),
        (torch.rand((R_BIG, L_BIG, L_BIG), generator=gen, device=dev) < 0.5,
         SWEEPS_BIG, BETA_CB, -1.0, 0.1),
        (torch.rand((R_CB, L_CB, L_CB), generator=gen, device=dev) < 0.5,
         SWEEPS_CB, BETA_CB, -1.0, 0.0),
    ]
    for spins, nsweeps, beta, j, h in cases:
        want = ops.checkerboard_multi_sweep_plain(spins, 12345, beta, j, h, nsweeps)
        Rc, L = spins.shape[:2]
        for c in cb.cluster_sizes(L):
            got = ops.checkerboard_multi_sweep(spins, 12345, beta, j, h, nsweeps, cluster=c)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"checkerboard_multi_sweep differs from its plain "
                                     f"version at {tuple(spins.shape)}, {nsweeps} sweeps, "
                                     f"c={c}")
        if torch.equal(got, spins):
            raise AssertionError("checkerboard_multi_sweep changed no spin")
        print(f"checkerboard_multi_sweep equal to plain at {tuple(spins.shape)}, {nsweeps} "
              f"sweeps, c in {cb.cluster_sizes(L)}; default c={cb.cluster_size(Rc, L, n_sms)}",
              flush=True)
    err = float((got.to(torch.int64) - want.to(torch.int64)).abs().max())
    c_main = cb.cluster_size(R_CB, L_CB, n_sms)
    ms = device_ms(lambda: ops.checkerboard_multi_sweep(spins, 1, beta, j, h, nsweeps), 10)
    call_ms = cuda_ms(lambda: ops.checkerboard_multi_sweep(spins, 1, beta, j, h, nsweeps), 10)
    plain_ms = cuda_ms(lambda: ops.checkerboard_multi_sweep_plain(spins, 1, beta, j, h,
                                                                  nsweeps), 1)
    attempts = spins.numel() * nsweeps
    res = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           **bound(2 * nbytes(spins), attempts * K1_OPS_PER_ATTEMPT), "library_ms": None}
    print(f"checkerboard_multi_sweep: equal to plain (max_abs_err {err}); kernel "
          f"{ms:.4f} ms on the device at c={c_main} ({call_ms:.4f} ms a call, CUDA events), "
          f"plain {plain_ms:.4f} ms, bound {res['bound_ms']:.4f} ms ({res['bound_by']}, "
          f"published f32 peak); {attempts / (ms * 1e-3):.4e} attempts/s in the kernel; "
          f"spins {tuple(spins.shape)}, {nsweeps} sweeps", flush=True)
    k1_issue_bound(attempts)
    # Each cluster size at R=64 and R=256, in two passes (c up, then down),
    # device time.
    table = {}
    for r in (R_CB, 256):
        sp = torch.rand((r, L_CB, L_CB), generator=gen, device=dev) < 0.5
        sizes = cb.cluster_sizes(L_CB)
        for c in sizes + sizes[::-1]:
            t = device_ms(lambda: ops.checkerboard_multi_sweep(sp, 1, BETA_CB, -1.0, 0.0,
                                                               SWEEPS_CB, cluster=c), 5)
            table.setdefault(f"R={r} c={c}", []).append(t)
    print(f"checkerboard_multi_sweep at L={L_CB}, {SWEEPS_CB} sweeps, device ms by CTAs per "
          f"replica, two passes (the rule picks c={c_main} at R={R_CB}, "
          f"c={cb.cluster_size(256, L_CB, n_sms)} at R=256 on {n_sms} SMs): "
          + json.dumps(table), flush=True)
    return res


K1_ENTRIES = ("checkerboard_multi_sweep", "checkerboard_multi_sweep_bands",
              "checkerboard_multi_sweep_tiles", "checkerboard_multi_sweep_global")


def checkerboard_through_dispatch(spins, args, want: dict) -> torch.Tensor:
    """K1 through ``checkerboard_multi_sweep`` (the default dispatch):
    equal to the plain version, changing some spin, with K1's launch counts
    exactly ``want`` (by entry point, missing ones 0). Returns the spins."""
    expect = {name: want.get(name, 0) for name in K1_ENTRIES}
    wanted = ops.checkerboard_multi_sweep_plain(spins, *args)
    ops.reset_launch_counts()
    got = ops.checkerboard_multi_sweep(spins, *args)
    torch.cuda.synchronize()
    counts = {name: ops.launch_counts()[name] for name in K1_ENTRIES}
    if counts != expect:
        raise AssertionError(f"{tuple(spins.shape)}: K1's launches {counts}, not {expect}")
    if not torch.equal(got, wanted) or torch.equal(got, spins):
        raise AssertionError(f"checkerboard_multi_sweep differs from its plain version at "
                             f"{tuple(spins.shape)}, or changed no spin")
    return got


def check_checkerboard_bands(dev) -> dict:
    """Phase 3 for K1 past the cluster variant. The banded variant (called
    directly) equal to the plain version at ragged shapes (L=6: the byte
    path, bands of one row; L=10: H=5; L=8, 16: words, bands of one row);
    then through the default dispatch, equal to plain, with the launches
    asserted: L=1362 (byte path), 2048 at R=2 (one wave), 4096 at R=2 (two
    waves) and R=3 (three waves, bands of 31 or 32 rows). At 2048^2, R=2
    the banded and the global variant (this field's only path before) are
    timed in turns, with the global variant's split between its plane
    passes and its half-steps; the banded variant's row from there."""
    gen = torch.Generator(device=dev).manual_seed(1)
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for Rc, L, nsweeps in ((3, 6, 5), (2, 10, 3), (1, 8, 3), (3, 16, 4)):
        spins = torch.rand((Rc, L, L), generator=gen, device=dev) < 0.5
        want = ops.checkerboard_multi_sweep_plain(spins, 77, 0.7, -1.0, 0.3, nsweeps)
        got = ops.checkerboard_multi_sweep_bands(spins, 77, 0.7, -1.0, 0.3, nsweeps)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"checkerboard_multi_sweep_bands differs from its plain "
                                 f"version at {tuple(spins.shape)}, {nsweeps} sweeps")
    for Rc, L in ((1, 1362), (R_HUGE, L_HUGE), (2, 4096), (3, 4096)):
        plan = cb.k1_global_plan(Rc, L, n_sms)
        if plan["path"] != "bands":
            raise AssertionError(f"L={L} does not take K1's banded variant: {plan}")
        spins = torch.rand((Rc, L, L), generator=gen, device=dev) < 0.5
        checkerboard_through_dispatch(spins, (5, 0.4, -1.0, 0.1, 2),
                                      {"checkerboard_multi_sweep_bands": len(plan["waves"])})
        print(f"checkerboard_multi_sweep_bands equal to plain at {tuple(spins.shape)}, 2 "
              f"sweeps, through the default dispatch: {len(plan['waves'])} launch(es), waves "
              f"(first replica, replicas, bands a replica) {plan['waves']}", flush=True)

    spins = torch.rand((R_HUGE, L_HUGE, L_HUGE), generator=gen, device=dev) < 0.5
    args = (12345, BETA_CB, -1.0, 0.1, SWEEPS_HUGE)
    got = checkerboard_through_dispatch(spins, args, {"checkerboard_multi_sweep_bands": 1})
    want = ops.checkerboard_multi_sweep_plain(spins, *args)
    err = float((got.to(torch.int64) - want.to(torch.int64)).abs().max())
    times = in_turns({"checkerboard_multi_sweep_global":
                      lambda: ops.checkerboard_multi_sweep_global(spins, *args),
                      "checkerboard_multi_sweep_bands":
                      lambda: ops.checkerboard_multi_sweep_bands(spins, *args)}, 10)
    ms = float(np.mean(times["checkerboard_multi_sweep_bands"]))
    call_ms = cuda_ms(lambda: ops.checkerboard_multi_sweep_bands(spins, *args), 10)
    plain_ms = cuda_ms(lambda: ops.checkerboard_multi_sweep_plain(spins, *args), 1)
    attempts = spins.numel() * SWEEPS_HUGE
    bands = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
             **bound(2 * nbytes(spins), attempts * K1_OPS_PER_ATTEMPT), "library_ms": None}
    split = device_split(lambda: ops.checkerboard_multi_sweep_global(spins, *args), 10,
                         {"planes": "planes_kernel", "half-steps": "half_step_kernel"},
                         "the global variant at 2048^2")
    print(f"checkerboard_multi_sweep_bands at {tuple(spins.shape)}, {SWEEPS_HUGE} sweeps: "
          f"equal to plain (max_abs_err {err}); device ms in turns with the global variant "
          f"{json.dumps(times)} (the global variant's recorded row: 0.1208); the banded "
          f"{ms:.4f} ms ({call_ms:.4f} ms a call, CUDA events), plain {plain_ms:.4f} ms, bound "
          f"{bands['bound_ms']:.4f} ms ({bands['bound_by']}, published f32 peak); "
          f"{attempts / (ms * 1e-3):.4e} attempts/s in the kernel; the global variant's "
          f"device ms a call by pass {json.dumps(split)}", flush=True)

    return bands


# The tiled variant's forced shapes on small fields (R, L, nsweeps, k, ty,
# tx): ragged last tiles, halos wider than L (L=6: 12 loaded rows), nsweeps
# not a multiple of k, H % 4 != 0 (L = 6, 10, 22: the byte path) and the
# word path (L = 16, 24, 40).
K1_TILE_CASES = ((2, 16, 5, 2, 5, 8), (1, 6, 3, 2, 4, 2), (2, 10, 7, 3, 3, 4),
                 (1, 22, 6, 3, 4, 6), (1, 24, 11, 5, 7, 16), (3, 40, 9, 4, 9, 16))
# Through the default dispatch (R, L, nsweeps): the first L past the banded
# variant (H odd), 6000 and 8192.
K1_TILE_DISPATCH = ((1, 5406, 1), (2, L_PAST, 3), (1, L_FSS, 2))


def check_checkerboard_tiles(dev) -> tuple[dict, dict]:
    """Phase 3 for K1's tiled variant: ``torch.equal`` to the plain version
    at :data:`K1_TILE_CASES` (forced tiles), then through the default
    dispatch at :data:`K1_TILE_DISPATCH` with its launches asserted (a launch
    each of :func:`k1_tile_plan`, no other variant). Timed in turns with the
    global-memory variant (no longer dispatched) at 5406^2 (the byte path),
    R=1, 2 sweeps, at 6000^2, R=1, 2 sweeps
    (phase 6b's call: both variants' rows come from there) and at 8192^2,
    R=1, 100 sweeps, with the marginal attempts/s of each (500 sweeps against
    100) and the tiled kernel's SASS issue bound, for the useful attempts
    and for those its halos add."""
    gen = torch.Generator(device=dev).manual_seed(2)
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for Rc, L, nsweeps, k, ty, tx in K1_TILE_CASES:
        spins = torch.rand((Rc, L, L), generator=gen, device=dev) < 0.5
        want = ops.checkerboard_multi_sweep_plain(spins, 77, 0.7, -1.0, 0.3, nsweeps)
        got = ops.checkerboard_multi_sweep_tiles(spins, 77, 0.7, -1.0, 0.3, nsweeps, k=k,
                                                 ty=ty, tx=tx)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"checkerboard_multi_sweep_tiles differs from its plain "
                                 f"version at {tuple(spins.shape)}, {nsweeps} sweeps, k={k}, "
                                 f"{ty} x {tx} tiles")
    print(f"checkerboard_multi_sweep_tiles equal to plain at forced (R, L, nsweeps, k, ty, tx) "
          f"{K1_TILE_CASES}", flush=True)
    for Rc, L, nsweeps in K1_TILE_DISPATCH:
        if cb.k1_variant(L, n_sms) != "tiles":
            raise AssertionError(f"L={L} does not take K1's tiled variant")
        plan = cb.k1_tile_plan(Rc, L, nsweeps, n_sms)
        spins = torch.rand((Rc, L, L), generator=gen, device=dev) < 0.5
        checkerboard_through_dispatch(spins, (5, 0.4, -1.0, 0.1, nsweeps),
                                      {"checkerboard_multi_sweep_tiles": len(plan["launches"])})
        print(f"checkerboard_multi_sweep_tiles equal to plain at {tuple(spins.shape)}, "
              f"{nsweeps} sweep(s), through the default dispatch: "
              f"{len(plan['launches'])} launch(es), k={plan['k']}, {plan['ty']} x {plan['tx']} "
              f"tiles, {plan['ctas']} CTAs, {plan['ctas_per_sm']} an SM, {plan['threads']} "
              f"threads", flush=True)

    entries = {"checkerboard_multi_sweep_global": ops.checkerboard_multi_sweep_global,
               "checkerboard_multi_sweep_tiles": ops.checkerboard_multi_sweep_tiles}
    # The byte path (H % 4 != 0: a thread's four sites draw from one or two
    # Philox calls), timed at the first L past the banded variant.
    L_byte = K1_TILE_DISPATCH[0][1]
    spins = torch.rand((1, L_byte, L_byte), generator=gen, device=dev) < 0.5
    args = (98, BETA_CB, -1.0, 0.1, SWEEPS_PAST)
    times = in_turns({name: (lambda f=f: f(spins, *args)) for name, f in entries.items()}, 10)
    attempts = spins.numel() * SWEEPS_PAST
    print(f"K1 at {tuple(spins.shape)}, {SWEEPS_PAST} sweeps (the tiled variant's byte path): "
          f"device ms in turns {json.dumps(times)}; "
          f"{attempts / (np.mean(times['checkerboard_multi_sweep_tiles']) * 1e-3):.4e} "
          f"attempts/s in the tiled kernel", flush=True)

    rows = {}
    spins = torch.rand((R_PAST, L_PAST, L_PAST), generator=gen, device=dev) < 0.5
    args = (99, BETA_CB, -1.0, 0.1, SWEEPS_PAST)
    want = ops.checkerboard_multi_sweep_plain(spins, *args)
    times = in_turns({name: (lambda f=f: f(spins, *args)) for name, f in entries.items()}, 10)
    plain_ms = cuda_ms(lambda: ops.checkerboard_multi_sweep_plain(spins, *args), 1)
    attempts = spins.numel() * SWEEPS_PAST
    for name, f in entries.items():
        got = f(spins, *args)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"{name} differs from its plain version at {tuple(spins.shape)}")
        err = float((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        rows[name] = {"max_abs_err": err, "ms": float(np.mean(times[name])),
                      "plain_ms": plain_ms,
                      **bound(2 * nbytes(spins), attempts * K1_OPS_PER_ATTEMPT),
                      "library_ms": None}
    plan = cb.k1_tile_plan(R_PAST, L_PAST, SWEEPS_PAST, n_sms)
    loaded = plan["ctas"] * (plan["ty"] + 2 * plan["halo_rows"]) * (
        plan["tx"] + 2 * plan["halo_cols"])
    tiles = rows["checkerboard_multi_sweep_tiles"]
    call_ms = cuda_ms(lambda: ops.checkerboard_multi_sweep_tiles(spins, *args), 10)
    print(f"K1 at {tuple(spins.shape)}, {SWEEPS_PAST} sweeps: device ms in turns "
          f"{json.dumps(times)} (the global variant's recorded row: 0.2712); the tiled "
          f"{tiles['ms']:.4f} ms ({call_ms:.4f} ms a call, CUDA events; {len(plan['launches'])} "
          f"launch(es), k={plan['k']}, {plan['ty']} x {plan['tx']} tiles, {plan['ctas']} CTAs, "
          f"{loaded / spins.numel():.3f}x the field's sites loaded), plain {plain_ms:.4f} ms, "
          f"bound {tiles['bound_ms']:.4f} ms ({tiles['bound_by']}, published f32 peak); "
          f"{attempts / (tiles['ms'] * 1e-3):.4e} attempts/s in the kernel, the global "
          f"variant's {attempts / (rows['checkerboard_multi_sweep_global']['ms'] * 1e-3):.4e}",
          flush=True)
    issue = k1_issue_bound(attempts, "checkerboard_tiles_kernelILb1E", "K1 tiled")
    if issue is not None:
        print(f"K1 tiled at {tuple(spins.shape)}: {issue / tiles['ms']:.1%} of the issue bound "
              f"of the useful attempts; {issue * loaded / spins.numel() / tiles['ms']:.1%} "
              f"with the halos' attempts", flush=True)

    spins = torch.rand((1, L_FSS, L_FSS), generator=gen, device=dev) < 0.5
    fss = {}
    for n in (SWEEPS_FSS, 5 * SWEEPS_FSS):
        a = (7, BETA_CB, -1.0, 0.1, n)
        fss[n] = in_turns({name: (lambda f=f, a=a: f(spins, *a)) for name, f in entries.items()},
                          2)
    attempts = spins.numel() * SWEEPS_FSS
    rate = {name: attempts / (np.mean(fss[SWEEPS_FSS][name]) * 1e-3) for name in entries}
    marginal = {name: 4 * attempts / ((np.mean(fss[5 * SWEEPS_FSS][name])
                                       - np.mean(fss[SWEEPS_FSS][name])) * 1e-3)
                for name in entries}
    plan = cb.k1_tile_plan(1, L_FSS, SWEEPS_FSS, n_sms)
    print(f"K1 at {tuple(spins.shape)}, {SWEEPS_FSS} sweeps: device ms in turns "
          f"{json.dumps(fss[SWEEPS_FSS])}, {5 * SWEEPS_FSS} sweeps {json.dumps(fss[5 * SWEEPS_FSS])}; "
          f"attempts/s at {SWEEPS_FSS} sweeps {json.dumps({k: f'{v:.4e}' for k, v in rate.items()})}, "
          f"marginal {json.dumps({k: f'{v:.4e}' for k, v in marginal.items()})}; tiled / global "
          f"{np.mean(fss[SWEEPS_FSS]['checkerboard_multi_sweep_global']) / np.mean(fss[SWEEPS_FSS]['checkerboard_multi_sweep_tiles']):.2f}x; "
          f"plan k={plan['k']}, {plan['ty']} x {plan['tx']} tiles, {len(plan['launches'])} "
          f"launches, {plan['ctas']} CTAs, {plan['ctas_per_sm']} an SM, modelled "
          f"{plan['seconds'] * 1e3:.4f} ms", flush=True)
    k1_issue_bound(attempts, "checkerboard_tiles_kernelILb1E", "K1 tiled")
    return rows["checkerboard_multi_sweep_tiles"], rows["checkerboard_multi_sweep_global"]


def label_inputs(rng, dev, S: int, E: int, Mg: int, R: int):
    """A label problem of one shape: edges ``(u, v) [E, R]`` over ``S``
    labels with a tenth on the dump row ``S - 1``, the identity ``P0``, the
    labels ``P1`` after one round from it (so ``P1[x] <= x``), and two
    ``[Mg, R]`` grids of op sides into them."""

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(dev)

    u = rng.integers(0, S - 1, size=(E, R))
    v = rng.integers(0, S - 1, size=(E, R))
    dump = rng.random((E, R)) < 0.1
    u[dump] = v[dump] = S - 1
    u, v = t(u), t(v)
    P0 = torch.arange(S, dtype=torch.int32, device=dev)[:, None].repeat(1, R)
    P1, _ = ops.pointer_jump_plain(ops.hook_min_plain(P0, u, v, first=True), P0, N_COMPRESS)
    return P0, P1, u, v, t(rng.integers(0, S, size=(Mg, R))), t(rng.integers(0, S, size=(Mg, R)))


def as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


def check_labels(dev) -> dict:
    """Phase 3 for K4: ``take0`` on one and two grids, ``hook_min`` (first
    round and later) and ``pointer_jump`` equal their plain versions at a
    ragged shape and at the 32x32 label shapes, where they are timed beside
    ``torch.gather``, and one hook round as the port ran it before beside
    the new one."""
    rng = np.random.default_rng(1)
    for S, E, Mg, r in ((37, 29, 23, 5), (C_TAKE, E_TAKE, M, R)):
        P0, P1, u, v, s_in, s_out = label_inputs(rng, dev, S, E, Mg, r)
        Pn = ops.hook_min_plain(P1, u, v)
        calls = {
            "take0 one grid": (ops.take0, ops.take0_plain, (P1, s_in)),
            "take0 two grids": (ops.take0, ops.take0_plain, (P1, s_in, s_out)),
            "hook_min first round": (lambda *a: ops.hook_min(*a, first=True),
                                     lambda *a: ops.hook_min_plain(*a, first=True), (P0, u, v)),
            "hook_min": (ops.hook_min, ops.hook_min_plain, (P1, u, v)),
            "pointer_jump": (lambda *a: ops.pointer_jump(*a, N_COMPRESS, tag=5),
                             lambda *a: ops.pointer_jump_plain(*a, N_COMPRESS, tag=5), (Pn, P1)),
        }
        for name, (kernel, plain, args) in calls.items():
            got, want = as_tuple(kernel(*args)), as_tuple(plain(*args))
            torch.cuda.synchronize()
            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                raise AssertionError(f"{name}: kernel differs from its plain version at "
                                     f"{[tuple(a.shape) for a in args]}")
        print(f"K4 entry points equal to plain at S={S}, E={E}, M={Mg}, R={r}: "
              f"{', '.join(calls)}", flush=True)

    def timed(name, kernel, plain, args, library=None, reps=100):
        """Kernel and library: device time (profiler); the kernel's call
        also from CUDA events, host included; plain: CUDA events."""
        got, want = as_tuple(kernel(*args)), as_tuple(plain(*args))
        err = max(float((g.to(torch.int64) - w.to(torch.int64)).abs().max())
                  for g, w in zip(got, want))
        res = {"max_abs_err": err, "ms": device_ms(lambda: kernel(*args), reps),
               "plain_ms": cuda_ms(lambda: plain(*args), 20),
               **bound(nbytes(*args, *got)),
               "library_ms": None if library is None else device_ms(library, reps)}
        call_ms = cuda_ms(lambda: kernel(*args), reps)
        lib_call = "" if library is None else f", {cuda_ms(library, reps):.4f} ms a call"
        print(f"{name}: kernel {res['ms']:.4f} ms on the device ({call_ms:.4f} ms a call, "
              f"host included), plain {res['plain_ms']:.4f} ms, bound {res['bound_ms']:.4f} ms "
              f"({res['bound_by']}), library {res['library_ms']} ms on the device{lib_call}; "
              f"input shapes {[tuple(a.shape) for a in args]}", flush=True)
        return res

    # torch.gather on the same table with the index widened (and the two
    # grids joined) beforehand.
    one64, both64 = s_in.long(), torch.cat([s_in, s_out]).long()
    timed("take0 one grid", ops.take0, ops.take0_plain, (P1, s_in),
          lambda: torch.gather(P1, 0, one64))
    results = {
        "take0": timed("take0 two grids", ops.take0, ops.take0_plain, (P1, s_in, s_out),
                       lambda: torch.gather(P1, 0, both64)),
        "hook_min": timed("hook_min (the wrapper: copy of P, then the hook)", ops.hook_min,
                          ops.hook_min_plain, (P1, u, v)),
        "pointer_jump": timed("pointer_jump", lambda *a: ops.pointer_jump(*a, N_COMPRESS),
                              lambda *a: ops.pointer_jump_plain(*a, N_COMPRESS), (Pn, P1)),
    }

    def earlier_round():  # the gathers, scatter_reduce and single jumps
        pu, pv = ops.take0(P1, u), ops.take0(P1, v)
        Pm = P1.scatter_reduce(0, torch.maximum(pu, pv).long(), torch.minimum(pu, pv),
                               reduce="amin")
        for _ in range(N_COMPRESS):
            Pm = ops.take0(Pm, Pm)
        return Pm, (Pm != P1).any()

    flag = torch.zeros(1, dtype=torch.int32, device=dev)

    def new_round():
        return ops.pointer_jump(ops.hook_min(P1, u, v), P1, N_COMPRESS, flag, 1)

    if not torch.equal(earlier_round()[0], new_round()[0]):
        raise AssertionError("the new hook round differs from the earlier one")
    t_old, t_new = cuda_ms(earlier_round, 50), cuda_ms(new_round, 50)
    d_old, d_new = device_ms(earlier_round, 50), device_ms(new_round, 50)
    print(f"one hook round at S={C_TAKE}, E={E_TAKE}, R={R} (no host read): earlier "
          f"sequence (2 take0, max, min, scatter_reduce, {N_COMPRESS} take0, compare, any) "
          f"{d_old:.4f} ms on the device, {t_old:.4f} ms a round (CUDA events); "
          f"hook_min + pointer_jump {d_new:.4f} ms on the device, {t_new:.4f} ms a round",
          flush=True)
    return results


CARRY = {"carry_decisions": (ops.carry_decisions, ops.carry_decisions_plain, False),
         "carry_decisions_heatbath": (ops.carry_decisions_heatbath,
                                      ops.carry_decisions_heatbath_plain, True)}


def carry_equal(name: str, args, label: str) -> None:
    kernel, plain, _ = CARRY[name]
    got, want = kernel(*args), plain(*args)
    torch.cuda.synchronize()
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise AssertionError(f"{name}: kernel differs from its plain version on the {label} "
                             f"inputs at {tuple(args[1].shape)}")


def carry_time(name: str, args, label: str, bounds: dict) -> float:
    """The kernel's device ms on ``args`` (after :func:`carry_equal`),
    printed beside its chain and byte bounds."""
    kernel = CARRY[name][0]
    ms = device_ms(lambda: kernel(*args), 50)
    call_ms = cuda_ms(lambda: kernel(*args), 50)
    got = kernel(*args)
    print(f"{name} on the {label} inputs {tuple(args[1].shape)}: equal to plain; kernel "
          f"{ms:.4f} ms on the device ({call_ms:.4f} ms a call, CUDA events); chain bound "
          f"{bounds.get(name, float('nan')):.4f} ms, byte bound "
          f"{bound(nbytes(*args, *got))['bound_ms']:.4f} ms", flush=True)
    return ms


def check_carry(dev, rng, full: dict, bounds: dict) -> dict:
    """Phase 3 for K3 and K3-hb: equal to the plain versions at ragged
    shapes (R not a multiple of 32 or 16, M not a multiple of the 64-slot
    tile; random and tie-heavy inputs) and at the 32x32 shape on random and
    tie-heavy inputs, each timed (device ms, profiler); the plain versions
    timed on the random ones."""

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    results = {}
    for name, (kernel, plain, hb) in CARRY.items():
        for m, r in ((37, 5), (300, 48), (130, 16), (100, 37)):
            carry_equal(name, kernel_inputs(rng, dev, K, m, r, N)[name], "random")
            carry_equal(name, [t(a) for a in tie_heavy_carry_inputs(m, r, m + r, hb)],
                        "tie-heavy")
        print(f"{name} equal to plain at ragged shapes (M, R) in (37, 5), (300, 48), "
              f"(130, 16), (100, 37), random and tie-heavy", flush=True)
        args = full[name]
        carry_equal(name, args, "random")
        ms = carry_time(name, args, "random", bounds)
        ties = [t(a) for a in tie_heavy_carry_inputs(M, R, 7, hb)]
        carry_equal(name, ties, "tie-heavy")
        carry_time(name, ties, "tie-heavy", bounds)
        got, want = kernel(*args), plain(*args)
        err = max(float((g.to(torch.int64) - w.to(torch.int64)).abs().max())
                  for g, w in zip(got, want))
        results[name] = {"max_abs_err": err, "ms": ms,
                         "plain_ms": cuda_ms(lambda: plain(*args), 1),
                         **bound(nbytes(*args, *got)), "library_ms": None}
    return results


def check_recorded_carry(g_met: QmcIsingGraph, g_hb: QmcIsingGraph, bounds: dict) -> None:
    """Phase 5b: K3 and K3-hb against their plain versions on the arguments
    of one real call each, recorded from a sweep of the grown 32x32 chains,
    and timed on them."""
    recorded = {}

    def recorder(name, fn):
        def call(*args):
            recorded.setdefault(name, [a.clone() for a in args])
            return fn(*args)
        return call

    saved = {name: getattr(sse_diagonal, name) for name in CARRY}
    try:
        for name in CARRY:
            setattr(sse_diagonal, name, recorder(name, saved[name]))
        for g in (g_met, g_hb):
            g.sse, _, _, _ = multi_sweep(g.sse, 1.0, g.model, 1, lambda: g.draws,
                                      cluster_caps=g._cluster_caps, **g._diag_args())
    finally:
        for name in CARRY:
            setattr(sse_diagonal, name, saved[name])
    for name, args in recorded.items():
        carry_equal(name, args, "recorded 32x32")
        carry_time(name, args, "recorded 32x32", bounds)
    if set(recorded) != set(CARRY):
        raise AssertionError(f"no call recorded for {set(CARRY) - set(recorded)}")


def check_kernels(dev) -> tuple[dict, dict]:
    """Phase 3: every kernel equals its plain version on the card, at a
    small ragged shape and at the main-path shape, where both are timed.
    Returns the per-kernel results and K3's and K3-hb's chain bounds."""
    results = {"checkerboard_multi_sweep": check_checkerboard(dev), **check_labels(dev)}
    results["checkerboard_multi_sweep_bands"] = check_checkerboard_bands(dev)
    (results["checkerboard_multi_sweep_tiles"],
     results["checkerboard_multi_sweep_global"]) = check_checkerboard_tiles(dev)
    rng = np.random.default_rng(0)
    full = kernel_inputs(rng, dev, K, M, R, N)
    results["parity_bits"] = check_parity(dev, rng, full["parity_bits"])
    results["parity_bits_global"] = check_parity_variants(dev, rng)
    carry_bounds = carry_chain_bounds(M)
    return {**results, **check_carry(dev, rng, full, carry_bounds)}, carry_bounds


def check_physics(dev, heatbath: bool = False) -> None:
    """Phase 4 (and 5b with ``heatbath``): energy of an 8-site TFIM chain
    against ED."""
    edges = lattice.chain(8)
    beta, gamma = 1.0, 1.0
    g = QmcIsingGraph(edges, gamma, replicas=1024, seed=11, device=dev)
    g.set_enable_heatbath(heatbath)
    g.timesteps(100, beta)
    e = g.timesteps(400, beta).cpu().numpy()
    exact = exact_tfim_energy(edges, gamma, beta, 8)
    se = e.std() / np.sqrt(len(e))
    print(f"8-site chain{', heat-bath' if heatbath else ''}, beta={beta}, "
          f"Gamma={gamma}, R=1024: E = {e.mean():.5f} "
          f"+- {se:.5f} (ED {exact:.5f}, {abs(e.mean() - exact) / se:.2f} SE), "
          f"cutoff {g.cutoff}", flush=True)
    if not np.all(np.isfinite(e)) or abs(e.mean() - exact) >= 5 * se:
        raise AssertionError("chain energy is not within 5 standard errors of ED")
    if not g.verify():
        raise AssertionError("verify() failed on the 8-site chain")


def run_slice(dev, heatbath: bool = False, cutoff: int = 6500):
    """Phase 5 (and 5b with ``heatbath``): the main path at full size,
    through the kernels. Returns the printed results, the op counts
    ``[steps, R]`` of the measured chunks and the graph."""
    beta, chunk, nchunks = 1.0, 16, 4
    t0 = time.perf_counter()
    g = QmcIsingGraph(lattice.bench_two_d_periodic(32), 1.0, cutoff=cutoff,
                      replicas=R, seed=7, device=dev)
    g.set_enable_heatbath(heatbath)
    g.timesteps(48, beta)  # single steps until the cutoff is stable, then chunks
    torch.cuda.synchronize()
    print(f"32x32: grown and equilibrated in {time.perf_counter() - t0:.1f} s, "
          f"cutoff {g.cutoff}, caps {g._cluster_caps}", flush=True)
    series, secs = [], 0.0
    for _ in range(nchunks):
        t1 = time.perf_counter()
        g.sse, ns, _, _ = multi_sweep(g.sse, beta, g.model, chunk, lambda: g.draws,
                                   cluster_caps=g._cluster_caps, cluster_every=1,
                                   **g._diag_args())
        series.append(ns.cpu().numpy())  # ends with a synchronising copy
        secs += time.perf_counter() - t1
        g._maybe_grow()
    ns = np.concatenate(series)  # [nchunks * chunk, R]
    energy = -ns / beta + g.model.offset
    if ns.shape != (nchunks * chunk, R) or not np.all(np.isfinite(energy)):
        raise AssertionError(f"bad op-count series: shape {ns.shape}")
    if not g.verify():
        raise AssertionError("verify() failed on the 32x32 slice")
    ess = effective_sample_size(energy)
    out = {
        "cutoff": g.cutoff,
        "mean_n": float(ns.mean()),
        "energy_per_site": float(energy.mean() / g.nvars),
        "replica_sweeps_per_s": nchunks * chunk * R / secs,
        "ms_per_sweep": 1e3 * secs / (nchunks * chunk),
        "energy_ess_per_s_short_series": ess / secs,
        "series_len": nchunks * chunk,
    }
    print(f"32x32 slice{', heat-bath' if heatbath else ''}, Gamma=1, beta=1, R=256, "
          "cluster_every=1: " + json.dumps(out), flush=True)
    return out, ns, g


def check_grown_labels(g: QmcIsingGraph) -> None:
    """Phase 5: the hook-and-compress labels of the grown 32x32 op string
    (full label space) from K4 on the card equal those of the plain
    versions, which a CPU tensor takes."""
    t0 = time.perf_counter()
    sg = segment_graph(g.sse.ops, g.model)
    got = hook_compress_labels(sg.u, sg.v, sg.S).cpu()
    want = hook_compress_labels(sg.u.cpu(), sg.v.cpu(), sg.S)
    if not torch.equal(got, want):
        raise AssertionError("K4's labels of the grown op string differ from the plain ones")
    roots = (want == torch.arange(sg.S, dtype=torch.int32)[:, None]).sum(0).float()
    print(f"labels of the grown op string (S={sg.S}, E={sg.u.shape[0]}, R={R}): K4 equal to "
          f"the plain versions, {float(roots.mean()):.1f} roots a replica "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)


def profile_sweeps(g: QmcIsingGraph, label: str, nsweeps: int = 4) -> None:
    """Phase 5b: device time per sweep by kernel over ``nsweeps`` chunked
    timesteps under ``torch.profiler``, the ten largest, K4's, the device
    events per sweep and the device's busy share of the wall time. Raises
    if a ``scatter_reduce`` ran (the hook is K4's ``hook_min``)."""
    from torch.profiler import ProfilerActivity, profile

    def run(n):
        g.sse, _, _, _ = multi_sweep(g.sse, 1.0, g.model, n, lambda: g.draws,
                                  cluster_caps=g._cluster_caps, **g._diag_args())

    # A first profiler session in a process runs slow; one sweep, discarded.
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        run(1)
        torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(nsweeps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # Device-side events only (kernels, copies, memsets): an operator's row
    # repeats the time of the kernels it launched.
    rows = [(e.key, e.self_device_time_total / 1e3 / nsweeps, e.count / nsweeps)
            for e in device_rows(prof, label)]
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    wall_ms = 1e3 * wall / nsweeps
    print(f"{label}: {wall_ms:.4f} ms per sweep under the profiler, device {busy:.4f} ms "
          f"({100 * busy / wall_ms:.1f}% busy); largest, ms per sweep (calls):", flush=True)
    for name, ms, calls in rows[:10]:
        print(f"  {ms:.4f} ({calls:g})  {name[:90]}", flush=True)
    for name, chain in CARRY_CHAINS.items():
        carry = [r for r in rows if chain in r[0]]
        if carry:
            print(f"  {name}: {sum(r[1] for r in carry):.4f} ms per sweep on the device over "
                  f"{sum(r[2] for r in carry):g} launches", flush=True)
    k2 = [r for r in rows if "parity_" in r[0]]  # its three kernels
    print(f"  K2 kernels {sum(r[1] for r in k2):.4f} ms per sweep on the device over "
          f"{sum(r[2] for r in k2):g} kernel launches", flush=True)
    k4 = [r for r in rows if any(k in r[0] for k in
                                 ("take0_kernel", "hook_min_kernel", "pointer_jump_kernel"))]
    print(f"  K4 kernels {sum(r[1] for r in k4):.4f} ms per sweep over "
          f"{sum(r[2] for r in k4):g} launches; {sum(r[2] for r in rows):g} device events "
          f"per sweep", flush=True)
    scatter_min = [e.key for e in prof.key_averages() if "scatter_reduce" in e.key]
    if scatter_min:
        raise AssertionError(f"{label}: scatter_reduce ran in the sweep: {scatter_min}")


def time_in_turns(g_met: QmcIsingGraph, g_hb: QmcIsingGraph, chunk: int = 16) -> None:
    """Phase 5b: ms per sweep of the two 32x32 paths, timed in turns
    (Metropolis, heat-bath, heat-bath, Metropolis; one chunk each, host clock
    around work that ends in a synchronize), so both see the same host."""
    times = {"Metropolis": [], "heat-bath": []}
    for label, g in (("Metropolis", g_met), ("heat-bath", g_hb),
                     ("heat-bath", g_hb), ("Metropolis", g_met)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        g.sse, _, _, _ = multi_sweep(g.sse, 1.0, g.model, chunk, lambda: g.draws,
                                  cluster_caps=g._cluster_caps, **g._diag_args())
        torch.cuda.synchronize()
        times[label].append(1e3 * (time.perf_counter() - t0) / chunk)
    ratio = np.mean(times["heat-bath"]) / np.mean(times["Metropolis"])
    print(f"ms per sweep in turns (M, HB, HB, M; {chunk} sweeps each): "
          f"{json.dumps(times)}; heat-bath / Metropolis {ratio:.3f}", flush=True)


def mean_n_agrees(label: str, ns, ref_label: str, ns_ref) -> str:
    """Two chains of one distribution: their mean op counts (over
    per-replica means) agree within 5 combined standard errors and 0.5%.
    Raises otherwise; returns the printed comparison."""
    means = [ns_.mean(axis=0) for ns_ in (ns_ref, ns)]
    se = [m.std(ddof=1) / np.sqrt(len(m)) for m in means]
    diff = float(means[1].mean() - means[0].mean())
    comb = float(np.hypot(*se))
    rel = abs(diff) / float(means[0].mean())
    text = (f"mean n: {label} {means[1].mean():.2f} +- {se[1]:.2f}, {ref_label} "
            f"{means[0].mean():.2f} +- {se[0]:.2f}: difference {diff:.2f} "
            f"({abs(diff) / comb:.2f} combined SE, {100 * rel:.3f}%)")
    if not (abs(diff) < 5 * comb and rel < 0.005):
        raise AssertionError(f"{text}: the {label} chain's mean op count is off "
                             f"the {ref_label} chain's")
    return text


def check_heatbath_agrees(met: dict, ns_met, hb: dict, ns_hb) -> None:
    """Phase 5b: the heat-bath and Metropolis chains sample the same
    distribution (:func:`mean_n_agrees`)."""
    text = mean_n_agrees("heat-bath", ns_hb, "Metropolis", ns_met)
    print(f"{text}; ms per sweep heat-bath {hb['ms_per_sweep']:.4f}, Metropolis "
          f"{met['ms_per_sweep']:.4f} (ratio {hb['ms_per_sweep'] / met['ms_per_sweep']:.3f})",
          flush=True)


def onsager_energy(beta: float) -> float:
    """Energy per site of the infinite square-lattice ferromagnet (|J| = 1)."""
    from scipy.special import ellipk

    k = 2.0 * np.sinh(2 * beta) / np.cosh(2 * beta) ** 2
    t = np.tanh(2 * beta)
    return float(-(1 / t) * (1 + 2 / np.pi * (2 * t * t - 1) * ellipk(k * k)))


def yang_magnetization(beta: float) -> float:
    return float((1 - np.sinh(2 * beta) ** -4) ** 0.125)


def lattice_observables(g: LatticeIsing, beta: float, equil: int, samples: int,
                        every: int) -> tuple:
    """Per-replica means of E/site and |M|/site over ``samples`` snapshots
    ``every`` sweeps apart, after ``equil`` sweeps."""
    g.run_sweeps(equil, beta)
    es, ms = [], []
    for _ in range(samples):
        g.run_sweeps(every, beta)
        es.append(g.get_energy())
        ms.append(g.get_magnetization().abs())
    n = g.L * g.L
    return (torch.stack(es).mean(0).cpu().numpy() / n,
            torch.stack(ms).mean(0).cpu().numpy() / n)


def run_classical(dev) -> dict:
    """Phase 6: the classical main path at full width, through K1."""
    out = {}
    t0 = time.perf_counter()
    for beta, state in ((0.3, None), (0.6, np.ones((L_CB, L_CB), bool))):
        g = LatticeIsing(L_CB, j=-1.0, replicas=R_CB, seed=3, state=state, device=dev)
        e, m = lattice_observables(g, beta, 300, 20, 10)
        exact = onsager_energy(beta)
        se = e.std(ddof=1) / np.sqrt(len(e))
        print(f"{L_CB}^2, R={R_CB}, beta={beta}, {'random' if state is None else 'ordered'} "
              f"start: E/site {e.mean():.6f} +- {se:.6f} (Onsager {exact:.6f}, "
              f"{abs(e.mean() - exact) / se:.2f} SE), |M|/site {m.mean():.6f}", flush=True)
        if not (np.all(np.isfinite(e)) and abs(e.mean() - exact) < min(5 * se, 2e-3)):
            raise AssertionError(f"E/site at beta={beta} is off Onsager's value")
        if beta > 0.5:
            yang = yang_magnetization(beta)
            print(f"  Yang |M|/site {yang:.6f}, difference {m.mean() - yang:.6f}", flush=True)
            if abs(m.mean() - yang) >= 5e-3:
                raise AssertionError("|M|/site at beta=0.6 is off Yang's value")
        out[f"energy_per_site_beta_{beta}"] = float(e.mean())
    print(f"Onsager and Yang checks in {time.perf_counter() - t0:.1f} s", flush=True)

    # Marginal rate, as bench.py:141-197: time calls of n and 5n sweeps
    # (each ending in a synchronize) and divide the extra attempts by the
    # extra time, which removes the per-call constant.
    g = LatticeIsing(L_CB, j=-1.0, replicas=R_CB, seed=4, device=dev)

    def timed(n: int) -> float:
        g.run_sweeps(n, BETA_CB)
        torch.cuda.synchronize()
        best = float("inf")
        for _ in range(3):
            t1 = time.perf_counter()
            g.run_sweeps(n, BETA_CB)
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t1)
        return best

    t_small, t_big = timed(SWEEPS_CB), timed(5 * SWEEPS_CB)
    attempts = R_CB * L_CB * L_CB * 4 * SWEEPS_CB
    out["attempts_per_s"] = attempts / (t_big - t_small)
    out["seconds_100_sweeps"], out["seconds_500_sweeps"] = t_small, t_big
    print(f"{L_CB}^2, R={R_CB}, J=-1, beta={BETA_CB}: "
          f"{out['attempts_per_s']:.4e} spin-flip attempts/s (marginal; "
          f"{t_small:.4f} s for {SWEEPS_CB} sweeps, {t_big:.4f} s for {5 * SWEEPS_CB})",
          flush=True)

    # The README quickstart on the same lattice: the general graph engine.
    t0 = time.perf_counter()
    n = L_CB * L_CB
    g = GraphState.new(lattice.square(L_CB, L_CB, j=-1.0), [0.0] * n, replicas=R_CB,
                       device=dev)
    print(f"GraphState on {L_CB}^2: tables built in {time.perf_counter() - t0:.1f} s, "
          f"{g.tables.n_site_colors} site and {g.tables.n_edge_colors} edge colours",
          flush=True)
    moves = [("do_spin_flip", g.do_spin_flip)] * 3 + [
        ("do_time_step(only_basic_moves=True)",
         lambda b: g.do_time_step(b, only_basic_moves=True))] * 4 + [
        ("swendsen_wang_step", g.swendsen_wang_step)] * 2
    for name, move in moves:
        t1 = time.perf_counter()
        move(0.44)
        e = g.get_energy()
        want = metropolis.lattice_energy(g.spins.reshape(R_CB, L_CB, L_CB), -1.0, 0.0)
        torch.cuda.synchronize()
        if not (torch.isfinite(e).all() and torch.equal(e, want)):
            raise AssertionError(f"GraphState energy after {name} disagrees with the "
                                 f"lattice formula")
        print(f"  {name}: {time.perf_counter() - t1:.3f} s, E/site "
              f"{float(e.mean()) / n:.5f}", flush=True)

    # Worms on a small frustrated lattice, where they close quickly: the
    # coupling energy must be unchanged exactly at h = 0.
    g = GraphState.new(lattice.frustrated_square(8, 8), [0.0] * 64, replicas=R_CB,
                       seed=5, device=dev)
    moved = 0
    for _ in range(5):
        before, e0 = g.spins, g.get_energy()
        g.spins = worm.worm_sweep(g.spins, g.draws, 1.0, g.tables)
        if not torch.equal(g.get_energy(), e0):
            raise AssertionError("a worm changed the coupling energy")
        moved += int((g.spins != before).any(dim=1).sum())
    print(f"worms on the 8x8 frustrated lattice: energy kept, {moved} replica-moves "
          f"changed spins", flush=True)
    if moved == 0:
        raise AssertionError("no worm moved")
    return out


def run_classical_global(dev) -> dict:
    """Phase 6b: ``LatticeIsing(2048, replicas=2)``, a field that no cluster
    holds, through K1's banded variant: a call equal to the plain version
    on the same spins and seed, then the energy per site at beta=0.3 after
    equilibration against Onsager's value (the correlation length is a few
    sites, so 2048^2 is the infinite lattice to within the statistics).
    Before it ``LatticeIsing(6000)`` and ``LatticeIsing(8192)``, past the
    card's resident shared memory, through K1's tiled variant: a call each
    equal to the plain version."""
    t0 = time.perf_counter()
    for L, seed in ((L_PAST, 4), (L_FSS, 6)):
        g = LatticeIsing(L, j=-1.0, replicas=R_PAST, seed=seed, device=dev)
        start = g.spins.clone()
        g.run_sweeps(SWEEPS_PAST, 0.3)
        want = ops.checkerboard_multi_sweep_plain(start, seed * 1000003 + 1, 0.3, -1.0, 0.0,
                                                  SWEEPS_PAST)
        if not torch.equal(g.spins, want):
            raise AssertionError(f"LatticeIsing({L}) differs from the plain version")
        print(f"LatticeIsing({L}, replicas={R_PAST}): a call of {SWEEPS_PAST} sweeps equal "
              f"to the plain version", flush=True)
        del g, start, want
    g = LatticeIsing(L_HUGE, j=-1.0, replicas=R_HUGE, seed=9, device=dev)
    start = g.spins.clone()
    g.run_sweeps(SWEEPS_HUGE, 0.3)
    want = ops.checkerboard_multi_sweep_plain(start, 9 * 1000003 + 1, 0.3, -1.0, 0.0,
                                              SWEEPS_HUGE)
    if not torch.equal(g.spins, want):
        raise AssertionError(f"LatticeIsing({L_HUGE}) differs from the plain version")
    e, m = lattice_observables(g, 0.3, 200, 10, 5)
    exact = onsager_energy(0.3)
    se = e.std(ddof=1) / np.sqrt(len(e)) if len(e) > 1 else 0.0
    print(f"LatticeIsing({L_HUGE}, replicas={R_HUGE}): a call equal to the plain version; "
          f"beta=0.3 E/site {e.mean():.6f} (replicas {np.array2string(e, precision=6)}; "
          f"Onsager {exact:.6f}), |M|/site {m.mean():.6f}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if not (np.all(np.isfinite(e)) and abs(e.mean() - exact) < 2e-3):
        raise AssertionError(f"E/site on the {L_HUGE}^2 lattice is off Onsager's value")
    return {"energy_per_site_beta_0.3": float(e.mean())}


def count_syncs(fn) -> int:
    """Runs ``fn()`` and returns the synchronising CUDA operations PyTorch
    reported in it (``torch.cuda.set_sync_debug_mode``): its host reads."""
    prev = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(prev)
    return sum("synchroniz" in str(w.message) for w in caught)


def wrap_rvb_stage(around):
    """Replaces ``rvb.rvb_sweep``, which the timestep calls, by
    ``around(inner, *args, **kwargs)``; returns the restoring function."""
    inner = sse_rvb.rvb_sweep
    sse_rvb.rvb_sweep = lambda *a, **k: around(inner, *a, **k)

    def restore():
        sse_rvb.rvb_sweep = inner
    return restore


def profile_timesteps(g, nsteps: int, beta: float = RVB_BETA) -> tuple[dict, list]:
    """Wall and device ms and device events per timestep of ``g`` (a
    ``QmcIsingGraph`` or a ``Qmc``) over ``nsteps`` timesteps under
    ``torch.profiler``, after a discarded one-step session; and the device
    rows, largest first."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        g.timestep(beta)
        torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(nsteps):
            g.timestep(beta)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = sorted(device_rows(prof, f"{nsteps} timesteps"),
                  key=lambda e: -e.self_device_time_total)
    return {"wall_ms": 1e3 * wall / nsteps,
            "device_ms": sum(e.self_device_time_total for e in rows) / 1e3 / nsteps,
            "events": sum(e.count for e in rows) / nsteps}, rows


def profile_rvb(g: QmcIsingGraph, nsteps: int = 2) -> dict:
    """Phase 7: device ms and events per timestep under ``torch.profiler``
    with RVB and, on the same graph, without it (the rest of the
    timestep); the RVB stage is the difference. Busy share: device time
    over the profiled wall time."""
    on, rows = profile_timesteps(g, nsteps)
    g.set_run_rvb(False)
    off, _ = profile_timesteps(g, nsteps)
    g.set_run_rvb(True)
    out = {"wall_ms_per_timestep_profiled": on["wall_ms"],
           "device_ms_per_timestep": on["device_ms"],
           "rvb_device_ms": on["device_ms"] - off["device_ms"], "rest_device_ms": off["device_ms"],
           "device_events_per_timestep": on["events"],
           "rvb_device_events": on["events"] - off["events"],
           "busy_share": on["device_ms"] / on["wall_ms"],
           "busy_share_without_rvb": off["device_ms"] / off["wall_ms"]}
    print("RVB timestep under the profiler: " + json.dumps(out) + "; largest device "
          "items, ms per timestep (calls):", flush=True)
    for e in rows[:16]:
        print(f"  {e.self_device_time_total / 1e3 / nsteps:.4f} ({e.count / nsteps:g})  "
              f"{e.key[:100]}", flush=True)
    return out


def run_rvb(dev) -> tuple[dict, dict]:
    """Phase 7 (a) and (b): the two_d_rvb_16 row at full width. Returns the
    printed results and the kernel launches of the measured timesteps."""
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    g = QmcIsingGraph(lattice.bench_two_d_periodic(RVB_L), 1.0, cutoff=RVB_CUTOFF,
                      replicas=RVB_R, seed=7, device=dev)
    g.timesteps(RVB_GROW, RVB_BETA)  # grow the string without RVB
    g.set_run_rvb(True)
    U = g._rvb_updates
    if U != (g.nvars + 1) // 2 or g.nvars != RVB_L * RVB_L:
        raise AssertionError(f"RVB updates a timestep {U}, N {g.nvars}")
    for _ in range(RVB_WARM):
        g.timestep(RVB_BETA)
    torch.cuda.synchronize()
    n = g.get_n()
    print(f"two_d_rvb_16: N={g.nvars}, R={RVB_R}, U={U}, beta={RVB_BETA}: grown and warm in "
          f"{time.perf_counter() - t0:.1f} s, cutoff {g.cutoff}, RVB compaction cutoff "
          f"{g._rvb_compact}, mean n {float(n.float().mean()):.1f}, max n {int(n.max())}",
          flush=True)

    stages = []

    def timed(inner, ops, *a, **k):
        n0 = op_count(ops)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = inner(ops, *a, **k)
        torch.cuda.synchronize()
        stages.append((time.perf_counter() - t1, n0, op_count(out[0])))
        return out

    walls = []
    ops.reset_launch_counts()
    restore = wrap_rvb_stage(timed)
    try:
        for _ in range(RVB_STEPS):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            g.timestep(RVB_BETA)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t1)
            if not g.verify():
                raise AssertionError("verify() failed after an RVB timestep")
    finally:
        restore()
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    if len(stages) != RVB_STEPS:
        raise AssertionError(f"{len(stages)} RVB stages in {RVB_STEPS} timesteps")
    for _, n0, n1 in stages:
        if not torch.equal(n0, n1):
            raise AssertionError("an RVB stage changed the op count")
    rate = g.rvb_success_rate()
    if not 0.0 < rate < 1.0:
        raise AssertionError(f"RVB success rate {rate} is not in (0, 1)")

    # Host reads of one timestep: those of the RVB stage, counted apart,
    # and the rest.
    rvb_reads, result = [], []

    def counted(inner, *a, **k):
        rvb_reads.append(count_syncs(lambda: result.append(inner(*a, **k))))
        return result[-1]

    restore = wrap_rvb_stage(counted)
    try:
        reads = count_syncs(lambda: g.timestep(RVB_BETA)) + rvb_reads[-1]
    finally:
        restore()
    prof = profile_rvb(g)
    if not g.verify():
        raise AssertionError("verify() failed after the profiled RVB timesteps")
    out = {
        "ms_per_timestep": 1e3 * float(np.mean(walls)),
        "ms_per_timestep_each": [1e3 * w for w in walls],
        "ms_per_rvb_stage": 1e3 * float(np.mean([s[0] for s in stages])),
        "host_reads_per_timestep": reads, "host_reads_in_rvb_stage": rvb_reads[-1],
        "rvb_success_rate": rate, "cutoff": g.cutoff, "rvb_compact": g._rvb_compact,
        "mean_n": float(g.get_n().float().mean()),
        "peak_device_memory_bytes": torch.cuda.max_memory_allocated(), **prof,
    }
    print("two_d_rvb_16: " + json.dumps(out), flush=True)
    M = g._rvb_compact or g.cutoff
    foot16 = sse_rvb.rvb_footprint(M, RVB_R, g.nvars, g._rvb_tables, U)
    edges32 = lattice.bench_two_d_periodic(RVB32_L)
    t32 = sse_rvb.make_rvb_tables(edges32, tfim_model(edges32, 1.0, device=dev))
    n32 = RVB32_L * RVB32_L
    foot32 = sse_rvb.rvb_footprint(RVB32_M, RVB32_R, n32, t32, (n32 + 1) // 2)
    print(f"largest RVB tensors, bytes: two_d_rvb_16 {json.dumps(foot16)}; "
          f"two_d_rvb_32 (not run) {json.dumps(foot32)}", flush=True)
    return out, counts


def check_rvb_physics(dev) -> None:
    """Phase 7 (c) and (d): a 4-site ring with RVB against ED, and the
    verify soak (the JAX package's tests/test_rvb.py:20-97)."""
    edges = lattice.chain(4, j=1.0)
    beta = 1.5
    for h, seed in ((0.0, 11), (0.4, 13)):
        g = QmcIsingGraph(edges, 1.0, longitudinal=h, cutoff=96, replicas=128, seed=seed,
                          device=dev)
        g.set_run_rvb(True, updates_per_timestep=2)
        g.timesteps(48, beta, chunk=48)
        e = g.timesteps(192, beta, chunk=48).cpu().numpy()
        exact = exact_tfim_energy(edges, 1.0, beta, 4, h=h)
        se = e.std() / np.sqrt(len(e))
        print(f"4-site ring with RVB, h={h}, beta={beta}, R=128: E = {e.mean():.5f} +- "
              f"{se:.5f} (ED {exact:.5f}, {abs(e.mean() - exact) / se:.2f} SE), success "
              f"rate {g.rvb_success_rate():.4f}", flush=True)
        if not np.all(np.isfinite(e)) or abs(e.mean() - exact) >= 5 * se or not g.verify():
            raise AssertionError(f"the RVB ring at h={h} is not within 5 SE of ED")
    for edges, gamma, seed in ((lattice.square(3, 3, j=1.0), 1.0, 0),
                               (lattice.frustrated_square(4, 4, j=1.0), 2.0, 3)):
        g = QmcIsingGraph(edges, gamma, replicas=16, seed=seed, device=dev)
        g.set_run_rvb(True, updates_per_timestep=5)
        for _ in range(8):
            g.timestep(1.0)
            if not g.verify():
                raise AssertionError("verify() failed in the RVB soak")
    print("RVB verify soak: 3x3 and frustrated 4x4, 8 timesteps each, verify() true",
          flush=True)


def wrap_generic_stages(record: list):
    """Replaces the generic timestep's stage functions by ones timed with a
    host clock between synchronisations: ``record`` receives ``(stage,
    seconds, loop stats or None)`` per call. Returns the restoring
    function."""
    patches = [(sse_runner, "diagonal_update", "diagonal"),
               (sse_loops, "loop_update", "loops"),
               (sse_cluster, "segment_graph", "cluster"),
               (sse_cluster, "cluster_update_impl", "cluster"),
               (sse_runner, "resample_free_spins", "free spins")]
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in patches]

    def timed(inner, stage):
        def call(*a, **k):
            stats = k.setdefault("stats", {}) if stage == "loops" else None
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = inner(*a, **k)
            torch.cuda.synchronize()
            record.append((stage, time.perf_counter() - t0, stats))
            return out
        return call

    for (mod, attr, inner), (_, _, stage) in zip(saved, patches):
        setattr(mod, attr, timed(inner, stage))

    def restore():
        for mod, attr, inner in saved:
            setattr(mod, attr, inner)
    return restore


def staged_timesteps(q: Qmc, nsteps: int) -> dict:
    """ms per stage of ``nsteps`` timesteps of ``q`` (host clock between
    synchronisations, so outside the measured timesteps) and the loop
    walks: hops an update (the longest walk and the mean), hops run (whole
    blocks), host reads an update."""
    record: list = []
    restore = wrap_generic_stages(record)
    try:
        for _ in range(nsteps):
            q.timestep(GEN_BETA)
    finally:
        restore()
    ms = {st: 1e3 * sum(t for s_, t, _ in record if s_ == st) / nsteps
          for st in ("diagonal", "loops", "cluster", "free spins")}
    walks = [x for s_, _, x in record if s_ == "loops"]
    if len(walks) != nsteps:
        raise AssertionError(f"{len(walks)} loop updates in {nsteps} timesteps")
    reads = [w["host_reads"] for w in walks]
    hops_run = sse_loops.HOP_BLOCK * float(np.mean(reads))
    return {"ms_per_stage": ms, "ms_per_staged_timestep": sum(ms.values()),
            "hops_longest": [int(w["hops"].max()) for w in walks],
            "hops_mean": float(np.mean([float(w["hops"].float().mean()) for w in walks])),
            "host_reads_per_loop_update": float(np.mean(reads)),
            "ms_per_hop_run": ms["loops"] / hops_run}


def profile_loop_update(q: Qmc) -> dict:
    """Device ms and events of one loop update on ``q``'s string under
    ``torch.profiler`` (the result is discarded), per hop run."""
    from torch.profiler import ProfilerActivity, profile

    sse = q.get_manager_ref(), q.state_ref()

    def run(stats):
        sse_loops.loop_update(*sse, q.draws.loops(), q.model, stats=stats)
        torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        run({})
    stats: dict = {}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(stats)
        wall = time.perf_counter() - t0
    rows = device_rows(prof, "a loop update")
    hops_run = sse_loops.HOP_BLOCK * stats["host_reads"]
    dev_ms = sum(e.self_device_time_total for e in rows) / 1e3
    events = sum(e.count for e in rows)
    return {"hops_run": hops_run, "loop_wall_ms": 1e3 * wall, "loop_device_ms": dev_ms,
            "device_events_per_hop": events / hops_run,
            "device_us_per_hop": 1e3 * dev_ms / hops_run,
            "loop_busy_share": dev_ms / (1e3 * wall)}


def measure_generic(q: Qmc, label: str, nsteps: int, nstaged: int, card: str) -> dict:
    """The measured timesteps of phase 8a or 8b: ``verify()`` after each,
    then the staged timesteps, the host reads of one timestep, two
    profiled timesteps and one profiled loop update. Returns the printed
    results, with the op counts ``[nsteps, R]`` under ``"ns"``."""
    walls, ns = [], []
    for _ in range(nsteps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        q.timestep(GEN_BETA)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        ns.append(q.get_n().cpu().numpy())
        if not q.verify():
            raise AssertionError(f"{label}: verify() failed after a timestep")
    ns = np.stack(ns)
    if not np.all(np.isfinite(-ns / GEN_BETA + q.get_offset())):
        raise AssertionError(f"{label}: energies are not finite")
    out = {"ms_per_timestep": 1e3 * float(np.mean(walls)),
           "ms_per_timestep_each": [1e3 * w for w in walls],
           "loop_revert_rate": q.loop_revert_rate(), "cutoff": q.get_cutoff(),
           "mean_n": float(ns.mean())}
    out.update(staged_timesteps(q, nstaged))
    out["host_reads_per_timestep"] = count_syncs(lambda: q.timestep(GEN_BETA))
    prof, rows = profile_timesteps(q, 2, beta=GEN_BETA)
    out.update({"wall_ms_per_timestep_profiled": prof["wall_ms"],
                "device_ms_per_timestep": prof["device_ms"],
                "device_events_per_timestep": prof["events"],
                "busy_share": prof["device_ms"] / prof["wall_ms"]})
    out.update(profile_loop_update(q))
    if not q.verify():
        raise AssertionError(f"{label}: verify() failed after the staged timesteps")
    out["peak_device_memory_bytes"] = torch.cuda.max_memory_allocated()
    print(f"{label} ({card}): " + json.dumps(out), flush=True)
    print(f"{label}: largest device items of the profiled timesteps, ms per timestep (calls):",
          flush=True)
    for e in rows[:10]:
        print(f"  {e.self_device_time_total / 1e3 / 2:.4f} ({e.count / 2:g})  {e.key[:100]}",
              flush=True)
    out["ns"] = ns
    return out


def run_generic_tfim(g: QmcIsingGraph, ns_ref, card: str) -> dict:
    """Phase 8a: phase 5's grown 32x32 graph through ``into_qmc`` with
    loops at full width; K2, K3 and K4 launched in the measured timesteps,
    its mean op count against phase 5's; then a short heat-bath run, K3-hb
    launched and K3 not. Returns the measured timesteps' launches."""
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    q = g.into_qmc()
    q.set_do_loop_updates(True)
    if not (q.should_do_cluster_update() and q.model.max_legs == 2 and q.nvars == N
            and q.replicas == R and q.get_offset() == g.get_offset()):
        raise AssertionError("into_qmc did not carry the 32x32 graph over")
    for _ in range(GEN_WARM):
        q.timestep(GEN_BETA)
    torch.cuda.synchronize()
    print(f"32x32 Qmc from into_qmc, loops and clusters, R={R}, beta={GEN_BETA}: "
          f"{GEN_WARM} warm timesteps in {time.perf_counter() - t0:.1f} s, cutoff "
          f"{q.get_cutoff()}", flush=True)
    ops.reset_launch_counts()
    out = measure_generic(q, "8a 32x32 Qmc with loops", GEN_STEPS, GEN_STAGED, card)
    counts = ops.launch_counts()
    print(f"kernel launches in 8a's measured timesteps: {counts}", flush=True)
    kernels = ("parity_bits", "carry_decisions", *SSE_K4)
    if min(counts[k] for k in kernels) <= 0:
        raise AssertionError(f"a kernel of the generic path was not launched: {counts}")
    print(mean_n_agrees("Qmc with loops", out["ns"], "QmcIsingGraph (phase 5)", ns_ref),
          flush=True)

    q.set_do_heatbath(True)
    ops.reset_launch_counts()
    for _ in range(GEN_HB):
        q.timestep(GEN_BETA)
        if not q.verify():
            raise AssertionError("verify() failed in the generic heat-bath run")
    torch.cuda.synchronize()
    hb = ops.launch_counts()
    print(f"kernel launches in {GEN_HB} heat-bath timesteps of the Qmc: {hb}", flush=True)
    if hb["carry_decisions_heatbath"] <= 0 or hb["carry_decisions"] != 0:
        raise AssertionError(f"the generic heat-bath run did not take K3-hb alone: {hb}")
    return counts


def xxz_qmc(dev, edges, nvars: int, replicas: int, seed: int) -> Qmc:
    """The XXZ exchange on every edge, loops only."""
    q = Qmc(nvars, replicas=replicas, seed=seed, do_loop_updates=True, device=dev)
    for (a, b), _ in edges:
        q.make_interaction(W_XXZ, [a, b])
    if q.has_cluster_edges or q.should_do_cluster_update():
        raise AssertionError("the XXZ model has no cluster edges")
    return q


def run_generic_xxz(dev, card: str) -> dict:
    """Phase 8b: the XXZ exchange on the 2048 edges of the 32x32 lattice at
    R=256, loops only, grown from a cold cutoff, ``verify()`` after every
    timestep; K2 and K3 launched, K4 not; the revert rate below 1. Returns
    the measured timesteps' launches."""
    torch.cuda.reset_peak_memory_stats()
    edges = lattice.bench_two_d_periodic(32)
    t0 = time.perf_counter()
    q = xxz_qmc(dev, edges, N, R, seed=11)
    if len(edges) != 2048:
        raise AssertionError(f"{len(edges)} edges")
    for _ in range(XXZ_GROW):  # single timesteps, the cutoff grown after each
        q.timestep(GEN_BETA)
        if not q.verify():
            raise AssertionError("8b: verify() failed in a growth timestep")
    torch.cuda.synchronize()
    print(f"32x32 XXZ, loops only, R={R}, beta={GEN_BETA}: {XXZ_GROW} growth timesteps in "
          f"{time.perf_counter() - t0:.1f} s, verify() after each, cutoff {q.get_cutoff()}",
          flush=True)
    q.total_loop_reverts = q.total_loop_updates = 0
    ops.reset_launch_counts()
    out = measure_generic(q, "8b 32x32 XXZ with loops", XXZ_STEPS, XXZ_STAGED, card)
    counts = ops.launch_counts()
    print(f"kernel launches in 8b's measured timesteps: {counts}", flush=True)
    if counts["parity_bits"] <= 0 or counts["carry_decisions"] <= 0 or any(
            counts[k] for k in SSE_K4):
        raise AssertionError(f"the XXZ path did not take K2 and K3 without K4: {counts}")
    if not out["loop_revert_rate"] < 1.0:
        raise AssertionError(f"every XXZ walk reverted: {out['loop_revert_rate']}")
    return counts


def exact_generic_energy(nvars: int, interactions, beta: float) -> float:
    """Thermal <H> of ``H = -sum_b W_b`` by dense ED: ``W_b`` a 2^k x 2^k
    matrix (row = outputs) or a diagonal over its variables, the first the
    most significant bit; the SSE estimator is ``-<n>/beta`` of it."""
    dim = 1 << nvars
    idx = np.arange(dim)
    H = np.zeros((dim, dim))
    for mat, vars in interactions:
        k = len(vars)
        mask = sum(1 << v for v in vars)
        loc = sum(((idx >> v) & 1) << (k - 1 - l) for l, v in enumerate(vars))
        if mat.ndim == 1:
            H[idx, idx] -= mat[loc]
            continue
        for o in range(1 << k):
            out = (idx & ~mask) | sum(((o >> (k - 1 - l)) & 1) << v for l, v in enumerate(vars))
            H[out, idx] -= mat[o, loc]
    w = np.linalg.eigvalsh(H)
    z = np.exp(-beta * (w - w.min()))
    return float(((w - w.min()) * z).sum() / z.sum()) + float(w.min())


def check_generic_physics(dev) -> None:
    """Phase 8c: on the card, against dense ED within 5 standard errors:
    the XXZ chain (L=8) with loops, the same chain with a forced cap of 16
    hops (revert rate in (0.005, 0.95)), and a 3-spin model on a 6-site
    ring with a transverse field, loops and clusters, whose diagonal update
    runs K2 at K=3."""
    beta = 1.2
    chain = lattice.chain(8, periodic=False)
    cases = [("XXZ chain L=8", lambda: xxz_qmc(dev, chain, 8, 512, seed=21), None),
             ("XXZ chain L=8, cap 16", lambda: xxz_qmc(dev, chain, 8, 512, seed=22), 16)]

    def three_spin():
        q = Qmc(6, replicas=512, seed=23, do_loop_updates=True, device=dev)
        for a in range(6):
            q.make_diagonal_interaction_and_offset(W_3SPIN, [a, (a + 1) % 6, (a + 2) % 6])
        for v in range(6):
            q.make_interaction(np.full((2, 2), 0.6), [v])
        if q.model.max_legs != 3 or not q.should_do_cluster_update():
            raise AssertionError("the 3-spin model is not K=3 with clusters")
        return q

    cases.append(("3-spin ring N=6 with a field", three_spin, None))
    for label, make, cap in cases:
        q = make()
        q.set_loop_cap(cap)
        q.timesteps(30, beta)
        q.total_loop_reverts = q.total_loop_updates = 0
        ops.reset_launch_counts()
        total_n = torch.zeros(q.replicas, dtype=torch.float64, device=dev)
        steps = 120
        for _ in range(steps):
            q.timestep(beta)
            total_n += q.get_n()
        e = (-(total_n / steps) / beta).cpu().numpy()
        exact = exact_generic_energy(q.nvars, q._interactions, beta)
        se = e.std() / np.sqrt(len(e))
        rate = q.loop_revert_rate()
        k2 = ops.launch_counts()["parity_bits"]
        print(f"{label}, beta={beta}, R={q.replicas}, K={q.model.max_legs}: -<n>/beta "
              f"{e.mean():.5f} +- {se:.5f} (ED {exact:.5f}, {abs(e.mean() - exact) / se:.2f} "
              f"SE), revert rate {rate:.4f}, K2 launches {k2}", flush=True)
        if not np.all(np.isfinite(e)) or abs(e.mean() - exact) >= 5 * se or not q.verify():
            raise AssertionError(f"{label} is not within 5 SE of ED")
        if cap is not None and not 0.005 < rate < 0.95:
            raise AssertionError(f"{label}: the cap must fire (rate {rate})")
        if k2 <= 0:
            raise AssertionError(f"{label}: K2 was not launched")


# -- Phase 3: K2's wide and global-memory variants ------------------------------------

# K2 past the shared variant's limit (N > 29,056): K=2, the 192x192 benchmark
# lattice's N, M as on the 32x32 slice, R=64 (the wide variant); and past
# the wide variant's (N > 53,472), where the global variant takes it.
K2G_SHAPE = (2, 7000, 64, 36_864)
K2_PAST_SHAPE = (2, 500, 32, 60_000)
# The wide variant's passes by kernel name (the scratch's zeroing is "other").
K2_WIDE_PASSES = {"toggles": "parity_toggles_wide", "prefix": "parity_prefix_kernel",
                  "walk": "parity_bits_wide_kernel", "state": "parity_state_bits"}
# The entry point of each K2 variant, whose launch counter shows the dispatch.
K2_ENTRIES_BY_VARIANT = {"shared": "parity_bits", "wide": "parity_bits_wide",
                         "global": "parity_bits_global"}
K2_ENTRIES = tuple(K2_ENTRIES_BY_VARIANT.values())


def parity_through_dispatch(shape: tuple, want_variant: str, rng, dev) -> tuple:
    """K2 through ``parity_bits`` at (K, M, R, N) = ``shape``: the variant
    that ``k2_variant`` names must be the only one launched, once, and equal
    to the plain version. Returns (inputs, outputs, error)."""
    k, m, r, n = shape
    if ops.parity_kernel.k2_variant(n) != want_variant:
        raise AssertionError(f"N={n} does not take K2's {want_variant} variant")
    full = kernel_inputs(rng, dev, k, m, r, n)["parity_bits"]
    ops.reset_launch_counts()
    got = ops.parity_bits(*full)
    torch.cuda.synchronize()
    counts = {name: ops.launch_counts()[name] for name in K2_ENTRIES}
    want = ops.parity_bits_plain(*full)
    torch.cuda.synchronize()
    if counts != {name: int(name == K2_ENTRIES_BY_VARIANT[want_variant]) for name in K2_ENTRIES}:
        raise AssertionError(f"N={n} did not take K2's {want_variant} variant alone: {counts}")
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise AssertionError(f"parity_bits differs from its plain version at {shape}")
    err = max(float((g.to(torch.int64) - w.to(torch.int64)).abs().max())
              for g, w in zip(got, want))
    return full, got, err


def check_parity_variants(dev, rng) -> dict:
    """Phase 3 for K2's wide and global-memory variants: each equal to the
    plain version at K = 1..6 on ragged shapes (called directly), with
    distinct and with repeated toggled legs; through ``parity_bits`` at
    K=2, M=7000, R=64, N=36,864, where only the wide variant may launch,
    timed there in turns against the global variant (its only path before),
    and at N = 60,000, past the wide variant's limit, where only the global
    variant may launch: its row of the ``kernels`` line (no SSE model
    reaches that N: its int32 leg key needs N < 32,768)."""
    ragged = ((37, 5, 9), (301, 48, 40), (130, 33, 37), (7, 1, 6), (1000, 64, 70))
    parity_equal(ops.parity_bits_wide, "parity_bits_wide", ragged, rng, dev)
    parity_equal(ops.parity_bits_global, "parity_bits_global", ragged, rng, dev)
    full, got, err = parity_through_dispatch(K2G_SHAPE, "wide", rng, dev)
    times = in_turns({"parity_bits_global": lambda: ops.parity_bits_global(*full),
                      "parity_bits_wide": lambda: ops.parity_bits_wide(*full)}, 20)
    b = bound(nbytes(*full, *got))
    print(f"K2 at (K, M, R, N) = {K2G_SHAPE} through parity_bits: the wide variant alone, "
          f"equal to plain (max_abs_err {err}); device ms in turns {json.dumps(times)} "
          f"(the global variant's recorded 0.5891-0.5917), bound {b['bound_ms']:.4f} ms "
          f"({b['bound_by']}, {nbytes(*full, *got) / 1e6:.2f} MB)", flush=True)

    full, got, err = parity_through_dispatch(K2_PAST_SHAPE, "global", rng, dev)
    launched = ops.parity_bits_global.launches
    ms = device_ms(lambda: ops.parity_bits(*full), 10)
    call_ms = cuda_ms(lambda: ops.parity_bits(*full), 10)
    plain_ms = cuda_ms(lambda: ops.parity_bits_plain(*full), 1)
    res = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           **bound(nbytes(*full, *got)), "library_ms": None, "dispatch_launches": launched}
    print(f"K2 at (K, M, R, N) = {K2_PAST_SHAPE} through parity_bits: the global variant "
          f"alone (launches 1), equal to plain (max_abs_err {err}); kernels {ms:.4f} ms on the "
          f"device ({call_ms:.4f} ms a call, CUDA events), plain {plain_ms:.4f} ms, bound "
          f"{res['bound_ms']:.4f} ms ({res['bound_by']}, "
          f"{nbytes(*full, *got) / 1e6:.2f} MB)", flush=True)
    return res


# -- Phase 9: parallel tempering on one card ---------------------------------------------

# 9a: scripts/profile_tempering.py's ladder at the SSE main cell's width:
# 64 betas in [0.5, 1.5], 4 replicas each (R=256), on the 32x32 lattice.
PT_BETAS = np.linspace(0.5, 1.5, 64)
PT_PER_BETA, PT_SEED = 4, 3
PT_GROW, PT_WARM, PT_SAMPLE, PT_CHUNK = 48, 16, 64, 32
# In turns: PT_ROUNDS rounds of (tempering, bare, bare, tempering) chunks of
# PT_TURN sweeps; the host moves a sweep's wall by about 1 ms between chunks.
PT_TURN, PT_ROUNDS = 16, 4
# 9b: the transverse ladder, heat-bath.
PT_SCALES = np.geomspace(0.5, 2.0, 64)
# 9c: two 128-replica graphs at beta=1, the second with the signs of a
# seeded random half of the edges flipped.
PT_SIGNED_R, PT_FLIP_SEED = 128, 5
# 9e: sweeps run before and after a checkpoint.
CKPT_SWEEPS = 4
# 9f: K2's global variant on a model. The cutoff starts at N and the leg
# sort key needs N * M < 2^30, so N^2 < 2^30: L = 176 (N = 30,976, past
# 29,056) keeps M below 2^30 / N = 34,664 while 1.5 n_max stays under the
# floor M = N, which beta = 0.1 gives (0.34 ops a spin on the 16x16 and
# 32x32 lattices in a CPU run of the port).
BIG_L, BIG_R, BIG_BETA, BIG_STEPS = 176, 32, 0.1, 6


def pair_acceptance(levels_before: np.ndarray, levels_t: np.ndarray,
                    attempts: int) -> np.ndarray:
    """Acceptance of each neighbour pair of beta levels: the sweeps in which
    a replica moved from level i to i + 1, over the attempts on that pair.
    ``levels_t [T, R]`` are the replicas' levels after each sweep's swap."""
    prev = np.concatenate([levels_before[None], levels_t[:-1]])
    up = (levels_t == prev + 1)
    nlev = int(levels_before.max()) + 1
    moved = np.zeros(nlev - 1)
    for i in range(nlev - 1):
        moved[i] = (up & (prev == i)).sum()
    return moved / max(attempts, 1)


def bare_chunk(tc, nsweeps: int) -> None:
    """``nsweeps`` sweeps of ``tc``'s graph at its labels with no swap,
    through the same entry and chunk bookkeeping as a tempering chunk (a
    ``swap_freq`` past the chunk), so the two differ by the swaps alone."""
    tc.timesteps_sample(nsweeps, swap_freq=nsweeps + 1, chunk=nsweeps)


def tempering_chunk(tc, nsweeps: int) -> None:
    """One tempering chunk of ``nsweeps`` sweep+swap steps."""
    tc.timesteps_sample(nsweeps, chunk=nsweeps)


def profile_per_sweep(run, nsweeps: int) -> dict:
    """Wall and device ms and device events per sweep of ``run(nsweeps)``
    under ``torch.profiler``, after a discarded one-sweep profile; the
    busy share."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        run(1)
        torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(nsweeps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = device_rows(prof, f"{nsweeps} sweeps")
    dev_ms = sum(e.self_device_time_total for e in rows) / 1e3 / nsweeps
    wall_ms = 1e3 * wall / nsweeps
    return {"wall_ms_per_sweep_profiled": wall_ms, "device_ms_per_sweep": dev_ms,
            "device_events_per_sweep": sum(e.count for e in rows) / nsweeps,
            "busy_share": dev_ms / wall_ms}


def tempering_in_turns(tc, chunk: int, rounds: int) -> dict:
    """ms per sweep of a tempering chunk (a sweep and a swap each) and of a
    bare chunk (:func:`bare_chunk`) at the same R and per-replica labels,
    on the same graph, in
    turns (T, B, B, T, ``rounds`` times), host clock around work that ends
    in a synchronize."""
    times = {"tempering": [], "bare": []}
    for label in ("tempering", "bare", "bare", "tempering") * rounds:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (tempering_chunk if label == "tempering" else bare_chunk)(tc, chunk)
        torch.cuda.synchronize()
        times[label].append(1e3 * (time.perf_counter() - t0) / chunk)
    return times


def reads_and_hook_rounds(fn) -> dict:
    """Host reads of ``fn()`` (:func:`count_syncs`) beside its label hook
    rounds (``hook_min`` launches), each of which reads one flag: the
    reads that depend on the data."""
    ops.reset_launch_counts()
    reads = count_syncs(fn)
    return {"reads": reads, "hook_rounds": ops.launch_counts()["hook_min"]}


def beta_levels(betas, ladder) -> np.ndarray:
    """Each replica's level on the beta ladder."""
    b = betas.cpu().numpy()
    return np.abs(b[:, None] - np.asarray(ladder, np.float32)[None, :]).argmin(axis=1)


def run_tempering(tc, label: str, card: str, ladder=None) -> tuple[dict, dict]:
    """Phases 9a-9c: grow ``tc`` (single timesteps until the cutoff is
    stable), warm it, then the measured ``timesteps_sample(PT_SAMPLE,
    swap_freq=1)`` in chunks of ``PT_CHUNK``, whose kernel launches are
    returned; on a beta ``ladder`` the neighbour levels' acceptance from the
    sampled betas; host reads per chunk, the in-turns times and the
    profile; ``verify()`` after each stage."""
    t0 = time.perf_counter()
    tc.timesteps(PT_GROW)
    tc.timesteps_sample(PT_WARM, chunk=PT_CHUNK)
    torch.cuda.synchronize()
    if not tc.verify():
        raise AssertionError(f"{label}: verify() failed after the growth")
    g = tc.graph
    print(f"{label}: R={tc.replicas}, grown and warm in {time.perf_counter() - t0:.1f} s, "
          f"cutoff {g.cutoff}, caps {g._cluster_caps}", flush=True)
    betas_before = tc.betas
    p0, swaps0 = tc._parity, tc.total_swaps
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    states, bet = tc.timesteps_sample(PT_SAMPLE, swap_freq=1, chunk=PT_CHUNK)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t1
    counts = ops.launch_counts()
    swaps = tc.total_swaps - swaps0
    if states.shape != (PT_SAMPLE, tc.replicas, g.nvars) or not tc.verify():
        raise AssertionError(f"{label}: bad samples {tuple(states.shape)} or verify() failed")
    print(f"kernel launches in {label}'s {PT_SAMPLE} measured sweep+swap steps: {counts}",
          flush=True)
    reads = {"tempering": reads_and_hook_rounds(lambda: tempering_chunk(tc, PT_CHUNK)),
             "bare": reads_and_hook_rounds(lambda: bare_chunk(tc, PT_CHUNK)),
             "one_swap_alone": reads_and_hook_rounds(lambda: tempering._swap_labels(
                 g.sse, g.model, tc.betas, tc.scales, tc.xors, tc._hb, tc.hetero,
                 torch.rand(tc.replicas, device=tc.device), tc._parity))}
    turns = tempering_in_turns(tc, PT_TURN, PT_ROUNDS)
    prof = {k: profile_per_sweep(lambda n: run(tc, n), 4)
            for k, run in (("tempering", tempering_chunk), ("bare", bare_chunk))}
    if not tc.verify():
        raise AssertionError(f"{label}: verify() failed after the measured runs")
    out = {
        "card": card, "R": tc.replicas, "cutoff": g.cutoff,
        "ms_per_sweep_swap": 1e3 * secs / PT_SAMPLE,
        "swaps_per_step": swaps / PT_SAMPLE,
        "in_turns_ms_per_sweep": turns,
        "swap_overhead_ms_medians": float(np.median(turns["tempering"])
                                          - np.median(turns["bare"])),
        "host_reads_per_chunk": reads, "chunk": PT_CHUNK, "profiled": prof,
        "swap_device_ms": prof["tempering"]["device_ms_per_sweep"]
        - prof["bare"]["device_ms_per_sweep"],
        "swap_device_events": prof["tempering"]["device_events_per_sweep"]
        - prof["bare"]["device_events_per_sweep"],
        "mean_n": float(g.get_n().float().mean()),
    }
    if ladder is not None:
        # Ranks 4i + 3 and 4i + 4 pair across levels i and i + 1 at odd parity.
        attempts = sum(1 for i in range(PT_SAMPLE) if (p0 + i) % 2 == 1)
        levels_t = np.stack([beta_levels(b, ladder) for b in bet])
        acc = pair_acceptance(beta_levels(betas_before, ladder), levels_t, attempts)
        out["pair_acceptance_min_median_max"] = [float(acc.min()), float(np.median(acc)),
                                                 float(acc.max())]
    print(f"{label}: " + json.dumps(out), flush=True)
    return out, counts


def run_tempering_homogeneous(dev, card: str) -> tuple:
    """Phase 9a: the homogeneous beta ladder at full width, Metropolis."""
    tc = TemperingContainer(lattice.bench_two_d_periodic(32), transverse=1.0,
                            betas=PT_BETAS, replicas_per_beta=PT_PER_BETA, seed=PT_SEED,
                            device=dev)
    out, counts = run_tempering(tc, "9a homogeneous ladder", card, PT_BETAS)
    if min(counts[k] for k in ("parity_bits", "carry_decisions", *SSE_K4)) <= 0 or \
            counts["carry_decisions_heatbath"]:
        raise AssertionError(f"9a did not run through K2, K3 and K4: {counts}")
    return tc, out, counts


def run_tempering_hetero(dev, card: str) -> tuple:
    """Phase 9b: the transverse ladder at beta=1, heat-bath: K3-hb with
    per-replica tables and the bond-count swap term; K3 must not launch."""
    tc = TemperingContainer(lattice.bench_two_d_periodic(32), transverse=1.0,
                            betas=[1.0] * len(PT_SCALES), replicas_per_beta=PT_PER_BETA,
                            transverse_scales=PT_SCALES, seed=PT_SEED + 1, device=dev)
    tc.set_enable_heatbath(True)
    if not (tc.hetero and tc._hb.cum_max_w.dim() == 2):
        raise AssertionError("9b: the ladder is not heterogeneous with per-replica tables")
    out, counts = run_tempering(tc, "9b transverse ladder, heat-bath", card)
    if min(counts[k] for k in ("parity_bits", "carry_decisions_heatbath", *SSE_K4)) <= 0 or \
            counts["carry_decisions"]:
        raise AssertionError(f"9b did not run through K2, K3-hb and K4 alone: {counts}")
    got = np.sort(tc.class_scales[:, 1])
    if not np.allclose(got, np.sort(np.repeat(PT_SCALES.astype(np.float32), PT_PER_BETA))):
        raise AssertionError("9b: the transverse labels are no permutation of the ladder")
    return tc, out, counts


def run_tempering_signed(dev, card: str, take0_per_sweep_9a: float) -> tuple:
    """Phase 9c: two 128-replica graphs at beta=1 in one container, the
    second with a seeded random half of the edges' signs flipped: sign
    patterns (``xors``) through the sweeps (K4's ``fetch_xor``) and swaps
    by ``log_weight_delta``."""
    edges = lattice.bench_two_d_periodic(32)
    flip = np.random.default_rng(PT_FLIP_SEED).permutation(len(edges))[:len(edges) // 2]
    signs = np.ones(len(edges))
    signs[flip] = -1
    flipped = [(e, j * s) for (e, j), s in zip(edges, signs)]
    tc = tempering.new_with_rng(seed=PT_SEED + 2, device=dev)
    tc.add_qmc_stepper(QmcIsingGraph(edges, 1.0, replicas=PT_SIGNED_R, seed=1, device=dev), 1.0)
    tc.add_qmc_stepper(QmcIsingGraph(flipped, 1.0, replicas=PT_SIGNED_R, seed=2, device=dev),
                       1.0)
    if tc.replicas != 2 * PT_SIGNED_R or tc.xors is None:
        raise AssertionError("9c: the signed ladder has no sign patterns")
    if int(tc.xors.sum()) != PT_SIGNED_R * len(flip):
        raise AssertionError("9c: the sign patterns do not mark the flipped edges")
    out, counts = run_tempering(tc, "9c signed ladder", card)
    take0_per_sweep = counts["take0"] / PT_SAMPLE
    print(f"9c: take0 launches a sweep+swap {take0_per_sweep:g} against 9a's "
          f"{take0_per_sweep_9a:g}: fetch_xor adds one in the diagonal update, one in the "
          f"cluster update and two in each swap's log_weight_delta", flush=True)
    if min(counts[k] for k in ("parity_bits", "carry_decisions", *SSE_K4)) <= 0 or \
            take0_per_sweep < take0_per_sweep_9a + 4:
        raise AssertionError(f"9c did not run through K2, K3 and K4 with fetch_xor: {counts}")
    return tc, out, counts


def ring(pattern) -> list:
    """The 4-site ring with a per-bond coupling pattern
    (``tests/test_tempering_hetero.py``'s ``_disorder_edges``)."""
    return [(e, j * p) for (e, j), p in zip(lattice.chain(4, j=1.0), pattern)]


def series_se(x: np.ndarray) -> float:
    """Standard error of the mean of a correlated series ``[T]``."""
    return float(x.std(ddof=1) * np.sqrt(integrated_autocorrelation_time(x) / len(x)))


PHYS_R, PHYS_WARM, PHYS_STEPS = 256, 60, 200


def check_tempering_physics(dev) -> None:
    """Phase 9d: the 4-site cases of ``tests/test_tempering_hetero.py`` on
    the card. (1) ``test_heatbath_hetero_matches_ed``: a transverse ladder
    (scales 0.5, 1.5, beta=1.5) with heat-bath and no swaps; each rung's
    mean energy (per-replica means, independent) within 5 SE of ED. (2)
    ``test_signed_ladder_accepted_and_stationary``: the ring and its
    frustrated twin (one edge's sign flipped) at beta=1 in one container,
    a swap every second timestep; each label's mean energy (over the
    replicas that hold it at each step, SE from the series' tau) within
    5 SE of ED."""
    L, beta, scales = 4, 1.5, [0.5, 1.5]
    edges = lattice.chain(L, j=1.0)
    tc = TemperingContainer(edges, transverse=1.0, betas=[beta, beta],
                            replicas_per_beta=PHYS_R, transverse_scales=scales, seed=21,
                            device=dev)
    tc.set_enable_heatbath(True)
    tc.timesteps(PHYS_WARM)
    scale_r = tc.class_scales[:, 1].astype(np.float64)
    offset_r = sum(abs(j) for _, j in edges) + L * scale_r
    ns = []
    for _ in range(PHYS_STEPS):
        tc.timesteps(1)
        ns.append(tc.graph.get_n())
    e = -torch.stack(ns).double().cpu().numpy() / beta + offset_r  # [T, R]
    for g in scales:
        per_rep = e[:, np.isclose(scale_r, g)].mean(axis=0)
        got, se = per_rep.mean(), per_rep.std(ddof=1) / np.sqrt(len(per_rep))
        want = exact_tfim_energy(edges, g, beta, L)
        print(f"9d heat-bath transverse ladder, scale {g}: E = {got:.5f} +- {se:.5f} (ED "
              f"{want:.5f}, {abs(got - want) / se:.2f} SE)", flush=True)
        if abs(got - want) >= 5 * se:
            raise AssertionError(f"9d: rung {g} is not within 5 SE of ED")
    if not tc.verify():
        raise AssertionError("9d: verify() failed on the heat-bath ladder")

    beta = 1.0
    e_a, e_b = ring([1.0] * 4), ring([-1.0, 1.0, 1.0, 1.0])
    tc = tempering.new_with_rng(seed=8, device=dev)
    tc.add_qmc_stepper(QmcIsingGraph(e_a, 1.0, replicas=PHYS_R, seed=1, device=dev), beta)
    tc.add_qmc_stepper(QmcIsingGraph(e_b, 1.0, replicas=PHYS_R, seed=2, device=dev), beta)
    tc.timesteps(PHYS_WARM)
    ns, labels = [], []
    for i in range(PHYS_STEPS):
        tc.timesteps(1)
        if i % 2 == 0:
            tc.tempering_step()
        ns.append(tc.graph.get_n())
        labels.append(tc.xors[:, 0] == 0)
    e = -torch.stack(ns).double().cpu().numpy() / beta + tc.graph.model.offset
    is_a = torch.stack(labels).cpu().numpy()
    if tc.get_total_swaps() <= 0 or not tc.verify():
        raise AssertionError("9d: the signed ladder did not swap or failed verify()")
    for name, sel, edges_l in (("a (ring)", is_a, e_a), ("b (one edge flipped)", ~is_a, e_b)):
        series = np.array([row[m].mean() for row, m in zip(e, sel)])
        got, se = series.mean(), series_se(series)
        want = exact_tfim_energy(edges_l, 1.0, beta, 4)
        print(f"9d signed ladder, label {name}: E = {got:.5f} +- {se:.5f} (ED {want:.5f}, "
              f"{abs(got - want) / se:.2f} SE), {tc.get_total_swaps()} swaps", flush=True)
        if abs(got - want) >= 5 * se:
            raise AssertionError(f"9d: label {name} is not within 5 SE of ED")


def check_checkpoints(tc, g: QmcIsingGraph) -> None:
    """Phase 9e: save 9a's container, phase 5's graph and a ``Qmc`` (that
    graph through ``into_qmc`` with loops) with their generators; run
    ``CKPT_SWEEPS`` sweeps on each; load each file and run the same sweeps;
    the op strings, states and labels are ``torch.equal``."""
    import tempfile
    from pathlib import Path

    q = g.into_qmc()
    q.set_do_loop_updates(True)
    q.timestep(GEN_BETA)
    cases = {
        "TemperingContainer (9a)": (
            tc, lambda p: checkpoint.save_tempering(p, tc),
            lambda p: checkpoint.load_tempering(p, device=tc.device),
            lambda c: c.timesteps_sample(CKPT_SWEEPS, chunk=CKPT_SWEEPS),
            lambda c: (*c.graph.sse.ops, c.graph.sse.state, c.betas, c.scales,
                       torch.tensor([c._parity, c.total_swaps]))),
        "QmcIsingGraph (phase 5)": (
            g, g.save, lambda p: QmcIsingGraph.load(p, device=g.device),
            lambda x: x.timesteps(CKPT_SWEEPS, 1.0), lambda x: (*x.sse.ops, x.sse.state)),
        "Qmc (into_qmc, loops)": (
            q, q.save, lambda p: Qmc.load(p, device=q.device),
            lambda x: x.timesteps(CKPT_SWEEPS, GEN_BETA),
            lambda x: (*x._ensure_sse().ops, x._ensure_sse().state)),
    }
    with tempfile.TemporaryDirectory() as tmp:
        for i, (name, (obj, save, load, run, parts)) in enumerate(cases.items()):
            path = str(Path(tmp) / f"ckpt{i}.npz")
            t0 = time.perf_counter()
            save(path)
            run(obj)
            resumed = load(path)
            run(resumed)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(parts(obj), parts(resumed))):
                raise AssertionError(f"9e: the resumed {name} differs from the original")
            print(f"9e {name}: saved, {CKPT_SWEEPS} sweeps, loaded, the same sweeps: op "
                  f"strings, states and labels equal ({time.perf_counter() - t0:.1f} s)",
                  flush=True)


def run_large_n(dev) -> dict:
    """Phase 9f: an SSE model past K2's shared variant's limit: the L x L
    benchmark lattice at L = ``BIG_L`` (N = 30,976), beta = ``BIG_BETA``,
    R = ``BIG_R``, ``BIG_STEPS`` timesteps with ``verify()`` after each;
    N * M stays below 2^30 (the leg sort key). Returns the launches, of
    which K2's must all be the wide variant's, and the kernel's row from
    :func:`check_recorded_parity`."""
    edges = lattice.bench_two_d_periodic(BIG_L)
    n = BIG_L * BIG_L
    if ops.parity_kernel.k2_variant(n) != "wide":
        raise AssertionError(f"N={n} does not take K2's wide variant")
    t0 = time.perf_counter()
    g = QmcIsingGraph(edges, 1.0, replicas=BIG_R, seed=17, device=dev)
    ops.reset_launch_counts()
    for _ in range(BIG_STEPS):
        g.timestep(BIG_BETA)
        if n * g.cutoff >= 2**30:
            raise AssertionError(f"9f: N * M = {n * g.cutoff} reached 2^30")
        if not g.verify():
            raise AssertionError("9f: verify() failed")
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    secs = time.perf_counter() - t0
    print(f"9f {BIG_L}x{BIG_L} benchmark lattice (N={n}), beta={BIG_BETA}, R={BIG_R}: "
          f"{BIG_STEPS} timesteps in {secs:.1f} s, verify() after each, cutoff {g.cutoff} "
          f"(N*M = {n * g.cutoff}, limit {2**30}), mean n "
          f"{float(g.get_n().float().mean()):.1f}; launches {counts}", flush=True)
    if counts["parity_bits"] or counts["parity_bits_global"] or counts["parity_bits_wide"] <= 0:
        raise AssertionError(f"9f: K2 did not run through its wide variant alone: {counts}")
    return counts, check_recorded_parity(g)


def check_recorded_parity(g: QmcIsingGraph) -> dict:
    """Phase 9f: K2 through ``parity_bits`` on the arguments of one real
    call, recorded from one more sweep of the grown 9f graph: the wide
    variant alone, equal to its plain version, and timed there (device ms
    by ``torch.profiler`` in turns with the global variant, this model's
    only path before; CUDA events for a call, the plain version, the byte
    bound): the numbers of its row in the ``kernels`` line."""
    recorded = []
    saved = sse_diagonal.parity_bits

    def recorder(*args):
        if not recorded:
            recorded.extend(a.clone() for a in args)
        return saved(*args)

    sse_diagonal.parity_bits = recorder
    try:
        g.sse, _, _, _ = multi_sweep(g.sse, BIG_BETA, g.model, 1, lambda: g.draws,
                                     cluster_caps=g._cluster_caps, **g._diag_args())
    finally:
        sse_diagonal.parity_bits = saved
    if not recorded:
        raise AssertionError("9f: no call of parity_bits recorded")
    ops.reset_launch_counts()
    got = ops.parity_bits(*recorded)
    torch.cuda.synchronize()
    counts = {name: ops.launch_counts()[name] for name in K2_ENTRIES}
    want = ops.parity_bits_plain(*recorded)
    torch.cuda.synchronize()
    if counts != {"parity_bits": 0, "parity_bits_wide": 1, "parity_bits_global": 0}:
        raise AssertionError(f"9f: the recorded call did not take K2's wide variant alone: "
                             f"{counts}")
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError("9f: parity_bits_wide differs from its plain version on the "
                             "recorded call")
    err = max(float((a.to(torch.int64) - b.to(torch.int64)).abs().max())
              for a, b in zip(got, want))
    times = in_turns({"parity_bits_global": lambda: ops.parity_bits_global(*recorded),
                      "parity_bits_wide": lambda: ops.parity_bits_wide(*recorded)}, 20)
    ms = float(np.mean(times["parity_bits_wide"]))
    call_ms = cuda_ms(lambda: ops.parity_bits_wide(*recorded), 20)
    plain_ms = cuda_ms(lambda: ops.parity_bits_plain(*recorded), 1)
    res = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           **bound(nbytes(*recorded, *got)), "library_ms": None}
    split = device_split(lambda: ops.parity_bits_wide(*recorded), 20, K2_WIDE_PASSES,
                         "the wide variant on the recorded 9f call")
    by_segments = wide_segment_counts(recorded, got)
    print(f"parity_bits on the recorded 9f call {[tuple(a.shape) for a in recorded]}: the "
          f"wide variant alone, equal to plain (max_abs_err {err}); device ms in turns "
          f"{json.dumps(times)} (the global variant's recorded row: 0.7556); the wide "
          f"{ms:.4f} ms ({call_ms:.4f} ms a call, CUDA events; by pass {json.dumps(split)}), "
          f"plain {plain_ms:.4f} ms, bound {res['bound_ms']:.4f} ms ({res['bound_by']}, "
          f"{nbytes(*recorded, *got) / 1e6:.2f} MB); device ms by segments a replica group "
          f"{json.dumps(by_segments)}", flush=True)
    return res


def wide_segment_counts(recorded: list, want: tuple) -> dict:
    """K2's wide variant on a recorded call at a quarter, a half, one and
    two waves of one-warp CTAs (segments a replica group; one wave is what
    ``wide_segment_length`` picks): device ms of each, whose outputs must
    equal ``want``. ``wide_segment_length`` is swapped for the calls and
    restored."""
    rule = ops.parity_kernel.wide_segment_length
    n_sms = _build.sm_count(recorded[0].device)
    groups = -(-recorded[1].shape[2] // 32)
    out = {}
    try:
        for nseg in sorted({max(1, f * n_sms // (4 * groups)) for f in (1, 2, 4, 8)}):
            ops.parity_kernel.wide_segment_length = (
                lambda M, R, n, k=nseg: 4 * -(-M // (4 * k)))
            got = ops.parity_bits_wide(*recorded)
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise AssertionError(f"9f: parity_bits_wide at {nseg} segments differs")
            out[nseg] = device_ms(lambda: ops.parity_bits_wide(*recorded), 10)
    finally:
        ops.parity_kernel.wide_segment_length = rule
    return out


# -- Phase 10: parallel tempering sharded over ranks ------------------------------------

# 10a: 9a's ladder (64 betas x 4 replicas, 32x32, Metropolis) over SH_WORLD
# gloo ranks sharing the card, 64 replicas a rank, with 9a's growth, warm-up
# and measured sweep+swap steps; then one fingerprinted chunk of SH_FP steps.
SH_WORLD, SH_FP, SH_TIMEOUT = 4, 4, 420.0
# The gathers of one 9a swap, timed alone SH_REPS times.
SH_REPS = 64
# 10b: sweep+swap steps of the sharded chunk against the unsharded one.
SH_EQUAL_T = 4


def sharded_ladder_rank(rank: int, world: int, device: str) -> dict:
    """Phase 10a (and 10c) on one rank: 9a's ladder sharded over the
    ``world`` ranks, grown and warm, then ``PT_SAMPLE`` measured sweep+swap
    steps in chunks of ``PT_CHUNK`` with the launches and the collectives'
    traffic counted, the gathers of one swap timed alone, and one chunk of
    ``SH_FP`` steps with its fingerprint. Raises where this rank's checks
    fail; returns what the ranks must agree on and what was measured."""
    dev = _dist.rank_device(device, rank, dist.get_backend())
    torch.cuda.set_device(dev)
    tc = TemperingContainer(lattice.bench_two_d_periodic(32), transverse=1.0,
                            betas=PT_BETAS, replicas_per_beta=PT_PER_BETA, seed=PT_SEED,
                            device=dev)
    tc.shard_over()
    g = tc.graph
    t0 = time.perf_counter()
    tc.timesteps(PT_GROW)
    tc.timesteps_sample(PT_WARM, chunk=PT_CHUNK)
    torch.cuda.synchronize()
    grow_s = time.perf_counter() - t0
    betas_before = tc._global(tc.betas)
    p0, swaps0 = tc._parity, tc.total_swaps
    ops.reset_launch_counts()
    _dist.reset_traffic()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    states, bet = tc.timesteps_sample(PT_SAMPLE, swap_freq=1, chunk=PT_CHUNK)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t1
    counts = ops.launch_counts()
    traffic = _dist.traffic()
    R, R_l = tc.replicas, g.replicas
    if tuple(states.shape) != (PT_SAMPLE, R, g.nvars) or not tc.verify():
        raise AssertionError(f"10a rank {rank}: samples {tuple(states.shape)} or verify()")
    if min(counts[k] for k in ("parity_bits", "carry_decisions", *SSE_K4)) <= 0:
        raise AssertionError(f"10a rank {rank} did not run through K2, K3 and K4: {counts}")
    want = sorted(np.repeat(PT_BETAS.astype(np.float32), PT_PER_BETA).tolist())
    if sorted(tc._global(tc.betas).tolist()) != want:
        raise AssertionError(f"10a rank {rank}: the gathered betas are not the ladder's")
    # Every measured step swaps; a swap of a beta ladder gathers n i32[R]
    # and betas f32[R], nothing else, and no tensor of the op string's size.
    swap = traffic.get("swap", {"calls": 0, "bytes": 0, "shapes": []})
    per_swap = 4 * R + 4 * R
    if (swap["calls"], swap["bytes"]) != (2 * PT_SAMPLE, per_swap * PT_SAMPLE) or \
            swap["shapes"] != [((R_l,), "float32"), ((R_l,), "int32")]:
        raise AssertionError(f"10a rank {rank}: swap traffic {swap}, want {2 * PT_SAMPLE} "
                             f"gathers of {per_swap * PT_SAMPLE} bytes of [{R_l}] vectors")
    crossed = [shape for t in traffic.values() for shape, _ in t["shapes"]]
    if any(g.cutoff in shape for shape in crossed):
        raise AssertionError(f"10a rank {rank}: a [M, R_l] tensor crossed ranks: {traffic}")
    n_l = op_count(g.sse.ops)
    _dist.all_reduce_max(torch.zeros(1, dtype=torch.int32, device=dev), tag="timing")
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    for _ in range(SH_REPS):
        _dist.all_gather(n_l, tag="timing")
        _dist.all_gather(tc.betas, tag="timing")
    torch.cuda.synchronize()
    coll_ms = 1e3 * (time.perf_counter() - t2) / SH_REPS
    host_ms = None
    if dist.get_backend() == "gloo":
        # The same gathers of host copies: what the card's part costs.
        n_h, b_h = n_l.cpu(), tc.betas.cpu()
        _dist.all_reduce_max(torch.zeros(1, dtype=torch.int32), tag="timing")
        t3 = time.perf_counter()
        for _ in range(SH_REPS):
            _dist.all_gather(n_h, tag="timing")
            _dist.all_gather(b_h, tag="timing")
        host_ms = 1e3 * (time.perf_counter() - t3) / SH_REPS
    out = tempering.tempering_sweep_chunk_sharded(
        g.sse, tc.betas, tc.scales, tc._parity, [True] * SH_FP, g.model, SH_FP,
        tc._draws, cluster_caps=g._cluster_caps, debug_rep_check=True)
    fp = out[-1]
    if not torch.equal(fp, fp[:1].expand_as(fp)):
        raise AssertionError(f"10a rank {rank}: the ranks' fingerprints differ: {fp}")
    g.sse, tc.betas = out[0], out[1]
    if not tc.verify():
        raise AssertionError(f"10a rank {rank}: verify() failed after the fingerprinted chunk")
    attempts = sum(1 for i in range(PT_SAMPLE) if (p0 + i) % 2 == 1)
    levels_t = np.stack([beta_levels(b, PT_BETAS) for b in bet])
    acc = pair_acceptance(beta_levels(betas_before, PT_BETAS), levels_t, attempts)
    return {"rank": rank, "device": str(dev), "world": world, "R_local": R_l,
            "cutoff": g.cutoff, "caps": g._cluster_caps, "grow_s": grow_s,
            "ms_per_sweep_swap": 1e3 * secs / PT_SAMPLE,
            "swaps_per_step": (tc.total_swaps - swaps0) / PT_SAMPLE,
            "swap_bytes_per_swap": swap["bytes"] / PT_SAMPLE, "swap_bytes_want": per_swap,
            "traffic": traffic, "collectives_ms_per_swap": coll_ms,
            "collectives_ms_per_swap_host_tensors": host_ms,
            "launches": counts, "fingerprint": fp.cpu(),
            "pair_acceptance_min_median_max": [float(acc.min()), float(np.median(acc)),
                                               float(acc.max())],
            "mean_n": float(tc._global(n_l.float(), tag="result").mean())}


def run_sharded_ladder(world: int, backend: str, label: str, card: str,
                       ms_9a: float) -> list:
    """Phases 10a and 10c: :func:`sharded_ladder_rank` on ``world`` ranks
    of ``backend``; every rank's checks pass, and the ranks agree on the
    cutoff, the caps and the fingerprint."""
    t0 = time.perf_counter()
    res = _dist.spawn(sharded_ladder_rank, world, backend, "cuda", timeout=SH_TIMEOUT)
    first = res[0]
    for r in res[1:]:
        if (r["cutoff"], r["caps"]) != (first["cutoff"], first["caps"]) or \
                not torch.equal(r["fingerprint"], first["fingerprint"]):
            raise AssertionError(f"{label}: ranks 0 and {r['rank']} disagree: "
                                 f"{(first['cutoff'], first['caps'])} vs "
                                 f"{(r['cutoff'], r['caps'])}")
    for r in res:
        print(f"{label} rank {r['rank']} on {r['device']}: R_l={r['R_local']}, cutoff "
              f"{r['cutoff']}, {r['ms_per_sweep_swap']:.3f} ms a sweep+swap (9a unsharded: "
              f"{ms_9a:.3f}), the gathers of one swap {r['collectives_ms_per_swap']:.4f} ms "
              f"({backend}), launches {r['launches']}", flush=True)
    summary = {"card": card, "backend": backend, "world": world,
               "R": len(PT_BETAS) * PT_PER_BETA,
               "cutoff": first["cutoff"], "caps": first["caps"],
               "grow_s": [r["grow_s"] for r in res],
               "ms_per_sweep_swap": [r["ms_per_sweep_swap"] for r in res],
               "ms_per_sweep_swap_9a_unsharded": ms_9a,
               "collectives_ms_per_swap": [r["collectives_ms_per_swap"] for r in res],
               "collectives_ms_per_swap_host_tensors":
                   [r["collectives_ms_per_swap_host_tensors"] for r in res],
               "swap_bytes_per_swap": first["swap_bytes_per_swap"],
               "swap_bytes_from_shapes": first["swap_bytes_want"],
               "traffic_rank0": {k: {"calls": v["calls"], "bytes": v["bytes"]}
                                 for k, v in first["traffic"].items()},
               "swaps_per_step": first["swaps_per_step"],
               "pair_acceptance_min_median_max": first["pair_acceptance_min_median_max"],
               "mean_n": first["mean_n"], "fingerprint": first["fingerprint"][0].tolist(),
               "wall_s": time.perf_counter() - t0}
    print(f"{label}: " + json.dumps(summary), flush=True)
    return res


# The replica axis of each output of a tempering chunk (None: replicated).
CHUNK_AXES = {"bond": 1, "inputs": 2, "outputs": 2, "state": 0, "betas": 0, "scales": 0,
              "xors": 0, "parity": None, "nswaps": None, "ns": 1, "states": 1, "betas_t": 1}


def chunk_parts(out) -> dict:
    """A tempering chunk's outputs by name, on the CPU."""
    sse, betas, scales, xors, _, parity, nswaps, ns, states, betas_t = out[:10]
    parts = dict(zip(("bond", "inputs", "outputs"), sse.ops), state=sse.state, betas=betas,
                 scales=scales, xors=xors, parity=parity, nswaps=nswaps, ns=ns,
                 states=states, betas_t=betas_t)
    return {k: None if v is None else v.cpu() for k, v in parts.items()}


def sharded_equal_rank(rank: int, world: int, path: str, seed: int) -> dict:
    """Phase 10b on one rank: the container of the checkpoint ``path``,
    sharded, runs ``SH_EQUAL_T`` sweep+swap steps of the sharded chunk
    cap-less on its block of one unsharded run's uniforms
    (:class:`~tempering.BlockDraws` on a generator seeded with ``seed``).
    Returns the rank's outputs on the CPU."""
    dev = _dist.rank_device("cuda", rank, dist.get_backend())
    torch.cuda.set_device(dev)
    tc = checkpoint.load_tempering(path, device=dev)
    tc.shard_over()
    g = tc.graph
    draws = tempering.BlockDraws(torch.Generator(device=dev).manual_seed(seed),
                                 rank * g.replicas, g.replicas, tc.replicas)
    return chunk_parts(tempering.tempering_sweep_chunk_sharded(
        g.sse, tc.betas, tc.scales, tc._parity, [True] * SH_EQUAL_T, g.model, SH_EQUAL_T,
        lambda: draws, hetero=tc.hetero, collect_states=True, xors=tc.xors))


def check_sharded_equal(ladders: dict) -> None:
    """Phase 10b: for each grown container of ``ladders`` (9a's beta
    ladder, 9c's signed ladder; h = 0), the sharded chunk on ``SH_WORLD``
    gloo ranks and the unsharded chunk on the same uniforms, cap-less
    (every replica labels at full size, so the cluster shapes agree): op
    strings, states, labels, parity, swap count and samples
    ``torch.equal``."""
    import tempfile
    from pathlib import Path

    with tempfile.TemporaryDirectory() as tmp:
        for i, (label, tc) in enumerate(ladders.items()):
            t0 = time.perf_counter()
            path = str(Path(tmp) / f"ladder{i}.npz")
            checkpoint.save_tempering(path, tc)
            seed = 900 + i
            outs = _dist.spawn(sharded_equal_rank, SH_WORLD, "gloo", path, seed,
                               timeout=SH_TIMEOUT)
            g = tc.graph
            gen = torch.Generator(device=tc.device).manual_seed(seed)
            want = chunk_parts(tempering.tempering_sweep_chunk(
                g.sse, tc.betas, tc.scales, tc._parity, [True] * SH_EQUAL_T, g.model,
                SH_EQUAL_T, lambda: sse_ising.GeneratorDraws(gen), hetero=tc.hetero,
                collect_states=True, xors=tc.xors))
            for name, axis in CHUNK_AXES.items():
                if want[name] is None:
                    same = all(o[name] is None for o in outs)
                elif axis is None:
                    same = all(torch.equal(o[name], want[name]) for o in outs)
                else:
                    same = torch.equal(torch.cat([o[name] for o in outs], dim=axis),
                                       want[name])
                if not same:
                    raise AssertionError(f"10b {label}: the sharded chunk's {name} differs "
                                         f"from the unsharded chunk's")
            print(f"10b {label}: {SH_EQUAL_T} sweep+swap steps on {SH_WORLD} gloo ranks "
                  f"torch.equal to the unsharded chunk (op strings, states, labels, parity, "
                  f"{int(want['nswaps'])} swaps, samples) in {time.perf_counter() - t0:.1f} s",
                  flush=True)


def check_dryrun_sharded(world: int) -> None:
    """Phase 10d: ``tempering.dryrun_sharded`` on ``world`` gloo ranks of the
    card (a heterogeneous heat-bath ladder, per-replica tables, sharded; one
    chunk of two sweep+swap steps; one RVB sweep at the swapped labels).
    Every rank verifies, the ranks agree on the gathered op counts, betas
    and swap count, the betas are the ladder's, each rank launched K2,
    K3-hb and K4, and each swap gathered the per-replica heat-bath rows and
    bond counts beside ``n``, ``betas`` and the scales."""
    t0 = time.perf_counter()
    res = tempering.dryrun_sharded(world, "gloo", "cuda", timeout=SH_TIMEOUT)
    first = res[0]
    want = np.linspace(0.5, 2.0, 2 * world).astype(np.float32).tolist()
    if sorted(first["betas"]) != want:
        raise AssertionError(f"10d: the gathered betas {first['betas']} are not the ladder's")
    for r in res:
        if not r["verify"] or r["device"] != f"cuda:{r['rank'] % torch.cuda.device_count()}":
            raise AssertionError(f"10d rank {r['rank']} on {r['device']}: verify() "
                                 f"{r['verify']}")
        if (r["n"], r["betas"], r["swaps"]) != (first["n"], first["betas"], first["swaps"]):
            raise AssertionError(f"10d: ranks 0 and {r['rank']} disagree")
        counts = r["launches"]
        if min(counts[k] for k in ("parity_bits", "carry_decisions_heatbath", *SSE_K4)) <= 0:
            raise AssertionError(f"10d rank {r['rank']} did not run through K2, K3-hb and "
                                 f"K4: {counts}")
        # Each of the two swaps gathers n, betas, the scales, the bond
        # counts and the heat-bath rows and totals of the rank's R_l
        # replicas: the 4x4 lattice's 32 edges and 16 transverse bonds.
        swap, R_l, nb = r["traffic"]["swap"], first["replicas"] // world, 48
        want_shapes = [((R_l,), "float32"), ((R_l,), "int32"), ((R_l, nb), "float32"),
                       ((R_l, nb), "int32")]
        if swap["calls"] != 2 * 6 or swap["shapes"] != want_shapes:
            raise AssertionError(f"10d rank {r['rank']}: a heat-bath ladder's swaps gathered "
                                 f"{swap}, want 12 gathers of {want_shapes}")
    print(f"10d: dryrun_sharded on {world} gloo ranks: R={first['replicas']}, "
          f"{first['swaps']} swaps, n {first['n']}, swap traffic of rank 0 "
          f"{first['traffic']['swap']}, launches of rank 0 {first['launches']}, in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this check needs a CUDA GPU")
    dev = torch.device("cuda", 0)

    phase("1. host")
    card = run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    print(run([_build.nvcc_path(), "--version"]).splitlines()[-1], flush=True)

    phase("2. build")
    t0 = time.perf_counter()
    _build.library()
    print(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s: "
          f"{_build.library_path().name}")
    log = _build.library_path().with_suffix(".log")
    if log.exists():
        print("\n".join(l for l in log.read_text().splitlines()
                        if "registers" in l or "Compiling entry" in l))

    phase("3. kernels against their plain versions")
    kernel_results, carry_bounds = check_kernels(dev)
    k2_global_launches = kernel_results["parity_bits_global"].pop("dispatch_launches")

    phase("4. physics: 8-site chain against ED")
    check_physics(dev)

    phase("5. SSE main path: 32x32 benchmark lattice")
    ops.reset_launch_counts()
    met, ns_met, g_met = run_slice(dev)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    print(f"kernel launches in the SSE main path: {counts}", flush=True)
    sse_kernels = ("parity_bits", "carry_decisions", *SSE_K4)
    if min(counts[k] for k in sse_kernels) <= 0:
        raise AssertionError(f"a kernel of the SSE path was not launched: {counts}")
    launches = {k: counts[k] for k in sse_kernels}
    check_grown_labels(g_met)

    phase("5b. SSE heat-bath path: 32x32 benchmark lattice")
    ops.reset_launch_counts()
    hb, ns_hb, g_hb = run_slice(dev, heatbath=True, cutoff=6944)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    print(f"kernel launches in the SSE heat-bath path: {counts}", flush=True)
    hb_kernels = ("parity_bits", "carry_decisions_heatbath", *SSE_K4)
    if min(counts[k] for k in hb_kernels) <= 0 or counts["carry_decisions"] != 0:
        raise AssertionError(f"the heat-bath path did not run through K2, K3-hb and K4 "
                             f"alone: {counts}")
    launches["carry_decisions_heatbath"] = counts["carry_decisions_heatbath"]
    check_heatbath_agrees(met, ns_met, hb, ns_hb)
    check_physics(dev, heatbath=True)
    check_recorded_carry(g_met, g_hb, carry_bounds)
    time_in_turns(g_met, g_hb)
    profile_sweeps(g_met, "32x32 Metropolis")
    profile_sweeps(g_hb, "32x32 heat-bath")

    phase("6. classical main path: 256^2 lattice")
    ops.reset_launch_counts()
    run_classical(dev)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    print(f"kernel launches in the classical main path: {counts}", flush=True)
    if counts["checkerboard_multi_sweep"] <= 0:
        raise AssertionError(f"K1 was not launched by the classical path: {counts}")
    launches["checkerboard_multi_sweep"] = counts["checkerboard_multi_sweep"]

    phase(f"6b. classical path past shared memory: {L_HUGE}^2, {L_PAST}^2 and {L_FSS}^2 "
          f"lattices")
    ops.reset_launch_counts()
    run_classical_global(dev)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    print(f"kernel launches in the {L_HUGE}^2, {L_PAST}^2 and {L_FSS}^2 classical paths: "
          f"{counts}", flush=True)
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    tiled = sum(len(cb.k1_tile_plan(R_PAST, L, SWEEPS_PAST, n_sms)["launches"])
                for L in (L_PAST, L_FSS))
    if (counts["checkerboard_multi_sweep_bands"] <= 0 or counts["checkerboard_multi_sweep"]
            or counts["checkerboard_multi_sweep_tiles"] != tiled
            or counts["checkerboard_multi_sweep_global"]):
        raise AssertionError(f"the {L_HUGE}^2 lattice did not run through K1's banded variant, "
                             f"or the {L_PAST}^2 and {L_FSS}^2 ones not through its tiled "
                             f"variant alone ({tiled} launches): {counts}")
    for name in ("checkerboard_multi_sweep_bands", "checkerboard_multi_sweep_tiles"):
        launches[name] = counts[name]
    # Dispatch no longer reaches the global-memory variant: no main path
    # launches it (phase 3 times it in turns with the tiled one).
    launches["checkerboard_multi_sweep_global"] = counts["checkerboard_multi_sweep_global"]

    phase("7. RVB path: two_d_rvb_16 (16x16 benchmark lattice, beta=10, R=16, U=128)")
    _, counts = run_rvb(dev)
    print(f"kernel launches in the measured RVB timesteps: {counts}", flush=True)
    if min(counts[k] for k in sse_kernels) <= 0:
        raise AssertionError(f"a kernel of the RVB path was not launched: {counts}")
    check_rvb_physics(dev)

    phase("8a. generic engine: phase 5's 32x32 graph through into_qmc, with loops")
    run_generic_tfim(g_met, ns_met, card)
    phase("8b. generic engine: the XXZ exchange on the 32x32 lattice, loops only")
    run_generic_xxz(dev, card)
    phase("8c. generic engine: XXZ chains and a 3-spin model against ED")
    check_generic_physics(dev)

    phase("9a. tempering: 64-beta ladder x 4 replicas on the 32x32 lattice, Metropolis")
    tc_a, out_a, counts = run_tempering_homogeneous(dev, card)
    phase("9b. tempering: 64-rung transverse ladder x 4 replicas, heat-bath")
    run_tempering_hetero(dev, card)
    phase("9c. tempering: signed ladder, two 128-replica graphs on the 32x32 lattice")
    tc_c, _, _ = run_tempering_signed(dev, card, counts["take0"] / PT_SAMPLE)
    phase("9d. tempering physics: 4-site heat-bath and signed ladders against ED")
    check_tempering_physics(dev)
    phase("9e. checkpoints: save, run, load, run again")
    check_checkpoints(tc_a, g_met)
    phase(f"9f. K2's wide variant on a model: {BIG_L}x{BIG_L} benchmark lattice")
    counts, kernel_results["parity_bits_wide"] = run_large_n(dev)
    launches["parity_bits_wide"] = counts["parity_bits_wide"]
    # No SSE model reaches K2's global variant (N > 53,472; the int32 leg key
    # needs N < 32,768): its launches are phase 3's, through parity_bits.
    launches["parity_bits_global"] = k2_global_launches

    phase(f"10a. sharded tempering: 9a's ladder over {SH_WORLD} gloo ranks on one card")
    run_sharded_ladder(SH_WORLD, "gloo", "10a", card, out_a["ms_per_sweep_swap"])
    phase(f"10b. sharded chunk against the unsharded one on the same uniforms, "
          f"{SH_WORLD} gloo ranks")
    check_sharded_equal({"9a beta ladder": tc_a, "9c signed ladder": tc_c})
    cards = torch.cuda.device_count()
    phase(f"10c. sharded tempering through NCCL: one rank a card, {min(cards, 4)} "
          f"rank(s)")
    run_sharded_ladder(1, "nccl", "10c world size 1", card, out_a["ms_per_sweep_swap"])
    if cards >= 2:
        run_sharded_ladder(min(cards, 4), "nccl", f"10c world size {min(cards, 4)}", card,
                           out_a["ms_per_sweep_swap"])
    else:
        print("10c: this host has one card: NCCL ran at world size 1 only, not across cards",
              flush=True)
    phase(f"10d. dryrun_sharded: a heterogeneous heat-bath ladder over {SH_WORLD} gloo "
          f"ranks, then an RVB sweep")
    check_dryrun_sharded(SH_WORLD)

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], **kernel_results[name]}
        for name, (src, rep) in KERNEL_INFO.items()
    ]}))
    print(f"all phases done in {time.perf_counter() - T_START:.1f} s", flush=True)
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
