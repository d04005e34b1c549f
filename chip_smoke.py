#!/usr/bin/env python3
"""Drive the PyTorch port's SSE timestep on one CUDA GPU and check it.

    python3 chip_smoke.py        # from the repository root, on a CUDA host

Phases, in order; any failed check raises, so the exit code is nonzero:

1. Host facts: the card's name and power limit (nvidia-smi), CUDA, nvcc.
2. Build the kernels from ``isingmontecarlo_tpu_torch/csrc``.
3. Each kernel against its plain PyTorch version on the card, at a small
   ragged shape and at the shapes of the 32x32 benchmark slice: equal
   (``torch.equal``), with both times at the latter.
4. Physics: ``QmcIsingGraph`` on an 8-site TFIM chain against exact
   diagonalization, and ``verify()``.
5. The main path: ``QmcIsingGraph`` on the 32x32 benchmark lattice at R=256,
   grown to steady state, then 16-step chunks; every kernel must have been
   launched by this run.

Then one JSON line of per-kernel results, and last a JSON line with the
device. The script needs no network and imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from isingmontecarlo_tpu_torch import lattice, ops
from isingmontecarlo_tpu_torch.analysis import effective_sample_size
from isingmontecarlo_tpu_torch.ops import _build
from isingmontecarlo_tpu_torch.sse import QmcIsingGraph, multi_sweep

# Kernel shapes of the 32x32 slice at R=256: M ~ 7000 slots, N = 1024 spins,
# label tables of C ~ 8000 rows gathered at E ~ 7000 indices.
K, M, R, N = 2, 7000, 256, 1024
C_TAKE, E_TAKE = 8000, 7000

KERNEL_INFO = {
    "parity_bits": ("isingmontecarlo_tpu_torch/csrc/parity_bits.cu",
                    "isingmontecarlo_tpu/ops/parity_kernel.py:95"),
    "carry_decisions": ("isingmontecarlo_tpu_torch/csrc/carry_metropolis.cu",
                        "isingmontecarlo_tpu/ops/diag_carry.py:95"),
    "take0": ("isingmontecarlo_tpu_torch/csrc/take0.cu",
              "isingmontecarlo_tpu/ops/take_kernel.py:84"),
}


def phase(title: str) -> None:
    print(f"\n== {title}", flush=True)


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


def exact_tfim_energy(edges, gamma: float, beta: float, nvars: int) -> float:
    """<H> of ``sum J sz sz - gamma sum sx`` at ``beta`` by dense ED."""
    dim = 1 << nvars
    idx = np.arange(dim)
    sz = np.where((idx[:, None] >> np.arange(nvars)) & 1, 1.0, -1.0)
    H = np.diag(sum(j * sz[:, a] * sz[:, b] for (a, b), j in edges))
    for v in range(nvars):
        H[idx ^ (1 << v), idx] -= gamma
    w = np.linalg.eigvalsh(H)
    z = np.exp(-beta * (w - w.min()))
    return float((w * z).sum() / z.sum())


def kernel_inputs(rng, dev, K, M, R, N, C, E) -> dict:
    """Random arguments of each kernel at one shape, with sentinel legs."""

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    v0 = rng.integers(0, N, size=(M, R))
    v_idx = np.stack([v0, (v0 + 1 + rng.integers(0, N - 1, size=(M, R))) % N])
    v_idx[rng.random((K, M, R)) < 0.1] = N
    vq = rng.integers(0, N, size=(K, M, R))
    vq[rng.random((K, M, R)) < 0.1] = N
    idp = rng.random((M, R)) < 0.4
    return {
        "parity_bits": (t(rng.random((R, N)) < 0.5), t(v_idx.astype(np.int32)),
                        t(rng.random((K, M, R)) < 0.3), t(vq.astype(np.int32))),
        "carry_decisions": (
            t(rng.integers(M // 2, 2 * M // 3, size=R).astype(np.int32)),
            t(rng.random((M, R), dtype=np.float32)), t(idp),
            t(~idp & (rng.random((M, R)) < 0.9)),
            t(rng.uniform(0, 0.6 * M, (M, R)).astype(np.float32)),
            t(rng.uniform(0, 1.2 * M, (M, R)).astype(np.float32)),
        ),
        "take0": (t(rng.integers(0, C, size=(C, R)).astype(np.int32)),
                  t(rng.integers(0, C, size=(E, R)).astype(np.int32))),
    }


def check_kernels(dev) -> dict:
    """Phase 3: every kernel equals its plain version on the card, at a
    small ragged shape and at the main-path shape, where both are timed."""
    rng = np.random.default_rng(0)
    wrappers = {
        "parity_bits": (ops.parity_bits, ops.parity_bits_plain, 20, 3),
        "carry_decisions": (ops.carry_decisions, ops.carry_decisions_plain, 20, 2),
        "take0": (ops.take0, ops.take0_plain, 200, 50),
    }
    ragged = kernel_inputs(rng, dev, K, 37, 5, 9, 7, 5)
    full = kernel_inputs(rng, dev, K, M, R, N, C_TAKE, E_TAKE)
    results = {}
    for name, (kernel, plain, reps, plain_reps) in wrappers.items():
        for args in (ragged[name], full[name]):
            got = kernel(*args)
            want = plain(*args)
            torch.cuda.synchronize()
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            for g, w in zip(got, want):
                if not torch.equal(g, w):
                    raise AssertionError(f"{name}: kernel differs from its plain "
                                         f"version at {[tuple(a.shape) for a in args]}")
        err = max(float((g.to(torch.int64) - w.to(torch.int64)).abs().max())
                  for g, w in zip(got, want))
        ms = cuda_ms(lambda: kernel(*args), reps)
        plain_ms = cuda_ms(lambda: plain(*args), plain_reps)
        shapes = [tuple(a.shape) for a in args]
        print(f"{name}: equal to plain (max_abs_err {err}); kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms; input shapes {shapes}", flush=True)
        results[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
    return results


def check_physics(dev) -> None:
    """Phase 4: energy of an 8-site TFIM chain against ED."""
    edges = lattice.chain(8)
    beta, gamma = 1.0, 1.0
    g = QmcIsingGraph(edges, gamma, replicas=1024, seed=11, device=dev)
    g.timesteps(100, beta)
    e = g.timesteps(400, beta).cpu().numpy()
    exact = exact_tfim_energy(edges, gamma, beta, 8)
    se = e.std() / np.sqrt(len(e))
    print(f"8-site chain, beta={beta}, Gamma={gamma}, R=1024: E = {e.mean():.5f} "
          f"+- {se:.5f} (ED {exact:.5f}, {abs(e.mean() - exact) / se:.2f} SE), "
          f"cutoff {g.cutoff}", flush=True)
    if not np.all(np.isfinite(e)) or abs(e.mean() - exact) >= 5 * se:
        raise AssertionError("chain energy is not within 5 standard errors of ED")
    if not g.verify():
        raise AssertionError("verify() failed on the 8-site chain")


def run_slice(dev) -> dict:
    """Phase 5: the main path at full size, through the kernels."""
    beta, chunk, nchunks = 1.0, 16, 4
    t0 = time.perf_counter()
    g = QmcIsingGraph(lattice.bench_two_d_periodic(32), 1.0, cutoff=6500,
                      replicas=R, seed=7, device=dev)
    g.timesteps(48, beta)  # single steps until the cutoff is stable, then chunks
    torch.cuda.synchronize()
    print(f"32x32: grown and equilibrated in {time.perf_counter() - t0:.1f} s, "
          f"cutoff {g.cutoff}, caps {g._cluster_caps}", flush=True)
    series, secs = [], 0.0
    for _ in range(nchunks):
        t1 = time.perf_counter()
        g.sse, ns, _ = multi_sweep(g.sse, beta, g.model, chunk, lambda: g.draws,
                                   cluster_caps=g._cluster_caps, cluster_every=1)
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
    print("32x32 slice, Gamma=1, beta=1, R=256, cluster_every=1: "
          + json.dumps(out), flush=True)
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this check needs a CUDA GPU")
    dev = torch.device("cuda", 0)

    phase("1. host")
    print(run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]))
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    print(run([_build.nvcc_path(), "--version"]).splitlines()[-1], flush=True)

    phase("2. build")
    t0 = time.perf_counter()
    _build.library()
    print(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s: "
          f"{_build.library_path().name}")
    log = _build.library_path().with_suffix(".log")
    if log.exists():
        print("\n".join(l for l in log.read_text().splitlines() if "registers" in l))

    phase("3. kernels against their plain versions")
    kernel_results = check_kernels(dev)

    phase("4. physics: 8-site chain against ED")
    check_physics(dev)

    phase("5. main path: 32x32 benchmark lattice")
    ops.reset_launch_counts()
    run_slice(dev)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    print(f"kernel launches in the main path: {counts}", flush=True)
    if min(counts.values()) <= 0:
        raise AssertionError(f"a kernel of the path was not launched: {counts}")

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": counts[name], **kernel_results[name]}
        for name, (src, rep) in KERNEL_INFO.items()
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
