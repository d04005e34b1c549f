#!/usr/bin/env python3
"""Time K1's tiled variant at forced tile shapes on one CUDA GPU and fit the
cost model of ``ops.checkerboard.k1_tile_plan`` to the times.

    python3 scripts/k1_tile_sweep.py [CHECKOUT]

imports ``isingmontecarlo_tpu_torch`` from CHECKOUT (default: this
checkout; its kernels build there at first use). For each (L, R, sweeps)
of ``FIELDS`` and each (k, ty, tx) of ``SHAPES`` that fits, it times
``checkerboard_multi_sweep_tiles`` on random spins (device ms a call under
``torch.profiler``, after a warm-up), checks the result ``torch.equal`` to
the plain version on one shape a field, and prints a line a shape with the
plan's CTAs, CTAs an SM, threads, launches and modelled ms. Then it fits

    ms = sum over launches of (ceil(CTAs / SMs) * loaded sites
                               * (sweeps * c_site + c_load) + c_launch)

by least squares, prints ``c_site``, ``c_load`` and ``c_launch`` (seconds
an attempt on one SM, seconds a loaded site a launch on one SM, seconds a
launch) and each shape's fitted ms, and prints as its last line one JSON
object of the fit and every reading, with the card's name and power
limit. The default plan's own time is printed for each field too.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

CHECKOUT = Path(sys.argv[1]).resolve() if len(sys.argv) > 1 else Path(__file__).resolve().parents[1]
sys.path.insert(0, str(CHECKOUT))

from isingmontecarlo_tpu_torch import ops  # noqa: E402
from isingmontecarlo_tpu_torch.ops import checkerboard as cb  # noqa: E402

# (L, R, sweeps): phase 6b's call and the 8192^2 finite-size-scaling run.
FIELDS = ((6000, 1, 2), (8192, 1, 100))
# (k, ty, tx): one and two CTAs an SM, k from 1 to 8.
SHAPES = ((1, 300, 504), (2, 100, 1000), (2, 182, 504), (2, 200, 512), (2, 400, 496),
          (2, 400, 512), (4, 160, 504), (4, 192, 512), (4, 400, 456), (8, 300, 512),
          (8, 360, 456), (4, 216, 904), (2, 420, 480))


def device_ms(fn, reps: int) -> float:
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    total = sum(e.self_device_time_total for e in rows)
    if total <= 0:
        raise AssertionError("the profile holds no device time")
    return total / 1e3 / reps


def features(plan: dict, n_sms: int) -> tuple[float, float, float]:
    """The model's three terms for ``plan``: CTA-sites a launch's busiest SM
    updates (summed over launches and times their sweeps), CTA-sites it
    loads (summed over launches), launches."""
    sites = (plan["ty"] + 2 * plan["halo_rows"]) * (plan["tx"] + 2 * plan["halo_cols"])
    per_sm = -(-plan["ctas"] // n_sms) * sites
    return (sum(per_sm * n for _, n in plan["launches"]), per_sm * len(plan["launches"]),
            float(len(plan["launches"])))


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("k1_tile_sweep: needs a CUDA GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows, X, y = [], [], []
    for L, R, nsweeps in FIELDS:
        spins = torch.rand((R, L, L), device=dev) < 0.5
        args = (1, 0.4, -1.0, 0.1, nsweeps)
        reps = 10 if nsweeps < 10 else 2
        want = ops.checkerboard_multi_sweep_plain(spins, *args) if nsweeps < 10 else None
        plan = cb.k1_tile_plan(R, L, nsweeps, n_sms)
        ms = device_ms(lambda: ops.checkerboard_multi_sweep_tiles(spins, *args), reps)
        print(f"L={L} R={R} sweeps={nsweeps}: default plan k={plan['k']} {plan['ty']} x "
              f"{plan['tx']}: {ms:.4f} ms (modelled {plan['seconds'] * 1e3:.4f})", flush=True)
        rows.append({"L": L, "R": R, "sweeps": nsweeps, "shape": "default", "k": plan["k"],
                     "ty": plan["ty"], "tx": plan["tx"], "ms": ms})
        X.append(features(plan, n_sms))
        y.append(ms * 1e-3)
        for k, ty, tx in SHAPES:
            try:
                plan = cb.k1_tile_plan(R, L, nsweeps, n_sms, k=k, ty=ty, tx=tx)
            except ValueError:
                continue
            fn = lambda: ops.checkerboard_multi_sweep_tiles(spins, *args, k=k, ty=ty, tx=tx)
            if want is not None:
                if not torch.equal(fn(), want):
                    raise AssertionError(f"L={L}: k={k} {ty} x {tx} differs from plain")
                want = None
            ms = device_ms(fn, reps)
            rows.append({"L": L, "R": R, "sweeps": nsweeps, "k": k, "ty": ty, "tx": tx,
                         "ctas": plan["ctas"], "ctas_per_sm": plan["ctas_per_sm"],
                         "threads": plan["threads"], "launches": len(plan["launches"]),
                         "ms": ms, "modelled_ms": plan["seconds"] * 1e3})
            X.append(features(plan, n_sms))
            y.append(ms * 1e-3)
            print(json.dumps(rows[-1]), flush=True)
    coef, *_ = np.linalg.lstsq(np.array(X), np.array(y), rcond=None)
    fit = dict(zip(("c_site", "c_load", "c_launch"), (float(c) for c in coef)))
    print(f"fit: c_site {fit['c_site']:.4e} s an attempt on one SM, c_load "
          f"{fit['c_load']:.4e} s a loaded site a launch, c_launch {fit['c_launch']:.4e} s",
          flush=True)
    for row, x in zip(rows, X):
        row["fitted_ms"] = float(np.dot(coef, x)) * 1e3
        print(f"  L={row['L']} k={row['k']} {row['ty']} x {row['tx']}: {row['ms']:.4f} ms, "
              f"fitted {row['fitted_ms']:.4f}", flush=True)
    print(json.dumps({"card": card, "fit": fit, "readings": rows}))


if __name__ == "__main__":
    main()
