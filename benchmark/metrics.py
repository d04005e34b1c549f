"""The yardstick's arithmetic: statistics, interval merges, the card's peaks
and the kernels' byte counts. Copies, not imports, of the program's own
arithmetic where it had some, so that a change to the program cannot move
the yardstick.

- :func:`effective_sample_size` and :func:`integrated_autocorrelation_time`
  copy ``isingmontecarlo_tpu_torch/analysis/autocorr.py`` (Sokal's adaptive
  window, replica chains independent).
- The byte counts copy how ``chip_smoke.py`` counts a kernel's bytes for its
  bound (every argument and every result once, from their shapes).
"""

from __future__ import annotations

import math
from typing import Iterable, Sequence

import numpy as np

# One NVIDIA H100 SXM (data sheet, at its 700 W power limit).
HBM_BYTES_PER_S = 3.35e12


def integrated_autocorrelation_time(series, c: float = 5.0) -> float:
    """Integrated autocorrelation time of a series ``[T]`` or ``[T, R]``
    (averaged over replicas): ``tau = 1 + 2 sum_{t<=W} rho(t)`` for the
    smallest window ``W >= c * tau``."""
    x = np.asarray(series, np.float64)
    if x.ndim == 1:
        x = x[:, None]
    T = x.shape[0]
    x = x - x.mean(axis=0, keepdims=True)
    n = 1 << (2 * T - 1).bit_length()
    f = np.fft.rfft(x, n=n, axis=0)
    acf = np.fft.irfft(np.abs(f) ** 2, n=n, axis=0)[:T].real
    acf /= np.maximum(acf[0], 1e-300)
    rho = acf.mean(axis=1)
    tau = 1.0
    for W in range(1, T):
        tau = 1.0 + 2.0 * rho[1:W + 1].sum()
        if W >= c * tau:
            break
    return float(max(tau, 1.0))


def effective_sample_size(series) -> float:
    """Samples over the integrated autocorrelation time, summed over the
    independent replica chains of a ``[T, R]`` series."""
    x = np.asarray(series, np.float64)
    R = 1 if x.ndim == 1 else int(np.prod(x.shape[1:]))
    return x.shape[0] * R / integrated_autocorrelation_time(x)


def percentile(values: Sequence[float], q: float) -> float:
    """The ``q``-th percentile (0-100) by linear interpolation between the
    order statistics, as numpy's default."""
    v = sorted(float(x) for x in values)
    if not v:
        raise ValueError("no values")
    pos = (len(v) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def merged_length(intervals: Iterable[tuple[float, float]]) -> float:
    """The length of the union of ``(start, end)`` intervals."""
    total = 0.0
    cur_s = cur_e = None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        elif e > cur_e:
            cur_e = e
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals: Iterable[tuple[float, float]]) -> list[tuple[float, float]]:
    """The ``(start, end)`` gaps between the union's pieces, in order."""
    out = []
    cur_e = None
    for s, e in sorted(intervals):
        if cur_e is not None and s > cur_e:
            out.append((cur_e, s))
        cur_e = e if cur_e is None else max(cur_e, e)
    return out


def carry_decisions_bytes(M: int, R: int) -> int:
    """K3 (``carry_decisions``): ``n0 i32[R]``; ``u0, num_ins, num_rem
    f32[M, R]``, ``idp, dgp bool[M, R]`` read; ``insert, remove bool[M, R]``
    written."""
    return 4 * R + (4 + 4 + 4 + 1 + 1) * M * R + 2 * M * R


def hook_min_bytes(C: int, E: int, R: int) -> int:
    """K4's ``hook_min`` on a label space of ``C`` rows and ``E`` edges:
    ``P i32[C, R]``, ``u, v i32[E, R]`` read, ``Pn i32[C, R]`` written."""
    return 4 * R * (2 * C + 2 * E)


def roofline_share(nbytes: float, seconds: float) -> float:
    """Percent of the card's HBM bandwidth bound that a call of ``seconds``
    moving ``nbytes`` reaches."""
    return 100.0 * (nbytes / HBM_BYTES_PER_S) / seconds
