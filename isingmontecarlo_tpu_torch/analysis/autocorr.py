"""Integrated autocorrelation time and effective sample size (numpy; port of
``isingmontecarlo_tpu/analysis/autocorr.py:69-105``). Series may be numpy
arrays or tensors on any device."""

from __future__ import annotations

import numpy as np
import torch


def _as_numpy(series) -> np.ndarray:
    if isinstance(series, torch.Tensor):
        series = series.detach().cpu().numpy()
    return np.asarray(series, np.float64)


def integrated_autocorrelation_time(series, c: float = 5.0) -> float:
    """Integrated autocorrelation time ``tau`` of a scalar series ``[T]``
    (or ``[T, R]``, averaged over replicas) with Sokal's adaptive window:
    ``tau = 1 + 2 sum_{t<=W} rho(t)`` for the smallest ``W >= c*tau``."""
    x = _as_numpy(series)
    if x.ndim == 1:
        x = x[:, None]
    T = x.shape[0]
    x = x - x.mean(axis=0, keepdims=True)
    # FFT autocorrelation per replica, averaged.
    n = 1 << (2 * T - 1).bit_length()
    f = np.fft.rfft(x, n=n, axis=0)
    acf = np.fft.irfft(np.abs(f) ** 2, n=n, axis=0)[:T].real
    acf /= np.maximum(acf[0], 1e-300)
    rho = acf.mean(axis=1)
    tau = 1.0
    for W in range(1, T):
        tau = 1.0 + 2.0 * rho[1 : W + 1].sum()
        if W >= c * tau:
            break
    return float(max(tau, 1.0))


def effective_sample_size(series) -> float:
    """ESS of a scalar series ``[T]`` or ``[T, R]``: total samples divided
    by the integrated autocorrelation time (replica chains are independent,
    so ESS adds across the replica axis)."""
    x = _as_numpy(series)
    T = x.shape[0]
    R = 1 if x.ndim == 1 else int(np.prod(x.shape[1:]))
    return T * R / integrated_autocorrelation_time(x)
