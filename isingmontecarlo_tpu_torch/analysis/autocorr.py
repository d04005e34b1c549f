"""Autocorrelations (port of ``isingmontecarlo_tpu/analysis/autocorr.py``;
reference ``src/sse/autocorrelations.rs``).

The FFT autocorrelations run with ``torch.fft`` on the samples' device:
per variable, subtract the time mean, normalize by the L2 norm, FFT along
time, take ``|.|^2``, inverse FFT, then average over every trailing axis
(replicas and variables). The integrated autocorrelation time and the
effective sample size are numpy, on series given as numpy arrays or tensors
on any device.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch


def fft_autocorrelation(samples) -> torch.Tensor:
    """Autocorrelation ``f32[T]`` of samples ``[T, ..., V]`` along axis 0:
    the mean over all trailing axes of the normalized autocorrelation
    function (``autocorrelations.rs:99-133``)."""
    x = torch.as_tensor(samples).to(torch.float32)
    x = x - x.mean(dim=0, keepdim=True)
    norm = torch.sqrt((x * x).sum(dim=0, keepdim=True))
    x = x / torch.where(norm > 0, norm, torch.ones_like(norm))
    f = torch.fft.fft(x, dim=0)
    ac = torch.fft.ifft(f.abs() ** 2, dim=0).real
    return ac.mean(dim=tuple(range(1, ac.dim()))) if ac.dim() > 1 else ac


def sample_autocorrelation(states, sample_mapper: Callable) -> torch.Tensor:
    """``calculate_autocorrelation`` (``autocorrelations.rs:8-35``): map the
    sampled states ``bool[T, R, N]`` through ``sample_mapper``, then
    autocorrelate."""
    return fft_autocorrelation(sample_mapper(torch.as_tensor(states)))


def _pm1(states) -> torch.Tensor:
    return 2.0 * torch.as_tensor(states).to(torch.float32) - 1.0


def spin_autocorrelation(states) -> torch.Tensor:
    """Autocorrelation of the spins as ±1 (``autocorrelations.rs:38-50``)."""
    return fft_autocorrelation(_pm1(states))


def product_autocorrelation(states, var_products: Sequence[Sequence[int]]) -> torch.Tensor:
    """Autocorrelation of products of spins (``autocorrelations.rs:53-70``)."""
    s = _pm1(states)
    prods = [s[..., list(vs)].prod(dim=-1) for vs in var_products]
    return fft_autocorrelation(torch.stack(prods, dim=-1))


def bond_autocorrelation(states, edges, ej) -> torch.Tensor:
    """Autocorrelation of bond satisfaction (``autocorrelations.rs:76-97``,
    ``qmc_ising.rs:978-998``): per bond of ``edges i32[E, 2]`` with
    couplings ``ej f32[E]``, +1 where ``-J s_a s_b`` is satisfied, else -1,
    over states ``bool[T, R, N]``."""
    s = _pm1(states)
    e = torch.as_tensor(np.asarray(edges), device=s.device).long()
    j = torch.as_tensor(np.asarray(ej, np.float32), device=s.device)
    prod = j[None, None, :] * s[..., e[:, 0]] * s[..., e[:, 1]]
    return fft_autocorrelation(torch.where(prod < 0, 1.0, -1.0))


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
