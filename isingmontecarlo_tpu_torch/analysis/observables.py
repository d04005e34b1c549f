"""Standard estimators over sampled spin states (port of
``isingmontecarlo_tpu/analysis/observables.py``).

The reference returns raw state trajectories and leaves observables to the
caller (``timesteps_sample``, ``qmc_stepper.rs:23-40``); these cover the
common ones on the batched layout ``bool[..., R, N]`` (any number of
leading sample axes).
"""

from __future__ import annotations

import torch


def _pm1(states) -> torch.Tensor:
    return 2.0 * torch.as_tensor(states).to(torch.float32) - 1.0


def magnetization(states) -> torch.Tensor:
    """Total magnetization per replica (sum over spins), ``f32[..., R]``."""
    return _pm1(states).sum(dim=-1)


def magnetization_squared(states) -> torch.Tensor:
    """``<M^2>`` estimator input per sample and replica, ``f32[..., R]``."""
    m = magnetization(states)
    return m * m


def _mean_leading(x: torch.Tensor) -> torch.Tensor:
    """The mean over every axis but the last (none for a 1-D ``x``)."""
    return x.mean(dim=tuple(range(x.dim() - 1))) if x.dim() > 1 else x


def binder_cumulant(states) -> torch.Tensor:
    """Binder cumulant ``U4 = 1 - <m^4> / (3 <m^2>^2)`` per replica,
    averaged over every leading sample axis; ``f32[R]``."""
    m = magnetization(states)
    m2 = _mean_leading(m * m)
    m4 = _mean_leading(m ** 4)
    return 1.0 - m4 / (3.0 * m2 * m2).clamp(min=1e-30)


def spin_spin_correlation(states) -> torch.Tensor:
    """Correlation at every distance, ``C[d] = <s_i s_{i+d}>``, under the
    periodic 1D site order, averaged over samples and replicas; ``f32[N]``.
    By Wiener-Khinchin with ``torch.fft`` (the reference's FFT
    autocorrelation trick, ``autocorrelations.rs:99-133``, along space)."""
    s = _pm1(states)
    n = s.shape[-1]
    f = torch.fft.rfft(s, dim=-1)
    corr = torch.fft.irfft(f * torch.conj(f), n=n, dim=-1) / n
    return _mean_leading(corr)


def structure_factor(states) -> torch.Tensor:
    """``S(q) = |FFT(s)|^2 / N`` averaged over samples and replicas,
    ``f32[N // 2 + 1]`` (rfft bins)."""
    s = _pm1(states)
    power = torch.fft.rfft(s, dim=-1).abs() ** 2 / s.shape[-1]
    return _mean_leading(power)
