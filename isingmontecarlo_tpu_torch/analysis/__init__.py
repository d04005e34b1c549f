"""Analysis helpers: FFT autocorrelations and state observables (torch),
and the integrated autocorrelation time and ESS (numpy)."""

from isingmontecarlo_tpu_torch.analysis.autocorr import (
    bond_autocorrelation,
    effective_sample_size,
    fft_autocorrelation,
    integrated_autocorrelation_time,
    product_autocorrelation,
    sample_autocorrelation,
    spin_autocorrelation,
)
from isingmontecarlo_tpu_torch.analysis.observables import (
    binder_cumulant,
    magnetization,
    magnetization_squared,
    spin_spin_correlation,
    structure_factor,
)

__all__ = [
    "binder_cumulant",
    "bond_autocorrelation",
    "effective_sample_size",
    "fft_autocorrelation",
    "integrated_autocorrelation_time",
    "magnetization",
    "magnetization_squared",
    "product_autocorrelation",
    "sample_autocorrelation",
    "spin_autocorrelation",
    "spin_spin_correlation",
    "structure_factor",
]
