"""Analysis helpers: FFT autocorrelations (torch) and the integrated
autocorrelation time and ESS (numpy)."""

from isingmontecarlo_tpu_torch.analysis.autocorr import (
    bond_autocorrelation,
    effective_sample_size,
    fft_autocorrelation,
    integrated_autocorrelation_time,
    product_autocorrelation,
    sample_autocorrelation,
    spin_autocorrelation,
)

__all__ = [
    "bond_autocorrelation",
    "effective_sample_size",
    "fft_autocorrelation",
    "integrated_autocorrelation_time",
    "product_autocorrelation",
    "sample_autocorrelation",
    "spin_autocorrelation",
]
