"""Analysis helpers (numpy)."""

from isingmontecarlo_tpu_torch.analysis.autocorr import (
    effective_sample_size,
    integrated_autocorrelation_time,
)

__all__ = ["effective_sample_size", "integrated_autocorrelation_time"]
