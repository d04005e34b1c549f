"""Parallel tempering over the replica axis on one device (port of
``isingmontecarlo_tpu.parallel``; reference ``src/sse/parallel_tempering/``)."""

from isingmontecarlo_tpu_torch.parallel.tempering import (
    TemperingContainer,
    tempering_step,
    tempering_sweep_chunk,
)

__all__ = ["TemperingContainer", "tempering_step", "tempering_sweep_chunk"]
