"""Parallel tempering over the replica axis, on one device or sharded over
the ranks of a ``torch.distributed`` process group (port of
``isingmontecarlo_tpu.parallel``; reference ``src/sse/parallel_tempering/``)."""

from isingmontecarlo_tpu_torch.parallel.tempering import (
    TemperingContainer,
    dryrun_sharded,
    new_thread_rng,
    new_with_rng,
    tempering_step,
    tempering_sweep_chunk,
    tempering_sweep_chunk_sharded,
)

__all__ = ["TemperingContainer", "dryrun_sharded", "new_thread_rng", "new_with_rng",
           "tempering_step", "tempering_sweep_chunk", "tempering_sweep_chunk_sharded"]
