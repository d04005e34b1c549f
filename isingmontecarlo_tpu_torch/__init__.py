"""isingmontecarlo_tpu_torch — the classical engine, the SSE
transverse-field Ising engine, the generic k-local SSE engine, parallel
tempering on one device or sharded over the ranks of a process group,
checkpoints, profiling and the analysis helpers of
``isingmontecarlo_tpu`` on PyTorch, with hand-written CUDA kernels for an
NVIDIA Hopper GPU.

The package imports ``torch`` and numpy only. Constructors and entry points
run on ``device="cuda"`` unless the caller passes another device; a CPU
tensor runs each kernel's plain PyTorch version and a CUDA tensor the kernel
(built from ``csrc/`` at first use).
"""

from isingmontecarlo_tpu_torch import (
    analysis, checkpoint, classical, lattice, ops, parallel, profiling, sse,
)
from isingmontecarlo_tpu_torch.classical import GraphState, LatticeIsing
from isingmontecarlo_tpu_torch.parallel import TemperingContainer
from isingmontecarlo_tpu_torch.sse import Qmc, QmcIsingGraph, tfim_model

__all__ = ["GraphState", "LatticeIsing", "Qmc", "QmcIsingGraph", "TemperingContainer",
           "analysis", "checkpoint", "classical", "lattice", "ops", "parallel", "profiling",
           "sse", "tfim_model"]
