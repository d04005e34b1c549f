"""isingmontecarlo_tpu_torch — the SSE transverse-field Ising engine of
``isingmontecarlo_tpu`` on PyTorch, with hand-written CUDA kernels for an
NVIDIA Hopper GPU.

The package imports ``torch`` and numpy only. Every constructor takes an
explicit ``device``; a CPU tensor runs each kernel's plain PyTorch version
and a CUDA tensor the kernel (built from ``csrc/`` at first use).
"""

from isingmontecarlo_tpu_torch import analysis, lattice, ops, sse
from isingmontecarlo_tpu_torch.sse import QmcIsingGraph, tfim_model

__all__ = ["QmcIsingGraph", "analysis", "lattice", "ops", "sse", "tfim_model"]
