"""Hand-written CUDA kernels for Hopper (``sm_90a``) for the TPU kernels of
the classical checkerboard path (K1) and the SSE timestep (K2, K3, K3-hb,
K4), each beside its plain PyTorch version. K1 has a cluster, a banded
and a tiled variant (and a global-memory one that is no longer dispatched), K2 a shared, a wide and a global-memory
variant, each picked from the field's or the model's size; K4's gather
also takes the hook-and-compress steps around it, as three entry points.
The library builds from ``csrc/`` at first use (see :mod:`._build`)."""

from isingmontecarlo_tpu_torch.ops.checkerboard import (
    checkerboard_multi_sweep,
    checkerboard_multi_sweep_bands,
    checkerboard_multi_sweep_global,
    checkerboard_multi_sweep_plain,
    checkerboard_multi_sweep_tiles,
)
from isingmontecarlo_tpu_torch.ops.diag_carry import (
    carry_decisions,
    carry_decisions_heatbath,
    carry_decisions_heatbath_plain,
    carry_decisions_plain,
)
from isingmontecarlo_tpu_torch.ops.parity_kernel import (
    parity_bits,
    parity_bits_global,
    parity_bits_plain,
    parity_bits_wide,
)
from isingmontecarlo_tpu_torch.ops.take_kernel import (
    hook_min,
    hook_min_plain,
    pointer_jump,
    pointer_jump_plain,
    take0,
    take0_plain,
)

# The wrappers whose ``launches`` count the kernel launches of a run.
KERNELS = (checkerboard_multi_sweep, checkerboard_multi_sweep_bands,
           checkerboard_multi_sweep_tiles, checkerboard_multi_sweep_global, parity_bits, parity_bits_wide, parity_bits_global,
           carry_decisions, carry_decisions_heatbath, take0, hook_min, pointer_jump)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def launch_counts() -> dict[str, int]:
    return {k.__name__: k.launches for k in KERNELS}


__all__ = [
    "KERNELS",
    "carry_decisions",
    "carry_decisions_heatbath",
    "carry_decisions_heatbath_plain",
    "carry_decisions_plain",
    "checkerboard_multi_sweep",
    "checkerboard_multi_sweep_bands",
    "checkerboard_multi_sweep_global",
    "checkerboard_multi_sweep_plain",
    "checkerboard_multi_sweep_tiles",
    "hook_min",
    "hook_min_plain",
    "launch_counts",
    "parity_bits",
    "parity_bits_global",
    "parity_bits_plain",
    "parity_bits_wide",
    "pointer_jump",
    "pointer_jump_plain",
    "reset_launch_counts",
    "take0",
    "take0_plain",
]
