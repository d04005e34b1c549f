"""K4: per-replica gather ``out[e, r] = table[idx[e, r], r]``.

Replaces ``isingmontecarlo_tpu/ops/take_kernel.py::take0`` (a Pallas
digit-plane gather on the TPU's matrix unit). The CUDA kernel is
``csrc/take0.cu``: one thread per output element, no row or value caps. See
that file for what bounds it on the card.
"""

from __future__ import annotations

import torch

from isingmontecarlo_tpu_torch.ops import _build


def take0_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: ``torch.gather`` along axis 0."""
    return torch.gather(table, 0, idx.long())


def take0(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``take_along_axis(table, idx, axis=0)`` for ``table i32[C, R]`` and
    ``idx i32[E, R]`` with values in ``[0, C)``; returns ``i32[E, R]``.

    A CPU tensor takes :func:`take0_plain`; a CUDA tensor launches the
    kernel (and counts the launch in ``take0.launches``) or raises."""
    C, R = table.shape
    E = idx.shape[0]
    _build.check(table, "table", torch.int32, (C, R), table.device)
    _build.check(idx, "idx", torch.int32, (E, R), table.device)
    if not _build.use_kernel(table.device):
        return take0_plain(table, idx)
    out = torch.empty((E, R), dtype=torch.int32, device=table.device)
    _build.launch("ising_take0", table, idx, out, C, E, R)
    take0.launches += 1
    return out


take0.launches = 0
