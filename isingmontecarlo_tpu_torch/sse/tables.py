"""Per-bond table lookups on ``[E, R]`` index grids.

The JAX package routes these through a digit-plane gather kernel and
compare-select chains, because per-lane gathers scalarise on a TPU. On a GPU
a gather from a small table shared by all replicas is plain indexing, which
reads the original entries and so is bit-exact with every TPU form. Likewise
the heat-bath proposal is a plain binary search, not the TPU's two-level
compare-count.
"""

from __future__ import annotations

import torch

from isingmontecarlo_tpu_torch.ops.take_kernel import take0


def bond_fetch(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``tab[idx]`` as int32 for a per-bond table ``tab[NB]`` and an index
    grid ``idx i32[E, R]`` with values in ``[0, NB)``."""
    return tab.to(torch.int32)[idx.long()]


def bond_fetch_multi(tabs, idx: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """Several per-bond tables fetched at the same index grid."""
    i = idx.long()
    return tuple(t.to(torch.int32)[i] for t in tabs)


def searchsorted_left(table: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """The count of entries ``table < q`` (``searchsorted`` with
    ``side='left'``), ``i32[M, R]``, for a sorted f32 table ``[NB]`` or
    per-replica tables ``[R, NB]`` searched against the columns of the query
    grid ``q f32[M, R]`` (``isingmontecarlo_tpu/sse/tables.py:151-175``)."""
    if table.dim() == 2:
        return torch.searchsorted(table, q.T.contiguous()).T.to(torch.int32)
    return torch.searchsorted(table, q).to(torch.int32)


def fetch_xor(bond_xor: torch.Tensor, b: torch.Tensor,
              b2: torch.Tensor | None = None):
    """Per-replica sign-pattern masks ``bond_xor[r, b[e, r]]``, ``i32[E, R]``,
    for ``bond_xor i32[R, NB]`` and a bond grid ``b i32[E, R]`` (with ``b2``
    a second grid, gathered in the same launch; returns the pair). This is
    K4's per-replica gather on the table's transpose, as the JAX package
    takes ``take0`` on its chip (``isingmontecarlo_tpu/sse/tables.py:93-109``):
    the kernel on CUDA, ``torch.gather`` on the CPU."""
    table = bond_xor.T.contiguous()
    return take0(table, b.contiguous(), None if b2 is None else b2.contiguous())
