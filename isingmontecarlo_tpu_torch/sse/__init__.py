"""Stochastic series expansion QMC for the transverse-field Ising model
(port of ``isingmontecarlo_tpu.sse``: the Metropolis diagonal update, the
cluster update and the ``QmcIsingGraph`` stepping API)."""

from isingmontecarlo_tpu_torch.sse import cluster, diagonal, opstring
from isingmontecarlo_tpu_torch.sse.cluster import cluster_update_impl, segment_graph
from isingmontecarlo_tpu_torch.sse.diagonal import diagonal_update
from isingmontecarlo_tpu_torch.sse.ising import (
    Draws,
    GeneratorDraws,
    QmcIsingGraph,
    SseState,
    multi_sweep,
    resample_free_spins,
    sweep,
)
from isingmontecarlo_tpu_torch.sse.model import BondModel, tfim_model
from isingmontecarlo_tpu_torch.sse.opstring import OpString

__all__ = [
    "BondModel",
    "Draws",
    "GeneratorDraws",
    "OpString",
    "QmcIsingGraph",
    "SseState",
    "cluster",
    "cluster_update_impl",
    "diagonal",
    "diagonal_update",
    "multi_sweep",
    "opstring",
    "resample_free_spins",
    "segment_graph",
    "sweep",
    "tfim_model",
]
