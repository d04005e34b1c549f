"""Stochastic series expansion QMC for the transverse-field Ising model
(port of ``isingmontecarlo_tpu.sse``: the Metropolis and heat-bath diagonal
updates, the RVB update, the cluster update and the ``QmcIsingGraph``
stepping API) and the generic k-local engine (``Qmc``, with the
directed-loop update)."""

from isingmontecarlo_tpu_torch.sse import (
    cluster, debug, diagonal, loops, opstring, runner, rvb,
)
from isingmontecarlo_tpu_torch.sse.cluster import (
    cluster_labels, cluster_update, cluster_update_impl, segment_graph,
)
from isingmontecarlo_tpu_torch.sse.diagonal import (
    HeatBathTables, diagonal_update, make_heatbath_tables,
)
from isingmontecarlo_tpu_torch.sse.ising import (
    Draws,
    GeneratorDraws,
    HamInfo,
    QmcIsingGraph,
    SseState,
    multi_sweep,
    new_qmc,
    new_qmc_from_graph,
    resample_free_spins,
    sweep,
)
from isingmontecarlo_tpu_torch.sse.loops import GeneratorLoopDraws, LoopDraws, loop_update
from isingmontecarlo_tpu_torch.sse.model import BondModel, generic_model, tfim_model
from isingmontecarlo_tpu_torch.sse.opstring import OpString
from isingmontecarlo_tpu_torch.sse.runner import (
    Interaction, Qmc, generic_multi_sweep, generic_sweep,
)
from isingmontecarlo_tpu_torch.sse.rvb import (
    GeneratorRvbDraws, RvbDraws, RvbTables, make_rvb_tables, rvb_sweep, rvb_update_once,
)

__all__ = [
    "BondModel",
    "Draws",
    "GeneratorDraws",
    "GeneratorLoopDraws",
    "GeneratorRvbDraws",
    "HamInfo",
    "HeatBathTables",
    "Interaction",
    "LoopDraws",
    "OpString",
    "Qmc",
    "QmcIsingGraph",
    "RvbDraws",
    "RvbTables",
    "SseState",
    "cluster",
    "cluster_labels",
    "cluster_update",
    "cluster_update_impl",
    "debug",
    "diagonal",
    "diagonal_update",
    "generic_model",
    "generic_multi_sweep",
    "generic_sweep",
    "loop_update",
    "loops",
    "make_heatbath_tables",
    "make_rvb_tables",
    "multi_sweep",
    "new_qmc",
    "new_qmc_from_graph",
    "opstring",
    "resample_free_spins",
    "runner",
    "rvb",
    "rvb_sweep",
    "rvb_update_once",
    "segment_graph",
    "sweep",
    "tfim_model",
]
