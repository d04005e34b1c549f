"""The traced slice's timesteps whose diagonal update was heat-bath, in
percent: the program's ``sse.diagonal.heatbath`` count (one a heat-bath
diagonal update, ``sse/ising.py`` ``sweep``) over the slice's timesteps,
which the summary keeps as ``heatbath_updates``. 100 in a heat-bath cell; a
cell that silently ran Metropolis reads less, or nothing. None where the
program keeps no such counter."""


def read(trace: dict) -> float | None:
    n = trace.get("heatbath_updates")
    if not trace["events"] or n is None:
        return None
    return 100.0 * n / trace["timesteps"]
