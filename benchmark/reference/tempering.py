"""A plain reference of parallel tempering's neighbour swap on a beta
ladder (the upstream's ``swap_on_chunks``,
``src/sse/parallel_tempering/tempering_container.rs:274-302``, with the
Ising relative weight of ``tempering_traits.rs:117-155``), in plain torch.

Replicas are ranked by beta, ascending and stable. With parity 0 the ranks
pair as (0, 1), (2, 3), ...; with parity 1 as (1, 2), (3, 4), .... A pair
(a, b), a the lower rank, exchanges labels where ``log u < (n_b - n_a)
(log beta_a - log beta_b)`` on its lower rank's uniform ``u``, in float32
as the configuration states; ``u`` is indexed by rank.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

# Gathers a rank's 1-D array into every rank's, concatenated in rank order.
Exchange = Callable[[np.ndarray], np.ndarray]


def neighbour_swap(n: np.ndarray, betas: np.ndarray, u: torch.Tensor, parity: int,
                   device) -> tuple[np.ndarray, int]:
    """One alternating-parity swap sweep of all ``R`` replicas' labels.
    Returns ``perm`` (replica ``r`` takes the labels of replica
    ``perm[r]``) and the number of pairs that swapped."""
    R = len(betas)
    b = torch.as_tensor(betas.astype(np.float32), device=device)
    order = torch.argsort(b, stable=True)
    bs = b[order]
    ns = torch.as_tensor(n, device=device)[order].to(torch.float32)
    logp = (ns[1:] - ns[:-1]) * (torch.log(bs[:-1]) - torch.log(bs[1:]))
    lower = torch.arange(R - 1, device=device)
    pairs = (lower % 2) == parity
    take = pairs & (torch.log(u[:-1]) < logp)
    partner = torch.arange(R, device=device)
    partner[:-1] = torch.where(take, lower + 1, partner[:-1])
    partner[1:] = torch.where(take, lower, partner[1:])
    perm = torch.empty_like(order)
    perm[order] = order[partner]
    return perm.cpu().numpy(), int(take.sum())
