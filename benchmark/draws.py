"""The uniforms both sides consume: the program's ``Draws`` protocol
(``isingmontecarlo_tpu_torch/sse/ising.py:68-117``) on ``torch.Generator``
objects that the benchmark seeds. The reference draws the same numbers by
restoring a generator's state and asking for the shapes it expects, in the
order it expects them, so a program that asks for other shapes or in
another order reads other numbers and fails the comparison."""

from __future__ import annotations

import numpy as np
import torch


def sub_seeds(seed: int, n: int) -> list[int]:
    """``n`` independent 63-bit seeds from the run's ``--seed``."""
    return [int(s) >> 1 for s in np.random.SeedSequence(seed).generate_state(n, np.uint64)]


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=torch.device(device)).manual_seed(seed)


def uniform(gen: torch.Generator, shape) -> torch.Tensor:
    return torch.rand(tuple(shape), generator=gen, device=gen.device, dtype=torch.float32)


class SeededDraws:
    """A timestep's uniforms from one generator; a tempering swap's from
    ``swap_gen`` where given (the replicated stream of a sharded ladder)."""

    def __init__(self, gen: torch.Generator, swap_gen: torch.Generator | None = None):
        self.generator = gen
        self.swap_generator = swap_gen or gen

    def diagonal(self, shape):
        return uniform(self.generator, shape)

    def cluster(self, shape):
        return uniform(self.generator, shape)

    def free_spins(self, shape):
        return uniform(self.generator, shape) < 0.5

    def swap(self, shape):
        return uniform(self.swap_generator, shape)

    def rvb(self, n_updates):
        raise NotImplementedError("no configuration of the benchmark runs RVB updates")

    def loops(self):
        raise NotImplementedError("no configuration of the benchmark runs directed loops")
