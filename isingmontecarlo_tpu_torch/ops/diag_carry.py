"""K3: the diagonal sweep's op-count carry scan, Metropolis and heat-bath.

Replaces ``isingmontecarlo_tpu/ops/diag_carry.py::carry_decisions`` (bodies
``_kernel_metropolis`` and ``_kernel_heatbath``). The CUDA kernels are
``csrc/carry_metropolis.cu`` and ``csrc/carry_heatbath.cu``, one design
(``csrc/carry_ring.cuh``): a producer warp streams the input planes by TMA
through a ring of shared-memory tiles, two warps fold the masks into the
values each slot needs, and one thread per replica walks the M slots,
carrying ``float(M - n)`` as an exact f32 stepped by +-1. See those files
for what bounds them on the card.
"""

from __future__ import annotations

import torch

from isingmontecarlo_tpu_torch.ops import _build

# The kernels carry float(M - n) and float(M - n + 1) in f32, exact only
# for integers of magnitude up to 2^24.
MAX_FLOAT_CARRY_M = 2**24


def _check_float_carry(M: int) -> None:
    """Raise, before any launch, where the kernels' f32 carry of ``M - n``
    would no longer be exact."""
    if M >= MAX_FLOAT_CARRY_M:
        raise ValueError(f"M = {M} slots: the carry kernels need M < 2^24, where "
                         "float(M - n) is exact")


def carry_decisions_plain(n0, u0, idp, dgp, num_ins, num_rem):
    """The plain PyTorch version: a loop over M of the same f32 expressions
    as ``isingmontecarlo_tpu/sse/diagonal.py::_ins_rem``."""
    M = u0.shape[0]
    n = n0.clone()
    insert = torch.empty_like(idp)
    remove = torch.empty_like(dgp)
    for p in range(M):
        mmn = (M - n).to(torch.float32)
        insert[p] = idp[p] & (u0[p] * mmn < num_ins[p])
        remove[p] = dgp[p] & (u0[p] * num_rem[p] < mmn + 1.0)
        n = n + insert[p].to(torch.int32) - remove[p].to(torch.int32)
    return insert, remove


def carry_decisions(n0: torch.Tensor, u0: torch.Tensor, idp: torch.Tensor,
                    dgp: torch.Tensor, num_ins: torch.Tensor,
                    num_rem: torch.Tensor):
    """Metropolis insert/remove decisions for all M slots.

    ``n0 i32[R]`` op counts entering slot 0, ``u0 f32[M, R]`` uniforms,
    ``idp bool[M, R]`` identity slots, ``dgp bool[M, R]`` removable
    diagonal ops, ``num_ins/num_rem f32[M, R]`` the ``beta*NB*w``
    numerators. Returns ``(insert, remove): bool[M, R]``.

    A CPU tensor takes :func:`carry_decisions_plain`; a CUDA tensor launches
    the kernel (counted in ``carry_decisions.launches``) or raises; it
    raises for M >= 2^24."""
    M, R = u0.shape
    dev = u0.device
    _build.check(n0, "n0", torch.int32, (R,), dev)
    _build.check(u0, "u0", torch.float32, (M, R), dev)
    _build.check(idp, "idp", torch.bool, (M, R), dev)
    _build.check(dgp, "dgp", torch.bool, (M, R), dev)
    _build.check(num_ins, "num_ins", torch.float32, (M, R), dev)
    _build.check(num_rem, "num_rem", torch.float32, (M, R), dev)
    if not _build.use_kernel(dev):
        return carry_decisions_plain(n0, u0, idp, dgp, num_ins, num_rem)
    _check_float_carry(M)
    insert = torch.empty((M, R), dtype=torch.bool, device=dev)
    remove = torch.empty((M, R), dtype=torch.bool, device=dev)
    _build.launch("ising_carry_metropolis", n0, u0, idp, dgp, num_ins,
                  num_rem, insert, remove, M, R)
    carry_decisions.launches += 1
    return insert, remove


carry_decisions.launches = 0


def carry_decisions_heatbath_plain(n0, u0, idp, dgp, insw, bwt):
    """The plain PyTorch version of the heat-bath carry: a loop over M of
    the f32 expressions of ``_ins_rem``'s heat-bath branch, with
    ``mmn + 1.0 + bwt`` evaluated left to right as there."""
    M = u0.shape[0]
    n = n0.clone()
    insert = torch.empty_like(idp)
    remove = torch.empty_like(dgp)
    for p in range(M):
        mmn = (M - n).to(torch.float32)
        insert[p] = idp[p] & insw[p] & (u0[p] * (mmn + bwt) < bwt)
        remove[p] = dgp[p] & (u0[p] * (mmn + 1.0 + bwt) < (mmn + 1.0))
        n = n + insert[p].to(torch.int32) - remove[p].to(torch.int32)
    return insert, remove


def carry_decisions_heatbath(n0: torch.Tensor, u0: torch.Tensor,
                             idp: torch.Tensor, dgp: torch.Tensor,
                             insw: torch.Tensor, bwt: torch.Tensor):
    """Heat-bath insert/remove decisions for all M slots.

    ``n0 i32[R]``, ``u0 f32[M, R]``, ``idp/dgp bool[M, R]`` as in
    :func:`carry_decisions`; ``insw bool[M, R]`` the n-independent part of
    the insert test (``u[2] * max_w(b) < w``) and ``bwt f32[R]`` the
    per-replica ``beta * sum_b max_w(b)``. Insert with probability
    ``bwt / (M - n + bwt)``, remove with ``(M - n + 1) / (M - n + 1 + bwt)``
    (``heatbath.rs:149-209``). Returns ``(insert, remove): bool[M, R]``.

    A CPU tensor takes :func:`carry_decisions_heatbath_plain`; a CUDA tensor
    launches the kernel (counted in ``carry_decisions_heatbath.launches``)
    or raises; it raises for M >= 2^24."""
    M, R = u0.shape
    dev = u0.device
    _build.check(n0, "n0", torch.int32, (R,), dev)
    _build.check(u0, "u0", torch.float32, (M, R), dev)
    _build.check(idp, "idp", torch.bool, (M, R), dev)
    _build.check(dgp, "dgp", torch.bool, (M, R), dev)
    _build.check(insw, "insw", torch.bool, (M, R), dev)
    _build.check(bwt, "bwt", torch.float32, (R,), dev)
    if not _build.use_kernel(dev):
        return carry_decisions_heatbath_plain(n0, u0, idp, dgp, insw, bwt)
    _check_float_carry(M)
    insert = torch.empty((M, R), dtype=torch.bool, device=dev)
    remove = torch.empty((M, R), dtype=torch.bool, device=dev)
    _build.launch("ising_carry_heatbath", n0, u0, idp, dgp, insw, bwt,
                  insert, remove, M, R)
    carry_decisions_heatbath.launches += 1
    return insert, remove


carry_decisions_heatbath.launches = 0


def tie_heavy_carry_inputs(M: int, R: int, seed: int, heatbath: bool = False) -> tuple:
    """Carry arguments (numpy) whose slots sit on the comparisons' edge, for
    holding a kernel against its plain version: at each slot a number k is
    drawn from ``{mmn - 1, mmn, mmn + 1}`` around the walk's own
    ``mmn = M - n`` (the walk runs here, in f32), and the slot's inputs are
    made so that the test at ``mmn = k`` is a tie or within an ulp of one.
    An FMA contraction, another association or an off-by-one in the carry
    then changes decisions. Metropolis: ``num_ins = f32(u0 * k)``, and on
    removable slots ``u0 = 2^-e``, ``num_rem = (k + 1) 2^e`` (exact ties).
    Heat-bath: ``u0 = f32(bwt / (k + bwt))`` on identity slots and
    ``f32((k + 1) / (k + 1 + bwt))`` on removable ones. Returns the
    arguments of :func:`carry_decisions` or, with ``heatbath``, of
    :func:`carry_decisions_heatbath`."""
    import numpy as np

    rng = np.random.default_rng(seed)
    f32 = np.float32
    n0 = rng.integers(M // 3, 2 * M // 3 + 1, size=R).astype(np.int32)
    u0 = rng.random((M, R), dtype=f32)
    idp = rng.random((M, R)) < 0.5
    dgp = ~idp & (rng.random((M, R)) < 0.9)
    step = rng.integers(-1, 2, size=(M, R)).astype(f32)
    scale = np.exp2(rng.integers(1, 4, size=(M, R))).astype(f32)
    insw = rng.random((M, R)) < 0.8
    bwt = rng.uniform(0.5 * M, 0.9 * M, R).astype(f32)
    num_ins = np.empty((M, R), f32)
    num_rem = np.empty((M, R), f32)
    n = n0.copy()
    for p in range(M):
        mmn = (M - n).astype(f32)
        k = mmn + step[p]
        if heatbath:
            u0[p] = np.where(idp[p], bwt / (k + bwt), (k + f32(1)) / (k + f32(1) + bwt))
            ins = idp[p] & insw[p] & (u0[p] * (mmn + bwt) < bwt)
            rem = dgp[p] & (u0[p] * (mmn + f32(1) + bwt) < mmn + f32(1))
        else:
            u0[p] = np.where(dgp[p], f32(1) / scale[p], u0[p])
            num_ins[p] = u0[p] * k
            num_rem[p] = (k + f32(1)) * scale[p]
            ins = idp[p] & (u0[p] * mmn < num_ins[p])
            rem = dgp[p] & (u0[p] * num_rem[p] < mmn + f32(1))
        n += ins.astype(np.int32) - rem.astype(np.int32)
    if heatbath:
        return n0, u0, idp, dgp, insw, bwt
    return n0, u0, idp, dgp, num_ins, num_rem
