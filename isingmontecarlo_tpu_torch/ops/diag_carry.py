"""K3: the diagonal sweep's op-count carry scan, Metropolis and heat-bath.

Replaces ``isingmontecarlo_tpu/ops/diag_carry.py::carry_decisions`` (bodies
``_kernel_metropolis`` and ``_kernel_heatbath``). The CUDA kernels are
``csrc/carry_metropolis.cu`` and ``csrc/carry_heatbath.cu``: one thread per
replica walks the M slots with the op count in a register. See those files
for what bounds them on the card.
"""

from __future__ import annotations

import torch

from isingmontecarlo_tpu_torch.ops import _build


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
    the kernel (counted in ``carry_decisions.launches``) or raises."""
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
    or raises."""
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
    insert = torch.empty((M, R), dtype=torch.bool, device=dev)
    remove = torch.empty((M, R), dtype=torch.bool, device=dev)
    _build.launch("ising_carry_heatbath", n0, u0, idp, dgp, insw, bwt,
                  insert, remove, M, R)
    carry_decisions_heatbath.launches += 1
    return insert, remove


carry_decisions_heatbath.launches = 0
