"""Hamiltonian bond tables (port of ``isingmontecarlo_tpu/sse/model.py``).

Every bond's matrix elements are precompiled into dense tables indexed by
bond id, so the update loops are gathers. Substate indexing: bit ``l`` of the
substate index is the spin of the variable in leg slot ``l``. Site bonds use
slot 0 and pad slot 1 with variable ``-1``; their rows are constant in bit 1.

TFIM bond layout (``src/sse/qmc_ising.rs:186-205``): ``[0, NE)`` two-site
bonds, ``[NE, NE+N)`` transverse-field site bonds (constant ops, the cluster
edges), ``[NE+N, NE+2N)`` longitudinal site bonds when ``h != 0``.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch import nn

from isingmontecarlo_tpu_torch.lattice import Edge, nvars_from_edges


class BondModel(nn.Module):
    """Compiled Hamiltonian: tables indexed by bond id, held as buffers so
    ``.to(device)`` moves them together.

    Shapes: ``NB`` bonds, ``K`` max legs per bond (2 for TFIM), ``N`` spins.
    ``diag_w[b, s] == wtab[cls[b], s]`` and
    ``full_w[b].reshape(-1) == wtab_full[cls_full[b]]`` bit for bit (see
    :func:`class_tables`)."""

    bond_vars: torch.Tensor  # i32[NB, K], -1 pads unused legs
    is_constant: torch.Tensor  # bool[NB]
    diag_w: torch.Tensor  # f32[NB, 2^K]
    full_w: torch.Tensor  # f32[NB, 2^K, 2^K]
    cls: torch.Tensor  # i32[NB]
    wtab: torch.Tensor  # f32[C, 2^K]
    cls_full: torch.Tensor  # i32[NB]
    wtab_full: torch.Tensor  # f32[C2, 4^K]

    def __init__(self, bond_vars, is_constant, diag_w, full_w, cls, wtab,
                 cls_full, wtab_full, offset: float, nvars: int):
        super().__init__()
        self.register_buffer("bond_vars", bond_vars)
        self.register_buffer("is_constant", is_constant)
        self.register_buffer("diag_w", diag_w)
        self.register_buffer("full_w", full_w)
        self.register_buffer("cls", cls)
        self.register_buffer("wtab", wtab)
        self.register_buffer("cls_full", cls_full)
        self.register_buffer("wtab_full", wtab_full)
        self.offset = float(offset)  # energy offset from the weight shifts
        self.nvars = int(nvars)

    @property
    def nbonds(self) -> int:
        return self.bond_vars.shape[0]

    @property
    def max_legs(self) -> int:
        return self.bond_vars.shape[1]

    def arity(self) -> torch.Tensor:
        """i32[NB] number of valid legs per bond."""
        return (self.bond_vars >= 0).sum(dim=1, dtype=torch.int32)

    def max_diag_w(self) -> torch.Tensor:
        """f32[NB]: max diagonal weight per bond (heat-bath ``BondWeights``,
        ``src/sse/qmc_traits/heatbath.rs:130-146``)."""
        return self.diag_w.max(dim=1).values


def class_tables(diag_w: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Group bonds by identical table rows. Returns ``(cls i32[NB],
    wtab f32[C, cols])`` with ``diag_w[b] == wtab[cls[b]]`` bit for bit
    (``wtab`` rows are copies of original rows)."""
    uq, inv = np.unique(np.asarray(diag_w), axis=0, return_inverse=True)
    return inv.reshape(-1).astype(np.int32), uq.astype(np.float32)


def two_site_diag_weight(j: float, s0: bool, s1: bool) -> float:
    """``|J| - J`` for aligned spins, ``|J| + J`` for anti-aligned
    (``qmc_ising.rs:863-874``)."""
    return abs(j) + (-j if s0 == s1 else j)


def longitudinal_diag_weight(h: float, s: bool) -> float:
    """``|h| + h`` spin-up, ``|h| - h`` spin-down (``qmc_ising.rs:880-888``)."""
    return abs(h) + (h if s else -h)


def tfim_model(
    edges: Sequence[tuple[Edge, float]],
    transverse: float,
    longitudinal: float = 0.0,
    nvars: int | None = None,
    *,
    device: torch.device | str = "cuda",
) -> BondModel:
    """The TFIM bond model
    ``H = sum_ij J_ij s^z_i s^z_j + G sum_i s^x_i (+ longitudinal site terms)``
    with the reference's bond layout and energy offset
    (``qmc_ising.rs:80-115, 186-205, 863-888``), on ``device``."""
    if nvars is None:
        nvars = nvars_from_edges(edges)
    ne = len(edges)
    has_h = abs(longitudinal) > 1e-12
    nb = ne + nvars + (nvars if has_h else 0)
    K = 2

    bond_vars = np.full((nb, K), -1, dtype=np.int32)
    is_constant = np.zeros((nb,), dtype=bool)
    diag_w = np.zeros((nb, 1 << K), dtype=np.float32)
    full_w = np.zeros((nb, 1 << K, 1 << K), dtype=np.float32)

    for b, ((va, vb), j) in enumerate(edges):
        bond_vars[b] = (va, vb)
        for s in range(4):
            w = two_site_diag_weight(j, bool(s & 1), bool(s & 2))
            diag_w[b, s] = w
            full_w[b, s, s] = w

    for v in range(nvars):
        b = ne + v
        bond_vars[b, 0] = v
        is_constant[b] = True
        # Transverse ops: weight `transverse` for every in/out combination of
        # leg 0 (qmc_ising.rs:876-878); bit 1 is padding and must not vary.
        for s in range(4):
            diag_w[b, s] = transverse
            for t in range(4):
                if (s & 2) == (t & 2):
                    full_w[b, s, t] = transverse

    if has_h:
        for v in range(nvars):
            b = ne + nvars + v
            bond_vars[b, 0] = v
            for s in range(4):
                w = longitudinal_diag_weight(longitudinal, bool(s & 1))
                diag_w[b, s] = w
                full_w[b, s, s] = w

    # Energy offset: sum |J| + n (G + |h|)  (qmc_ising.rs:97-99).
    offset = float(sum(abs(j) for _, j in edges)) + nvars * (
        transverse + abs(longitudinal)
    )
    cls, wtab = class_tables(diag_w)
    cls_full, wtab_full = class_tables(full_w.reshape(nb, -1))
    t = torch.from_numpy
    return BondModel(
        t(bond_vars), t(is_constant), t(diag_w), t(full_w),
        t(cls), t(wtab), t(cls_full), t(wtab_full),
        offset=offset, nvars=nvars,
    ).to(device)


def generic_model(
    nvars: int,
    interactions: Sequence[tuple[np.ndarray, Sequence[int]]],
    offset: float = 0.0,
    *,
    device: torch.device | str = "cuda",
) -> BondModel:
    """A model of arbitrary k-local interaction matrices, on ``device``
    (``Qmc::make_interaction``, ``qmc_runner.rs:112-156``).

    ``interactions`` is a list of ``(mat, vars)``: ``mat`` a full
    ``2^k x 2^k`` matrix (row = outputs, column = inputs; the first variable
    is the most significant bit, ``qmc_runner.rs:673-680``) or a
    length-``2^k`` diagonal, with non-negative entries. ``K`` is the largest
    ``k``; a bond of fewer legs is constant in the unused legs' bits."""
    K = max(len(vars) for _, vars in interactions)
    nb = len(interactions)
    bond_vars = np.full((nb, K), -1, dtype=np.int32)
    is_constant = np.zeros((nb,), dtype=bool)
    diag_w = np.zeros((nb, 1 << K), dtype=np.float32)
    full_w = np.zeros((nb, 1 << K, 1 << K), dtype=np.float32)

    for b, (mat, vars) in enumerate(interactions):
        mat = np.asarray(mat, dtype=np.float64)
        k = len(vars)
        bond_vars[b, :k] = vars
        nstates = 1 << k

        def to_ref_bits(local_idx: int) -> int:
            # Bit l here is slot l's spin; the reference's first variable is
            # the most significant bit.
            ref = 0
            for l in range(k):
                ref = (ref << 1) | ((local_idx >> l) & 1)
            return ref

        if mat.ndim == 1 or (mat.ndim == 2 and mat.shape[0] == 1):
            mat = mat.reshape(-1)
            if mat.shape[0] != nstates:
                raise ValueError(f"diagonal interaction len {mat.shape[0]} != 2^{k}")
            if np.any(mat < 0):
                raise ValueError("negative weights are not allowed")
            for s in range(nstates):
                w = float(mat[to_ref_bits(s)])
                for pad in range(1 << (K - k)):
                    idx = s | (pad << k)
                    diag_w[b, idx] = w
                    full_w[b, idx, idx] = w
        else:
            if mat.shape != (nstates, nstates):
                raise ValueError(f"interaction shape {mat.shape} != (2^{k}, 2^{k})")
            if np.any(mat < 0):
                raise ValueError("negative weights are not allowed")
            for si in range(nstates):
                for so in range(nstates):
                    # reference index = (outputs << k) + inputs
                    w = float(mat[to_ref_bits(so), to_ref_bits(si)])
                    for pad in range(1 << (K - k)):
                        ii = si | (pad << k)
                        oo = so | (pad << k)
                        full_w[b, ii, oo] = w
                        if ii == oo:
                            diag_w[b, ii] = w
            is_constant[b] = bool(np.all(np.abs(mat - mat.flat[0]) < 1e-12))

    cls, wtab = class_tables(diag_w)
    cls_full, wtab_full = class_tables(full_w.reshape(nb, -1))
    t = torch.from_numpy
    return BondModel(
        t(bond_vars), t(is_constant), t(diag_w), t(full_w),
        t(cls), t(wtab), t(cls_full), t(wtab_full),
        offset=offset, nvars=nvars,
    ).to(device)
