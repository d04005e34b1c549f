"""Debug and introspection (port of ``isingmontecarlo_tpu/sse/debug.py``;
reference ``src/sse/qmc_debug.rs`` and the ASCII worldline printer
``debug_print_diagonal``, ``src/sse/qmc_traits/diagonal.rs:194-234``).

The counters return per-replica tensors. The printer renders one replica's
worldline (imaginary-time slots top to bottom; ``|`` is a pass-through
worldline, digits are an op's output spins).
"""

from __future__ import annotations

import io

import torch

from isingmontecarlo_tpu_torch.sse.model import BondModel
from isingmontecarlo_tpu_torch.sse.opstring import OpString, op_count


def count_diagonal_and_off(ops: OpString) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-replica (diagonal, off-diagonal) op counts ``i32[R]``, summing to
    ``op_count`` (``qmc_debug.rs:10-26``)."""
    diag_slot = (ops.inputs == ops.outputs).all(dim=0) & (ops.bond >= 0)
    diag = diag_slot.sum(dim=0, dtype=torch.int32)
    return diag, op_count(ops) - diag


def count_constant_ops(ops: OpString, model: BondModel) -> torch.Tensor:
    """Per-replica count of constant (cluster-edge) ops ``i32[R]``
    (``qmc_debug.rs:28-40``)."""
    is_const = model.is_constant[ops.bond.clamp(min=0).long()] & (ops.bond >= 0)
    return is_const.sum(dim=0, dtype=torch.int32)


def debug_print_diagonal(ops: OpString, state: torch.Tensor, model: BondModel,
                         replica: int = 0, file=None) -> str:
    """ASCII worldline dump of one replica in the format of
    ``diagonal.rs:194-234``: a header of ``=``, the p=0 state as 0/1, then
    one line per slot with ``|`` for untouched variables and the op's output
    spins at its variables, annotated with ``p`` and the bond id and its
    variables. Returns the text (also printed to ``file`` if given)."""
    nvars = model.nvars
    bond = ops.bond[:, replica].cpu().numpy()
    outputs = ops.outputs[:, :, replica].T.cpu().numpy()  # [M, K]
    bond_vars = model.bond_vars.cpu().numpy()
    st = state[replica].cpu().numpy()

    buf = io.StringIO()
    buf.write("=" * nvars + "\n")
    buf.write("".join("1" if b else "0" for b in st) + "\n")
    for p in range(bond.shape[0]):
        if bond[p] < 0:
            buf.write("|" * nvars + f"\tp={p}\n")
            continue
        cells = ["|"] * nvars
        shown = []
        for l, v in enumerate(bond_vars[bond[p]]):
            if v >= 0:
                cells[int(v)] = "1" if outputs[p, l] else "0"
                shown.append(int(v))
        buf.write("".join(cells) + f"\tp={p}\t{int(bond[p])}: {shown}\n")
    text = buf.getvalue()
    if file is not None:
        print(text, file=file, end="")
    return text
