"""K2: the diagonal precompute's flip-parity scan.

Replaces ``isingmontecarlo_tpu/ops/parity_kernel.py::parity_bits``. The
interface takes the p=0 state unpacked (``bool[R, N]``) and marks sentinel
legs by a variable outside ``[0, N)``; the 32-bit word packing is internal
to the CUDA kernel, ``csrc/parity_bits.cu`` (a two-pass scan over segments
of M, one thread per replica and segment, carry in shared memory). See that
file for what bounds it on the card.
"""

from __future__ import annotations

import torch

from isingmontecarlo_tpu_torch.ops import _build

# Elements of one M-chunk's [Mc, R, N+1] flip tensor in the plain version.
_PLAIN_CHUNK_ELEMS = 1 << 26

# The kernel cuts M into about this many segments per replica (whole tiles
# of 16 slots each), so that R * _SEGMENTS threads share the serial scan.
_SEGMENTS = 64


def parity_bits_plain(state, v_idx, tog, vq):
    """The plain PyTorch version: per M-chunk, scatter the toggles into a
    ``[Mc, R, N+1]`` flip tensor (column ``N`` takes the sentinels), take
    the running XOR as a cumulative sum's low bit, and thread the parity
    across chunks as a carry (exact: XOR is associative). Chunking keeps the
    memory bounded at any M."""
    K, M, R = v_idx.shape
    N = state.shape[1]
    dev = state.device
    v_ok = tog & (v_idx >= 0) & (v_idx < N)
    v_safe = torch.where(v_ok, v_idx, N).long().permute(1, 2, 0)  # [M, R, K]
    q_ok = (vq >= 0) & (vq < N)
    q_safe = torch.where(q_ok, vq, 0).long()
    sb = torch.gather(state.T, 0, q_safe.reshape(K * M, R)).reshape(K, M, R) & q_ok
    q_mrk = q_safe.permute(1, 2, 0)
    Mc = max(1, _PLAIN_CHUNK_ELEMS // (R * (N + 1)))
    carry = torch.zeros((R, N + 1), dtype=torch.int32, device=dev)
    pbs = []
    for c0 in range(0, M, Mc):
        c1 = min(M, c0 + Mc)
        flips = torch.zeros((c1 - c0, R, N + 1), dtype=torch.int32, device=dev)
        flips.scatter_(2, v_safe[c0:c1], 1)
        inc = torch.cumsum(flips, dim=0, dtype=torch.int32)
        excl = torch.cat([torch.zeros_like(carry)[None], inc[:-1]]) + carry
        pbs.append(torch.gather(excl, 2, q_mrk[c0:c1]) & 1)
        carry = (carry + inc[-1]) & 1
    pb = torch.cat(pbs).permute(2, 0, 1).bool() & q_ok
    return pb, sb


def parity_bits(state: torch.Tensor, v_idx: torch.Tensor, tog: torch.Tensor,
                vq: torch.Tensor):
    """Per-(leg, slot) flip parity and p=0 spin of the proposal variables.

    ``state bool[R, N]`` p=0 spins, ``v_idx i32[K, M, R]`` current-op leg
    variables, ``tog bool[K, M, R]`` leg toggles (``inputs != outputs``),
    ``vq i32[K, M, R]`` proposal-bond leg variables; a variable outside
    ``[0, N)`` is a sentinel (no toggle, bits read 0). Slot ``p`` reads the
    parity of the toggles of slots ``< p``. Returns ``(pb, sb): bool[K, M,
    R]``.

    A CPU tensor takes :func:`parity_bits_plain`; a CUDA tensor launches the
    kernel (counted in ``parity_bits.launches``) or raises."""
    K, M, R = v_idx.shape
    N = state.shape[1]
    dev = state.device
    _build.check(state, "state", torch.bool, (R, N), dev)
    _build.check(v_idx, "v_idx", torch.int32, (K, M, R), dev)
    _build.check(tog, "tog", torch.bool, (K, M, R), dev)
    _build.check(vq, "vq", torch.int32, (K, M, R), dev)
    if not _build.use_kernel(dev):
        return parity_bits_plain(state, v_idx, tog, vq)
    if not 1 <= K <= 4:
        raise ValueError(f"the parity kernel is built for 1 to 4 legs, got {K}")
    seg_len = 16 * -(-M // (16 * _SEGMENTS))
    nseg = -(-M // seg_len)
    seg = torch.empty((max(nseg - 1, 1), -(-N // 32), R), dtype=torch.int32, device=dev)
    pb = torch.empty((K, M, R), dtype=torch.bool, device=dev)
    sb = torch.empty((K, M, R), dtype=torch.bool, device=dev)
    _build.launch("ising_parity_bits", state, v_idx, tog, vq, seg, pb, sb,
                  K, M, R, N, seg_len)
    parity_bits.launches += 1
    return pb, sb


parity_bits.launches = 0
