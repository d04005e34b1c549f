"""K2: the diagonal precompute's flip-parity scan.

Replaces ``isingmontecarlo_tpu/ops/parity_kernel.py::parity_bits``. The
interface takes the p=0 state unpacked (``bool[R, N]``) and marks sentinel
legs by a variable outside ``[0, N)``; the 32-bit word packing is internal
to the CUDA kernels. Three variants, which :func:`k2_variant` picks from N:
``csrc/parity_bits.cu`` (a scan over segments of M: a warp per 32 replicas
and segment, carry and the group's packed state in shared memory, the
segments' prefix in one linear pass; N up to 29,056 on an H100), its wide
variant in the same file (:func:`parity_bits_wide`: only the carry and a
ring of slot tiles in shared memory, a CTA of one warp fed by TMA, the
segments' toggles and the p=0 spins in fully parallel passes; N up to
53,472, past every N an SSE model's int32 leg key admits), and
``csrc/parity_bits_global.cu`` (the same passes, a thread per replica and
segment, carry in global memory) for any N. Any number of legs K; a slot's
toggled legs act as a set (two legs on one variable flip it once). See
those files for what bounds them on the card.
"""

from __future__ import annotations

import torch

from isingmontecarlo_tpu_torch.ops import _build

# Elements of one M-chunk's [Mc, R, N+1] flip tensor in the plain version.
_PLAIN_CHUNK_ELEMS = 1 << 26

# The kernel cuts M into segments, a warp each per 32 replicas, so that
# about this many warps share each SM (the chain of a segment is latency:
# more warps hide it, while each segment adds an N-bit vector to the
# scratch that the prefix pass reads and writes). On an H100 at K=2,
# M=7000, R=256, N=1024, 16 ran fastest of 4, 8, 12, 16, 24 and 32.
_WARPS_PER_SM = 16
# A warp's carry is N bits in shared memory, 32 * ceil(N / 32) words. The
# shared variant's CTA holds at least one warp's carry and its replica
# group's packed state (two such vectors), the wide variant's one carry and
# at least two ring stages of slots, in the 232,448 bytes an H100 block can
# have.
MAX_SHARED_BYTES = 232_448
# The wide variant's ring: a stage holds up to 32 rows (legs x slots of a
# tile) of 32 replicas' current leg, proposal leg (4 bytes each) and toggle
# (1 byte); two stages and three mbarriers at the least.
WIDE_RING_BYTES = 2 * 32 * 32 * 9 + 3 * 8
# The global variant's scratch (an N-bit vector per segment and replica, and
# the packed state) is kept within this many bytes, inside the 50 MB L2.
GLOBAL_SCRATCH_BYTES = 1 << 25


def carry_bytes(N: int) -> int:
    """Bytes of one warp's N-bit carry in shared memory: 32 lanes of
    ceil(N / 32) words."""
    return 32 * 4 * -(-N // 32)


def k2_variant(N: int, max_shared_bytes: int = MAX_SHARED_BYTES) -> str:
    """K2's variant for ``N`` spins: ``"shared"`` (``csrc/parity_bits.cu``)
    when a CTA's ``max_shared_bytes`` hold two N-bit vectors of 32 replicas
    (on an H100 every N up to 29,056); ``"wide"`` (the same file's wide
    variant) when they hold one and :data:`WIDE_RING_BYTES` (N up to
    53,472); else ``"global"`` (``csrc/parity_bits_global.cu``)."""
    if 2 * carry_bytes(N) <= max_shared_bytes:
        return "shared"
    return "wide" if carry_bytes(N) + WIDE_RING_BYTES <= max_shared_bytes else "global"


def segment_length(M: int, R: int, n_sms: int) -> int:
    """Slots of one segment of the kernel's scan: a multiple of 4 (the
    slots of one store) that cuts M into about ``_WARPS_PER_SM * n_sms``
    segment warps over the ``ceil(R / 32)`` replica groups."""
    nseg = max(1, _WARPS_PER_SM * n_sms // -(-R // 32))
    return 4 * -(-M // (4 * nseg))


def wide_segment_length(M: int, R: int, n_sms: int) -> int:
    """Slots of one segment of the wide variant's walk: a multiple of 4 that
    cuts M into ``n_sms // ceil(R / 32)`` segments (at least one), so that
    the one-warp CTAs, one an SM (a carry takes more than half of its shared
    memory), fill the card in one wave. More segments would not run at once
    and would add an N-bit vector each to the scratch (on an H100 at 9f's
    call, 132 segments ran fastest of 33, 66, 132 and 264)."""
    nseg = max(1, n_sms // -(-R // 32))
    return 4 * -(-M // (4 * nseg))


def global_segment_length(M: int, R: int, N: int, n_sms: int) -> int:
    """Slots of one segment of the global variant: about ``_WARPS_PER_SM *
    n_sms`` warps of threads, one a (replica, segment), with the scratch of
    ``nseg + 1`` N-bit vectors a replica within :data:`GLOBAL_SCRATCH_BYTES`
    and at most 65,535 segments (a grid dimension)."""
    row = 4 * -(-N // 32) * R
    nseg = min(M, 65_535, -(-_WARPS_PER_SM * n_sms * 32 // R),
               GLOBAL_SCRATCH_BYTES // row - 1)
    return -(-M // max(1, nseg))


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
    variant that :func:`k2_variant` names for N: the shared kernel (counted
    in ``parity_bits.launches``), :func:`parity_bits_wide` or
    :func:`parity_bits_global`; or raises."""
    K, M, R = v_idx.shape
    N = state.shape[1]
    dev = state.device
    _build.check(state, "state", torch.bool, (R, N), dev)
    _build.check(v_idx, "v_idx", torch.int32, (K, M, R), dev)
    _build.check(tog, "tog", torch.bool, (K, M, R), dev)
    _build.check(vq, "vq", torch.int32, (K, M, R), dev)
    if not _build.use_kernel(dev):
        return parity_bits_plain(state, v_idx, tog, vq)
    variant = k2_variant(N)
    if variant == "wide":
        return parity_bits_wide(state, v_idx, tog, vq)
    if variant == "global":
        return parity_bits_global(state, v_idx, tog, vq)
    W = -(-N // 32)
    seg_len = segment_length(M, R, _build.sm_count(dev))
    nseg = -(-M // seg_len)
    # Rows 0..nseg-1: the segments' prefixes; row nseg: the packed state.
    seg = torch.empty((nseg + 1, W, R), dtype=torch.int32, device=dev)
    pb = torch.empty((K, M, R), dtype=torch.bool, device=dev)
    sb = torch.empty((K, M, R), dtype=torch.bool, device=dev)
    _build.launch("ising_parity_bits", state, v_idx, tog, vq, seg, pb, sb,
                  K, M, R, N, seg_len)
    parity_bits.launches += 1
    return pb, sb


def parity_bits_wide(state: torch.Tensor, v_idx: torch.Tensor, tog: torch.Tensor,
                     vq: torch.Tensor):
    """:func:`parity_bits` through the wide variant (``csrc/parity_bits.cu``:
    the segments' toggles by atomic XORs into a zeroed scratch, the prefix
    pass, a walk with one warp's carry a CTA fed by bulk copies, and the p=0
    spins gathered apart), for any N whose carry and ring a CTA's shared
    memory holds (up to 53,472 on an H100). A CPU tensor takes
    :func:`parity_bits_plain`; a CUDA tensor launches the variant (counted
    in ``parity_bits_wide.launches``) or raises, also for an N past that."""
    K, M, R = v_idx.shape
    N = state.shape[1]
    dev = state.device
    _build.check(state, "state", torch.bool, (R, N), dev)
    _build.check(v_idx, "v_idx", torch.int32, (K, M, R), dev)
    _build.check(tog, "tog", torch.bool, (K, M, R), dev)
    _build.check(vq, "vq", torch.int32, (K, M, R), dev)
    if not _build.use_kernel(dev):
        return parity_bits_plain(state, v_idx, tog, vq)
    if k2_variant(N) == "global":
        raise ValueError(f"N={N}: one warp's carry of {carry_bytes(N)} bytes and the ring "
                         f"of {WIDE_RING_BYTES} exceed a CTA's {MAX_SHARED_BYTES} bytes of "
                         f"shared memory; K2 takes its global variant")
    seg_len = wide_segment_length(M, R, _build.sm_count(dev))
    nseg = -(-M // seg_len)
    # Rows 0..nseg-1: the segments' toggles (XORed into zeros), then their
    # prefixes; row nseg: the packed state.
    seg = torch.zeros((nseg + 1, -(-N // 32), R), dtype=torch.int32, device=dev)
    pb = torch.empty((K, M, R), dtype=torch.bool, device=dev)
    sb = torch.empty((K, M, R), dtype=torch.bool, device=dev)
    _build.launch("ising_parity_bits_wide", state, v_idx, tog, vq, seg, pb, sb,
                  K, M, R, N, seg_len)
    parity_bits_wide.launches += 1
    return pb, sb


def parity_bits_global(state: torch.Tensor, v_idx: torch.Tensor, tog: torch.Tensor,
                       vq: torch.Tensor):
    """:func:`parity_bits` through the global-memory variant, for any N
    (:func:`parity_bits` takes it past what :func:`parity_bits_wide` holds).
    A CPU tensor takes :func:`parity_bits_plain`; a CUDA tensor launches
    ``csrc/parity_bits_global.cu`` (counted in
    ``parity_bits_global.launches``) or raises."""
    K, M, R = v_idx.shape
    N = state.shape[1]
    dev = state.device
    _build.check(state, "state", torch.bool, (R, N), dev)
    _build.check(v_idx, "v_idx", torch.int32, (K, M, R), dev)
    _build.check(tog, "tog", torch.bool, (K, M, R), dev)
    _build.check(vq, "vq", torch.int32, (K, M, R), dev)
    if not _build.use_kernel(dev):
        return parity_bits_plain(state, v_idx, tog, vq)
    seg_len = global_segment_length(M, R, N, _build.sm_count(dev))
    nseg = -(-M // seg_len)
    # Rows 0..nseg-1: the segments' carries, then prefixes; row nseg: the
    # packed state.
    seg = torch.zeros((nseg + 1, -(-N // 32), R), dtype=torch.int32, device=dev)
    pb = torch.empty((K, M, R), dtype=torch.bool, device=dev)
    sb = torch.empty((K, M, R), dtype=torch.bool, device=dev)
    _build.launch("ising_parity_bits_global", state, v_idx, tog, vq, seg, pb, sb,
                  K, M, R, N, seg_len)
    parity_bits_global.launches += 1
    return pb, sb


parity_bits.launches = 0
parity_bits_wide.launches = 0
parity_bits_global.launches = 0
