"""The plain PyTorch versions of the port's kernels (the CPU branch of each
wrapper) against the JAX package's Pallas kernels run in interpret mode:
exact, since all three are integer work or identical f32 comparisons."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isingmontecarlo_tpu.ops.diag_carry import carry_decisions as jax_carry
from isingmontecarlo_tpu.ops.parity_kernel import parity_bits as jax_parity
from isingmontecarlo_tpu.ops.take_kernel import take0 as jax_take0
from isingmontecarlo_tpu_torch import ops
from isingmontecarlo_tpu_torch.ops import _build
from isingmontecarlo_tpu_torch.ops.diag_carry import tie_heavy_carry_inputs

torch.set_num_threads(1)


@pytest.mark.parametrize(
    "C,E,R",
    [
        (7, 5, 3),        # heavy padding of every Pallas block
        (129, 200, 16),   # two 128-row digit planes
        (517, 300, 5),    # E < C, R not a multiple of anything
    ],
)
def test_take0_matches_pallas(C, E, R):
    rng = np.random.default_rng(C + E + R)
    table = rng.integers(0, min(C, 1 << 14), size=(C, R), dtype=np.int32)
    table[-1] = min(C, 1 << 14) - 1
    idx = rng.integers(0, C, size=(E, R), dtype=np.int32)
    idx[0] = C - 1  # the last row
    want = np.asarray(jax_take0(jnp.asarray(table), jnp.asarray(idx), interpret=True))
    got = ops.take0(torch.from_numpy(table), torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), want)
    assert ops.take0.launches == 0  # a CPU tensor never launches the kernel


def _parity_inputs(rng, K, M, R, N):
    """Random legs with ~20% sentinels; the K legs of a slot name different
    variables, as every bond does."""
    if K == 2:
        v0 = rng.integers(0, N, size=(M, R))
        v1 = (v0 + 1 + rng.integers(0, N - 1, size=(M, R))) % N
        v_idx = np.stack([v0, v1]).astype(np.int32)
    else:
        v_idx = np.argsort(rng.random((M, R, N)), axis=-1)[..., :K]
        v_idx = np.ascontiguousarray(np.moveaxis(v_idx, -1, 0)).astype(np.int32)
    vq = rng.integers(0, N, size=(K, M, R)).astype(np.int32)
    v_idx[rng.random((K, M, R)) < 0.2] = N
    vq[rng.random((K, M, R)) < 0.2] = N + 3
    tog = rng.random((K, M, R)) < 0.4
    state = rng.random((R, N)) < 0.5
    return state, v_idx, tog, vq


@pytest.mark.parametrize(
    "M,R,N",
    [
        (700, 8, 9),     # odd N, M past one 512-row block and not a multiple
        (130, 5, 37),    # N spans three 16-bit words, R odd
        (512, 16, 16),   # exactly one block and one word
    ],
)
def test_parity_bits_matches_pallas(M, R, N):
    K = 2
    rng = np.random.default_rng(M * 7 + N)
    state, v_idx, tog, vq = _parity_inputs(rng, K, M, R, N)
    W = -(-N // 16)
    sent = 16 * W  # the Pallas kernel's sentinel
    st_pad = np.zeros((R, sent), np.int64)
    st_pad[:, :N] = state
    state_w = (st_pad.reshape(R, W, 16) << np.arange(16)).sum(-1).astype(np.int32)
    pb_j, sb_j = jax_parity(
        jnp.zeros((R, W), jnp.int32), jnp.asarray(state_w),
        jnp.asarray(np.where(v_idx >= N, sent, v_idx)), jnp.asarray(tog),
        jnp.asarray(np.where(vq >= N, sent, vq)), interpret=True,
    )
    pb, sb = ops.parity_bits(torch.from_numpy(state), torch.from_numpy(v_idx),
                             torch.from_numpy(tog), torch.from_numpy(vq))
    np.testing.assert_array_equal(pb.numpy(), np.asarray(pb_j))
    np.testing.assert_array_equal(sb.numpy(), np.asarray(sb_j))


def _jax_parity(state, v_idx, tog, vq):
    """The Pallas ``parity_bits`` in interpret mode on the port's inputs:
    the state packed 16 bits a word, sentinels moved to 16 * W."""
    R, N = state.shape
    W = -(-N // 16)
    sent = 16 * W  # the Pallas kernel's sentinel
    st_pad = np.zeros((R, sent), np.int64)
    st_pad[:, :N] = state
    state_w = (st_pad.reshape(R, W, 16) << np.arange(16)).sum(-1).astype(np.int32)
    pb, sb = jax_parity(
        jnp.zeros((R, W), jnp.int32), jnp.asarray(state_w),
        jnp.asarray(np.where(v_idx >= N, sent, v_idx)), jnp.asarray(tog),
        jnp.asarray(np.where(vq >= N, sent, vq)), interpret=True,
    )
    return np.asarray(pb), np.asarray(sb)


@pytest.mark.parametrize("K,M,R,N", [(1, 70, 3, 5), (3, 70, 4, 21), (5, 66, 3, 18)])
def test_parity_bits_plain_matches_pallas_at_any_k(K, M, R, N):
    """One leg, three (a plaquette's variables) and five (more than the
    earlier kernel took): the plain version equals the Pallas kernel."""
    rng = np.random.default_rng(K * 100 + M)
    state, v_idx, tog, vq = _parity_inputs(rng, K, M, R, N)
    pb_j, sb_j = _jax_parity(state, v_idx, tog, vq)
    pb, sb = ops.parity_bits_plain(torch.from_numpy(state), torch.from_numpy(v_idx),
                                   torch.from_numpy(tog), torch.from_numpy(vq))
    np.testing.assert_array_equal(pb.numpy(), pb_j)
    np.testing.assert_array_equal(sb.numpy(), sb_j)


@pytest.mark.parametrize("K", [1, 4, 5, 8])
def test_parity_kernel_takes_any_k_before_launch(monkeypatch, K):
    """Where the kernel would run, any K reaches the launch, with a scratch
    of (segments + 1) N-bit vectors a replica and a segment length that is
    a multiple of 4 and cuts M into about _WARPS_PER_SM warps an SM; an N whose carry
    no CTA's shared memory holds goes to the global-memory variant, counted
    there and not here. (The wrapper is made to take its kernel branch for
    CPU tensors; nothing is launched.)"""
    from isingmontecarlo_tpu_torch.ops import parity_kernel

    calls = []
    monkeypatch.setattr(ops.parity_bits, "launches", 0)
    monkeypatch.setattr(ops.parity_bits_global, "launches", 0)
    monkeypatch.setattr(_build, "use_kernel", lambda dev: True)
    monkeypatch.setattr(_build, "launch", lambda name, *args: calls.append((name, args)))
    monkeypatch.setattr(_build, "sm_count", lambda dev: 132)
    M, R, N = 7000, 256, 1024
    args = [torch.from_numpy(a) for a in _parity_inputs(np.random.default_rng(K), K, 8, 3, 9)]
    ops.parity_bits(*args)
    big = (torch.zeros((R, N), dtype=torch.bool), torch.zeros((K, M, R), dtype=torch.int32),
           torch.zeros((K, M, R), dtype=torch.bool), torch.zeros((K, M, R), dtype=torch.int32))
    ops.parity_bits(*big)
    (name, small), (_, full) = calls
    assert name == "ising_parity_bits" and small[-5:] == (K, 8, 3, 9, 4)
    seg_len = full[-1]
    nseg = -(-M // seg_len)
    assert full[-5:-1] == (K, M, R, N) and seg_len % 4 == 0
    assert full[4].shape == (nseg + 1, N // 32, R)
    warps = parity_kernel._WARPS_PER_SM * 132
    assert 0.85 * warps <= nseg * R // 32 <= warps  # segment warps
    assert parity_kernel.segment_length(M, R, 132) == seg_len
    ops.parity_bits(torch.zeros((1, 30000), dtype=torch.bool),
                    *(torch.zeros((K, 4, 1), dtype=d) for d in
                      (torch.int32, torch.bool, torch.int32)))
    assert [c[0] for c in calls] == ["ising_parity_bits"] * 2 + ["ising_parity_bits_global"]
    assert calls[2][1][-5:-1] == (K, 4, 1, 30000)
    assert (ops.parity_bits.launches, ops.parity_bits_global.launches) == (2, 1)


@pytest.mark.parametrize("N,variant", [
    (1, "shared"), (1024, "shared"), (29_056, "shared"), (29_057, "global"),
    (36_864, "global"), (10**6, "global"),
])
def test_k2_variant_at_the_shared_memory_limit(N, variant):
    """K2 keeps two warps' N-bit carries in a CTA's 232,448 bytes of shared
    memory up to N = 29,056 (908 words a lane); past it, the global-memory
    variant takes any N. A smaller budget moves the limit with it."""
    from isingmontecarlo_tpu_torch.ops import parity_kernel

    assert parity_kernel.k2_variant(N) == variant
    assert parity_kernel.k2_variant(N, 2 * 32 * 4 * -(-N // 32)) == "shared"
    assert parity_kernel.k2_variant(N, 2 * 32 * 4 * -(-N // 32) - 1) == "global"


@pytest.mark.parametrize("M,R,N", [(7000, 64, 36_864), (25_000, 32, 36_864),
                                   (5, 3, 40_000), (100_000, 1, 30_000), (3000, 256, 10**6)])
def test_parity_bits_global_scratch_and_segments(monkeypatch, M, R, N):
    """The global variant's wrapper: no limit on N; a zeroed scratch of
    (segments + 1) N-bit vectors a replica, within GLOBAL_SCRATCH_BYTES
    where two rows fit, about _WARPS_PER_SM warps of threads an SM, at most
    65,535 segments, every slot in a segment. (The kernel branch on CPU
    tensors; nothing is launched.)"""
    from isingmontecarlo_tpu_torch.ops import parity_kernel

    calls = []
    monkeypatch.setattr(ops.parity_bits_global, "launches", 0)
    monkeypatch.setattr(_build, "use_kernel", lambda dev: True)
    monkeypatch.setattr(_build, "launch", lambda name, *args: calls.append((name, args)))
    monkeypatch.setattr(_build, "sm_count", lambda dev: 132)
    K = 2
    ops.parity_bits(torch.zeros((R, N), dtype=torch.bool),
                    torch.zeros((K, M, R), dtype=torch.int32),
                    torch.zeros((K, M, R), dtype=torch.bool),
                    torch.zeros((K, M, R), dtype=torch.int32))
    ((name, args),) = calls
    assert name == "ising_parity_bits_global" and ops.parity_bits_global.launches == 1
    seg_len = args[-1]
    nseg = -(-M // seg_len)
    assert args[-5:-1] == (K, M, R, N) and nseg <= 65_535 and (nseg - 1) * seg_len < M
    seg = args[4]
    W = -(-N // 32)
    assert seg.shape == (nseg + 1, W, R) and not seg.any()
    row = 4 * W * R
    assert seg.numel() * 4 <= max(parity_kernel.GLOBAL_SCRATCH_BYTES, 2 * row)
    assert nseg * R <= parity_kernel._WARPS_PER_SM * 132 * 32 + R


@pytest.mark.cuda
def test_cuda_parity_bits_equals_plain():
    """K2 on the card against its plain version at K = 1..6, at ragged
    shapes (R not a multiple of 4 or 32, M not a multiple of 4, N not a
    multiple of 32, one segment and many) with sentinels, and at the 32x32
    shape."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc")
    for K in range(1, 7):
        for M, R, N in ((37, 5, 9), (301, 48, 40), (130, 33, 37), (7, 1, 6), (1000, 64, 70)):
            args = [torch.from_numpy(a).cuda() for a in
                    _parity_inputs(np.random.default_rng(K * M + R), K, M, R, N)]
            before = ops.parity_bits.launches
            got = ops.parity_bits(*args)
            torch.cuda.synchronize()
            assert ops.parity_bits.launches == before + 1
            for g, w in zip(got, ops.parity_bits_plain(*args)):
                assert torch.equal(g, w), (K, M, R, N)
    args = [torch.from_numpy(a).cuda() for a in
            _parity_inputs(np.random.default_rng(0), 2, 7000, 256, 1024)]
    for g, w in zip(ops.parity_bits(*args), ops.parity_bits_plain(*args)):
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_cuda_parity_bits_global_equals_plain():
    """K2's global-memory variant on the card against the plain version at
    K = 1..6 on ragged shapes (called directly, at small N), and through
    ``parity_bits`` past the shared-memory limit (N = 29,057 and 36,864),
    where only the global variant launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc")
    for K in range(1, 7):
        for M, R, N in ((37, 5, 9), (301, 48, 40), (130, 33, 37), (7, 1, 6), (1000, 64, 70)):
            args = [torch.from_numpy(a).cuda() for a in
                    _parity_inputs(np.random.default_rng(K * M + R), K, M, R, N)]
            for g, w in zip(ops.parity_bits_global(*args), ops.parity_bits_plain(*args)):
                assert torch.equal(g, w), (K, M, R, N)
    for K, M, R, N in ((2, 300, 7, 29_057), (2, 2000, 64, 36_864)):
        args = [torch.from_numpy(a).cuda() for a in
                _parity_inputs(np.random.default_rng(N), K, M, R, N)]
        before = ops.parity_bits.launches, ops.parity_bits_global.launches
        got = ops.parity_bits(*args)
        torch.cuda.synchronize()
        assert (ops.parity_bits.launches, ops.parity_bits_global.launches) == (
            before[0], before[1] + 1)
        for g, w in zip(got, ops.parity_bits_plain(*args)):
            assert torch.equal(g, w), (K, M, R, N)


def test_parity_bits_plain_chunks_thread_the_carry(monkeypatch):
    """Forcing many M-chunks (the main-path shape needs ~28) leaves the
    plain version's output unchanged: the XOR carry threads them."""
    from isingmontecarlo_tpu_torch.ops import parity_kernel

    rng = np.random.default_rng(5)
    args = [torch.from_numpy(a) for a in _parity_inputs(rng, 2, 300, 4, 11)]
    want = parity_kernel.parity_bits_plain(*args)
    monkeypatch.setattr(parity_kernel, "_PLAIN_CHUNK_ELEMS", 7 * 4 * 12)
    got = parity_kernel.parity_bits_plain(*args)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _carry_inputs(M, R, seed):
    rng = np.random.default_rng(seed)
    n0 = rng.integers(0, M // 2, size=R).astype(np.int32)
    u0 = rng.random((M, R), dtype=np.float32)
    idp = rng.random((M, R)) < 0.5
    dgp = ~idp & (rng.random((M, R)) < 0.8)
    # Numerators on the scale of M - n, so both outcomes occur.
    num_ins = rng.uniform(0, M, (M, R)).astype(np.float32)
    num_rem = rng.uniform(0, 2 * M, (M, R)).astype(np.float32)
    return n0, u0, idp, dgp, num_ins, num_rem


@pytest.mark.parametrize("M,R,ties", [
    pytest.param(700, 5, False, id="700-5"),
    pytest.param(200, 16, False, id="200-16"),
    # Slots on the comparisons' edge (exact ties), R a multiple of neither
    # 16 nor 32, M not of the kernel's 64-slot tile.
    pytest.param(300, 7, True, id="ties-300-7"),
])
def test_carry_decisions_matches_pallas(M, R, ties):
    n0, u0, idp, dgp, num_ins, num_rem = (
        tie_heavy_carry_inputs(M, R, M + R) if ties else _carry_inputs(M, R, M + R))
    ins_j, rem_j = jax_carry(
        jnp.asarray(n0), jnp.asarray(u0), jnp.asarray(idp), jnp.asarray(dgp),
        jnp.asarray(num_ins), jnp.asarray(num_rem), jnp.zeros((R,), jnp.float32),
        M=M, heatbath=False, interpret=True,
    )
    t = torch.from_numpy
    ins, rem = ops.carry_decisions(t(n0), t(u0), t(idp), t(dgp), t(num_ins), t(num_rem))
    np.testing.assert_array_equal(ins.numpy(), np.asarray(ins_j))
    np.testing.assert_array_equal(rem.numpy(), np.asarray(rem_j))
    assert ins.any() and rem.any()


@pytest.mark.cuda
def test_cuda_carry_metropolis_equals_plain():
    """K3 against its plain version on the card: R a multiple of neither 32
    nor 16 and M of no 64-slot tile; R a multiple of 16 but not of 32 (the
    last CTA half full); planes off 16-byte alignment (the element-wise
    path); random and tie-heavy inputs. M >= 2^24 is refused before any
    launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc")
    for M, R in ((37, 5), (300, 48), (700, 64), (1000, 100)):
        for args in (_carry_inputs(M, R, 1), tie_heavy_carry_inputs(M, R, 2)):
            args = [torch.from_numpy(a).cuda() for a in args]
            before = ops.carry_decisions.launches
            got = ops.carry_decisions(*args)
            want = ops.carry_decisions_plain(*args)
            torch.cuda.synchronize()
            assert ops.carry_decisions.launches == before + 1
            for g, w in zip(got, want):
                assert torch.equal(g, w)
    args = [torch.from_numpy(a).cuda() for a in tie_heavy_carry_inputs(300, 64, 3)]
    shifted = []
    for a in args:  # every [M, R] plane one element past a 16-byte boundary
        if a.dim() == 2:
            buf = torch.empty(a.numel() + 1, dtype=a.dtype, device=a.device)
            a = buf[1:].view(a.shape).copy_(a)
        shifted.append(a)
    for g, w in zip(ops.carry_decisions(*shifted), ops.carry_decisions_plain(*args)):
        assert torch.equal(g, w)
    big = [torch.empty(s, dtype=d, device="cuda") for s, d in (
        ((1,), torch.int32), ((2**24, 1), torch.float32), ((2**24, 1), torch.bool),
        ((2**24, 1), torch.bool), ((2**24, 1), torch.float32), ((2**24, 1), torch.float32))]
    before = ops.carry_decisions.launches
    with pytest.raises(ValueError, match="2\\^24"):
        ops.carry_decisions(*big)
    assert ops.carry_decisions.launches == before


@pytest.mark.parametrize("heatbath", [False, True])
def test_carry_kernels_refuse_m_of_2_to_24_before_launch(monkeypatch, heatbath):
    """Where the kernel would run, M >= 2^24 raises before any launch: the
    float carry of M - n would no longer be exact. (The wrapper is made to
    take its kernel branch for CPU tensors; nothing is launched.)"""
    def no_launch(*args):
        raise AssertionError("launched")

    monkeypatch.setattr(_build, "use_kernel", lambda dev: True)
    monkeypatch.setattr(_build, "launch", no_launch)
    M, R = 2**24, 1
    n0 = torch.zeros(R, dtype=torch.int32)
    u0 = torch.empty((M, R), dtype=torch.float32)
    mask = torch.empty((M, R), dtype=torch.bool)
    if heatbath:
        call = lambda: ops.carry_decisions_heatbath(n0, u0, mask, mask, mask,  # noqa: E731
                                                    torch.zeros(R))
    else:
        call = lambda: ops.carry_decisions(n0, u0, mask, mask, u0, u0)  # noqa: E731
    with pytest.raises(ValueError, match="2\\^24"):
        call()


def test_wrappers_check_inputs_and_devices():
    t = torch.zeros((4, 3), dtype=torch.int32)
    with pytest.raises(TypeError):
        ops.take0(t.to(torch.int64), t)
    with pytest.raises(ValueError):
        ops.take0(t, torch.zeros((4, 2), dtype=torch.int32))
    with pytest.raises(ValueError):
        ops.take0(t, torch.zeros((3, 4), dtype=torch.int32).T)  # not contiguous
    with pytest.raises(ValueError, match="no kernel"):
        ops.take0(t.to("meta"), t.to("meta"))
    ops.reset_launch_counts()
    assert ops.launch_counts() == {"checkerboard_multi_sweep": 0,
                                   "checkerboard_multi_sweep_global": 0, "parity_bits": 0,
                                   "parity_bits_global": 0, "carry_decisions": 0,
                                   "carry_decisions_heatbath": 0, "take0": 0, "hook_min": 0,
                                   "pointer_jump": 0}
