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
    """Random legs with ~20% sentinels; the two legs of a slot name
    different variables, as every bond does."""
    v0 = rng.integers(0, N, size=(M, R))
    v1 = (v0 + 1 + rng.integers(0, N - 1, size=(M, R))) % N
    v_idx = np.stack([v0, v1]).astype(np.int32)
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


@pytest.mark.parametrize("M,R", [(700, 5), (200, 16)])
def test_carry_decisions_matches_pallas(M, R):
    rng = np.random.default_rng(M + R)
    n0 = rng.integers(0, M // 2, size=R).astype(np.int32)
    u0 = rng.random((M, R), dtype=np.float32)
    idp = rng.random((M, R)) < 0.5
    dgp = ~idp & (rng.random((M, R)) < 0.8)
    # Numerators on the scale of M - n, so both outcomes occur.
    num_ins = rng.uniform(0, M, (M, R)).astype(np.float32)
    num_rem = rng.uniform(0, 2 * M, (M, R)).astype(np.float32)
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
    assert ops.launch_counts() == {"checkerboard_multi_sweep": 0, "parity_bits": 0,
                                   "carry_decisions": 0, "carry_decisions_heatbath": 0,
                                   "take0": 0, "hook_min": 0, "pointer_jump": 0}
