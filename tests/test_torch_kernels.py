"""The plain PyTorch versions of the port's kernels (the CPU branch of each
wrapper) against the JAX package's Pallas kernels run in interpret mode:
exact, since all three are integer work or identical f32 comparisons. K2's
plain version also against a slot-by-slot oracle and JAX's XLA path on
slots that name one variable on several toggled legs; the wrappers'
dispatch and launch geometry with the kernel branch forced and nothing
launched; and, on a card only, each kernel against its plain version."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_utils import assert_ops_equal, t_, torch_model, torch_sse

from isingmontecarlo_tpu.ops.diag_carry import carry_decisions as jax_carry
from isingmontecarlo_tpu.ops.parity_kernel import parity_bits as jax_parity
from isingmontecarlo_tpu.ops.take_kernel import take0 as jax_take0
from isingmontecarlo_tpu.sse import diagonal as jdiag
from isingmontecarlo_tpu.sse import model as jmodel
from isingmontecarlo_tpu.sse import opstring as jops
from isingmontecarlo_tpu_torch import ops
from isingmontecarlo_tpu_torch.ops import _build
from isingmontecarlo_tpu_torch.ops.diag_carry import tie_heavy_carry_inputs
from isingmontecarlo_tpu_torch.sse import diagonal as tdiag
from isingmontecarlo_tpu_torch.sse import opstring as tops

from torch_port_utils import release_jax_executables  # noqa: F401  (autouse)

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


def _repeated_leg_inputs(rng, K, M, R, N):
    """:func:`_parity_inputs` with slots that name one variable on two
    toggled legs (a fifth of them: leg 1 = leg 0) and, at K >= 3, on three
    (a tenth: legs 1 and 2 = leg 0) and on the first and last leg (a
    tenth)."""
    state, v_idx, tog, vq = _parity_inputs(rng, K, M, R, N)
    for legs, frac in (([1], 0.2), ([1, 2], 0.1), ([K - 1], 0.1)):
        if max(legs) >= K:
            continue
        m = rng.random((M, R)) < frac
        for leg in legs:
            v_idx[leg][m] = v_idx[0][m]
            tog[leg][m] = True
        tog[0][m] = True
    return state, v_idx, tog, vq


def _parity_oracle(state, v_idx, tog, vq):
    """K2 by its definition, slot by slot: each proposal leg reads the
    parity of the earlier slots' flips of its variable and its p=0 spin,
    then the slot flips each variable that some toggled leg names, once (a
    slot's legs act as a set)."""
    K, M, R = v_idx.shape
    N = state.shape[1]
    pb = np.zeros((K, M, R), bool)
    sb = np.zeros((K, M, R), bool)
    for r in range(R):
        carry = np.zeros(N, bool)
        for p in range(M):
            for k in range(K):
                q = vq[k, p, r]
                if 0 <= q < N:
                    pb[k, p, r], sb[k, p, r] = carry[q], state[r, q]
            for v in {int(v_idx[k, p, r]) for k in range(K) if tog[k, p, r]}:
                if 0 <= v < N:
                    carry[v] ^= True
    return pb, sb


def test_parity_bits_plain_takes_a_slots_legs_as_a_set():
    """Slots that name one variable on two and on three toggled legs flip
    it once: at each (K, M, R, N) the plain version equals the slot-by-slot
    oracle of the set semantics (an XOR of each leg's bit would cancel two
    toggles)."""
    for K, M, R, N in ((2, 40, 5, 7), (3, 33, 4, 5), (5, 20, 3, 9)):
        rng = np.random.default_rng(K * 1000 + M)
        state, v_idx, tog, vq = _repeated_leg_inputs(rng, K, M, R, N)
        twice = (v_idx[0] == v_idx[1]) & tog[0] & tog[1] & (v_idx[0] < N)
        assert twice.sum() >= 10, K
        if K >= 3:
            assert ((v_idx[0] == v_idx[1]) & (v_idx[1] == v_idx[2]) & tog[:3].all(0)
                    & (v_idx[0] < N)).sum() >= 3, K
        pb, sb = ops.parity_bits_plain(*(torch.from_numpy(a) for a in (state, v_idx, tog, vq)))
        pb_o, sb_o = _parity_oracle(state, v_idx, tog, vq)
        np.testing.assert_array_equal(pb.numpy(), pb_o, err_msg=f"K={K}")
        np.testing.assert_array_equal(sb.numpy(), sb_o, err_msg=f"K={K}")


# Generic models with a bond that names variable 0 on every leg and (K=3)
# one on [0, 0, 1] (every element of their matrices positive, so their ops
# may toggle both or all three legs), beside diagonal bonds that read
# variable 0's spin between such ops.
_OFF2 = np.full((4, 4), 0.5) + np.eye(4)
_OFF3 = np.full((8, 8), 0.5) + np.eye(8)
_DIAG2 = np.array([1.5, 0.25, 0.5, 1.0])
_DIAG3 = np.array([1.5, 0.5, 1.0, 0.25, 0.25, 1.0, 0.5, 1.5])
_REPEATED_MODELS = {
    2: [(_OFF2, [0, 0]), (_DIAG2, [0, 1]), (_DIAG2, [1, 2]), (_DIAG2, [2, 0]),
        (np.full((2, 2), 0.7), [1])],
    3: [(_OFF3, [0, 0, 0]), (_OFF3, [0, 0, 1]), (_DIAG3, [0, 1, 2]), (_DIAG2, [1, 2]),
        (_DIAG2, [0, 2])],
}


def _repeated_leg_string(K, M, R, seed):
    """Per replica: the p=0 state and an op string that flips variable 0 at
    two slots: ``[a]*K -> [b]*K`` on bond 0 (variable 0 on all K legs), and
    back on bond 0 (K=2) or on bond 1 (K=3: ``[b, b, c] -> [a, a, c]``, two
    toggled legs on variable 0, whose two toggles an XOR of the legs would
    cancel, while three would not), with diagonal ops of the other bonds
    between and around them on the propagated spins."""
    rng = np.random.default_rng(seed)
    jm = jmodel.generic_model(3, _REPEATED_MODELS[K])
    bv = np.asarray(jm.bond_vars)
    states = rng.random((R, 3)) < 0.5
    strings = []
    for r in range(R):
        s = states[r].copy()
        p1, p2 = sorted(rng.choice(np.arange(2, M - 2), 2, replace=False))
        ops_r = []
        for p in range(M):
            if p == p2 and K == 3:
                ops_r.append((p, 1, [s[0], s[0], s[1]], [not s[0], not s[0], s[1]]))
                s[0] = not s[0]
            elif p in (p1, p2):
                ops_r.append((p, 0, [s[0]] * K, [not s[0]] * K))
                s[0] = not s[0]
            elif rng.random() < 0.4:
                b = int(rng.integers(1, jm.nbonds))
                vars_b = [int(v) for v in bv[b] if v >= 0]
                spins = [bool(s[v]) for v in vars_b]
                ops_r.append((p, b, spins, spins))
        strings.append(ops_r)
    return jm, states, strings


@pytest.mark.parametrize("K", [2, 3])
def test_parity_bits_plain_matches_jax_xla_on_repeated_legs(K):
    """The flip-parity scan on strings whose ops toggle one variable on two
    (K=2) or three (K=3) legs: the port's ``_parallel_weights`` (through
    ``parity_bits``, the plain version on the CPU) gives the proposal leg
    spins of the JAX package's XLA path (its unpacked branch, ``.max`` of
    the toggles, ``isingmontecarlo_tpu/sse/diagonal.py:378-396``) on the
    same proposal uniforms; and the plain version equals the set oracle on
    the same K2 inputs."""
    M, R = 24, 8
    jm, states, strings = _repeated_leg_string(K, M, R, seed=K)
    jo = jops.new_from_ops(M, strings, replicas=R, max_legs=K)
    u1 = np.random.default_rng(K + 10).random((M, R), dtype=np.float32)
    _, bits_j, _, _ = jdiag._parallel_weights(jo, jnp.asarray(states), jnp.asarray(u1), jm,
                                              None, False)
    tm = torch_model(jm)
    to = tops.new_from_ops(M, strings, replicas=R, max_legs=K, device="cpu")
    b_new, bits_t, _, _ = tdiag._parallel_weights(to, torch.from_numpy(states),
                                                  torch.from_numpy(u1), tm)
    np.testing.assert_array_equal(bits_t.numpy(), np.asarray(bits_j))

    N = jm.nvars
    bv = np.where(np.asarray(jm.bond_vars) >= 0, np.asarray(jm.bond_vars), N)
    v_idx = np.ascontiguousarray(np.moveaxis(bv[np.maximum(np.asarray(jo.bond), 0)], -1, 0))
    vq = np.ascontiguousarray(np.moveaxis(bv[b_new.numpy()], -1, 0))
    tog = np.asarray(jo.inputs) != np.asarray(jo.outputs)
    assert ((v_idx[:2] == 0) & tog[:2]).all(0).any()  # slots toggling variable 0 twice
    pb, sb = ops.parity_bits_plain(*(torch.from_numpy(a) for a in (states, v_idx, tog, vq)))
    pb_o, sb_o = _parity_oracle(states, v_idx, tog, vq)
    np.testing.assert_array_equal(pb.numpy(), pb_o)
    np.testing.assert_array_equal(sb.numpy(), sb_o)


@pytest.mark.parametrize("K", [2, 3])
def test_diagonal_update_on_a_repeated_variable_bond_matches_jax(K):
    """A whole Metropolis diagonal update on a generic model whose bond 0
    names variable 0 on every leg, over strings holding ``[a]*K -> [b]*K``
    ops of that bond: the port's update (K2's plain version on the CPU) and
    JAX's ``_diagonal_update_fast`` on JAX's uniforms give equal op
    strings, and the strings still verify."""
    M, R, beta = 24, 8, 1.5
    jm, states, strings = _repeated_leg_string(K, M, R, seed=K + 20)
    jo = jops.new_from_ops(M, strings, replicas=R, max_legs=K)
    assert np.asarray(jops.verify(jo, jnp.asarray(states), jm)).all()
    key = jax.random.key(K + 30)
    want = jdiag._diagonal_update_fast(jo, jnp.asarray(states), jnp.float32(beta), key, jm)
    tm = torch_model(jm)
    sse = torch_sse(jo, states)
    got = tdiag.diagonal_update(sse.ops, sse.state, beta,
                                t_(jax.random.uniform(key, (3, M, R))), tm)
    assert_ops_equal(got, want)
    assert not np.array_equal(np.asarray(want.bond), np.asarray(jo.bond))
    assert bool(tops.verify(got, sse.state, tm).all())


@pytest.mark.parametrize("K", [1, 4, 5, 8])
def test_parity_kernel_takes_any_k_before_launch(monkeypatch, K):
    """Where the kernel would run, any K reaches the launch, with a scratch
    of (segments + 1) N-bit vectors a replica and a segment length that is
    a multiple of 4 and cuts M into about _WARPS_PER_SM warps an SM; an N whose
    two carries no CTA's shared memory holds goes to the wide variant, and
    one past what one carry allows to the global-memory variant, each counted
    there and not here. (The wrapper is made to take its kernel branch for
    CPU tensors; nothing is launched.)"""
    from isingmontecarlo_tpu_torch.ops import parity_kernel

    calls = []
    monkeypatch.setattr(ops.parity_bits, "launches", 0)
    monkeypatch.setattr(ops.parity_bits_wide, "launches", 0)
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
    for n in (30000, 60000):
        ops.parity_bits(torch.zeros((1, n), dtype=torch.bool),
                        *(torch.zeros((K, 4, 1), dtype=d) for d in
                          (torch.int32, torch.bool, torch.int32)))
    assert [c[0] for c in calls] == (["ising_parity_bits"] * 2 + ["ising_parity_bits_wide",
                                                                  "ising_parity_bits_global"])
    assert calls[2][1][-5:-1] == (K, 4, 1, 30000) and calls[3][1][-5:-1] == (K, 4, 1, 60000)
    assert (ops.parity_bits.launches, ops.parity_bits_wide.launches,
            ops.parity_bits_global.launches) == (2, 1, 1)


@pytest.mark.parametrize("N,variant", [
    (1, "shared"), (1024, "shared"), (29_056, "shared"), (29_057, "wide"),
    (30_976, "wide"), (32_767, "wide"), (36_864, "wide"), (53_472, "wide"),
    (53_473, "global"), (10**6, "global"),
])
def test_k2_variant_at_the_shared_memory_limit(N, variant):
    """K2 keeps two N-bit vectors of 32 replicas (the carry and the packed
    state) in a CTA's 232,448 bytes of shared memory up to N = 29,056 (908
    words a lane); the wide variant keeps one and two stages of its ring of
    slots up to N = 53,472 (1,671 words), past every N an SSE model's int32
    leg key admits (N < 32,768); past it, the global-memory variant takes
    any N. A smaller budget moves both limits with it."""
    from isingmontecarlo_tpu_torch.ops import parity_kernel

    carry = 32 * 4 * -(-N // 32)
    ring = parity_kernel.WIDE_RING_BYTES
    assert parity_kernel.carry_bytes(N) == carry and ring == 18_456
    assert parity_kernel.k2_variant(N) == variant
    assert parity_kernel.k2_variant(N, 2 * carry) == "shared"
    assert parity_kernel.k2_variant(N, min(2 * carry, carry + ring) - 1) == "global"
    if carry > ring:  # a budget that holds one carry and the ring but not two carries
        assert parity_kernel.k2_variant(N, carry + ring) == "wide"


@pytest.mark.parametrize("M,R,N", [(7000, 64, 36_864), (25_000, 32, 36_864),
                                   (5, 3, 40_000), (100_000, 1, 30_000), (3000, 256, 10**6)])
def test_parity_bits_global_scratch_and_segments(monkeypatch, M, R, N):
    """The global variant's wrapper, called directly (``parity_bits`` sends
    it only the N past the wide variant): no limit on N; a zeroed scratch of
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
    ops.parity_bits_global(torch.zeros((R, N), dtype=torch.bool),
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


_WIDE_CALLS = (
    (30_976, 32, 30_976, 132),  # 9f's call: one replica group, a segment an SM
    (7000, 64, 36_864, 132),    # two groups of 66 segments
    (7000, 200, 29_057, 132),   # R not a multiple of 32: 7 groups
    (5, 3, 53_472, 132),        # fewer slots than segments: one slot's worth each
    (1000, 8192, 40_000, 132),  # more groups than SMs: a segment a group, in waves
    (30_000, 32, 32_767, 16),   # another card
)


def test_parity_bits_wide_scratch_and_segments(monkeypatch):
    """The wide variant's wrapper, through ``parity_bits``, at each of
    ``_WIDE_CALLS`` (M, R, N, SMs): a zeroed scratch of (segments + 1)
    N-bit vectors a replica (the toggles are XORed into it); segments of a
    multiple of 4 slots, every slot in one; one wave of one-warp CTAs
    (segments x replica groups at most the SMs) where the groups fit, else
    one segment a group. (The kernel branch on CPU tensors; nothing is
    launched.)"""
    from isingmontecarlo_tpu_torch.ops import parity_kernel

    calls = []
    monkeypatch.setattr(_build, "use_kernel", lambda dev: True)
    monkeypatch.setattr(_build, "launch", lambda name, *args: calls.append((name, args)))
    K = 2
    for case in _WIDE_CALLS:
        M, R, N, n_sms = case
        calls.clear()
        monkeypatch.setattr(ops.parity_bits_wide, "launches", 0)
        monkeypatch.setattr(_build, "sm_count", lambda dev, n=n_sms: n)
        ops.parity_bits(torch.zeros((R, N), dtype=torch.bool),
                        torch.zeros((K, M, R), dtype=torch.int32),
                        torch.zeros((K, M, R), dtype=torch.bool),
                        torch.zeros((K, M, R), dtype=torch.int32))
        ((name, args),) = calls
        assert name == "ising_parity_bits_wide" and ops.parity_bits_wide.launches == 1, case
        seg_len = args[-1]
        nseg = -(-M // seg_len)
        groups = -(-R // 32)
        assert args[-5:-1] == (K, M, R, N) and seg_len % 4 == 0, case
        assert (nseg - 1) * seg_len < M, case
        assert args[4].shape == (nseg + 1, -(-N // 32), R) and not args[4].any(), case
        assert nseg == 1 if groups >= n_sms else nseg * groups <= n_sms, case
        assert seg_len == parity_kernel.wide_segment_length(M, R, n_sms), case
        target = max(1, n_sms // groups)
        # As many segments a group as the SMs take, less what rounding the
        # segment up to a multiple of 4 slots costs.
        assert nseg >= min(target, -(-M // 4)) * M / (M + 4 * target), case
        with pytest.raises(ValueError, match="global variant"):
            ops.parity_bits_wide(torch.zeros((1, 53_473), dtype=torch.bool),
                                 *(torch.zeros((K, 4, 1), dtype=d) for d in
                                   (torch.int32, torch.bool, torch.int32)))


_RAGGED_K2 = ((37, 5, 9), (301, 48, 40), (130, 33, 37), (7, 1, 6), (1000, 64, 70))


def _cuda_parity_equal(fn, K, M, R, N, seed):
    """``fn`` on the card equal to the plain version at (K, M, R, N), on
    distinct legs and on slots naming one variable on two and three toggled
    legs."""
    for make in (_parity_inputs, _repeated_leg_inputs):
        args = [torch.from_numpy(a).cuda() for a in make(np.random.default_rng(seed), K, M, R, N)]
        got = fn(*args)
        torch.cuda.synchronize()
        for g, w in zip(got, ops.parity_bits_plain(*args)):
            assert torch.equal(g, w), (fn.__name__, make.__name__, K, M, R, N)


@pytest.mark.cuda
def test_cuda_parity_bits_equals_plain():
    """K2 on the card against its plain version at K = 1..6, at ragged
    shapes (R not a multiple of 4 or 32, M not a multiple of 4, N not a
    multiple of 32, one segment and many) with sentinels, on distinct and
    on repeated toggled legs, and at the 32x32 shape."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc")
    for K in range(1, 7):
        for M, R, N in _RAGGED_K2:
            before = ops.parity_bits.launches
            _cuda_parity_equal(ops.parity_bits, K, M, R, N, K * M + R)
            assert ops.parity_bits.launches == before + 2
    args = [torch.from_numpy(a).cuda() for a in
            _parity_inputs(np.random.default_rng(0), 2, 7000, 256, 1024)]
    for g, w in zip(ops.parity_bits(*args), ops.parity_bits_plain(*args)):
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_cuda_parity_bits_global_equals_plain():
    """K2's global-memory variant on the card against the plain version at
    K = 1..6 on ragged shapes (called directly, at small N), on distinct and
    on repeated toggled legs, and through ``parity_bits`` past the wide
    variant's limit (N = 60,000), where only the global variant launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc")
    for K in range(1, 7):
        for M, R, N in _RAGGED_K2:
            _cuda_parity_equal(ops.parity_bits_global, K, M, R, N, K * M + R)
    before = ops.parity_bits_wide.launches, ops.parity_bits_global.launches
    _cuda_parity_equal(ops.parity_bits, 2, 300, 7, 60_000, 1)
    assert (ops.parity_bits_wide.launches, ops.parity_bits_global.launches) == (
        before[0], before[1] + 2)


@pytest.mark.cuda
def test_cuda_parity_bits_wide_equals_plain():
    """K2's wide variant on the card against the plain version at K = 1..6
    on ragged shapes (called directly, at small N), on distinct and on
    repeated toggled legs, and through ``parity_bits`` past the shared
    variant's limit (N = 29,057, 30,976 and 36,864), where only the wide
    variant launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc")
    for K in range(1, 7):
        for M, R, N in _RAGGED_K2:
            _cuda_parity_equal(ops.parity_bits_wide, K, M, R, N, K * M + R)
    for K, M, R, N in ((2, 300, 7, 29_057), (3, 1000, 32, 30_976), (2, 2000, 64, 36_864)):
        before = ops.parity_bits.launches, ops.parity_bits_wide.launches
        _cuda_parity_equal(ops.parity_bits, K, M, R, N, N)
        assert (ops.parity_bits.launches, ops.parity_bits_wide.launches) == (
            before[0], before[1] + 2)


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
                                   "checkerboard_multi_sweep_bands": 0,
                                   "checkerboard_multi_sweep_tiles": 0,
                                   "checkerboard_multi_sweep_global": 0, "parity_bits": 0,
                                   "parity_bits_wide": 0, "parity_bits_global": 0,
                                   "carry_decisions": 0, "carry_decisions_heatbath": 0,
                                   "take0": 0, "hook_min": 0, "pointer_jump": 0}
