"""Kernel K4's three entry points on the CPU (their plain versions): the
two-grid ``take0`` against the JAX package's Pallas ``take0`` in interpret
mode, and ``hook_min`` with ``pointer_jump`` composed into hook-and-compress
rounds against JAX's ``_hook_compress_labels``; exact, since all of it is
integer work. The CUDA kernels against the same plain versions need the
card (``cuda`` marker)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isingmontecarlo_tpu.ops.take_kernel import take0 as jax_take0
from isingmontecarlo_tpu.sse import cluster as jcl
from isingmontecarlo_tpu_torch import ops
from isingmontecarlo_tpu_torch.sse import cluster as tcl

from torch_port_utils import release_jax_executables  # noqa: F401  (autouse)

torch.set_num_threads(1)


def test_take0_two_grids_match_pallas_on_each_grid():
    """One launch's two grids of different lengths (E=50 and E2=31) at a
    ragged shape (C=129 spans two 128-row digit planes; R=6); the Pallas
    kernel gathers both in one interpret call on their concatenation."""
    C, R = 129, 6
    rng = np.random.default_rng(4)
    table = rng.integers(0, C, size=(C, R), dtype=np.int32)
    idx = rng.integers(0, C, size=(50, R), dtype=np.int32)
    idx2 = rng.integers(0, C, size=(31, R), dtype=np.int32)
    idx2[-1] = C - 1
    want = np.asarray(jax_take0(jnp.asarray(table), jnp.asarray(np.concatenate([idx, idx2])),
                                interpret=True))
    ops.reset_launch_counts()
    got, got2 = ops.take0(*(torch.from_numpy(a) for a in (table, idx, idx2)))
    np.testing.assert_array_equal(got.numpy(), want[:50])
    np.testing.assert_array_equal(got2.numpy(), want[50:])
    assert torch.equal(ops.take0(torch.from_numpy(table), torch.from_numpy(idx)), got)
    assert ops.launch_counts()["take0"] == 0


def _edge_list(seed, S=301, E=260, R=5):
    """Random edges over S labels, a tenth of them on the dump row S - 1
    (as ``segment_graph`` pads), so components of many sizes form."""
    rng = np.random.default_rng(seed)
    u = rng.integers(0, S - 1, size=(E, R)).astype(np.int32)
    v = rng.integers(0, S - 1, size=(E, R)).astype(np.int32)
    dump = rng.random((E, R)) < 0.1
    u[dump] = v[dump] = S - 1
    return u, v, S


def _rounds_plain(u, v, S):
    """``hook_min_plain`` and ``pointer_jump_plain`` composed into rounds,
    with the flag tagged by the round as ``hook_compress_labels`` does.
    Returns the labels and the number of rounds."""
    R = u.shape[1]
    P = torch.arange(S, dtype=torch.int32)[:, None].repeat(1, R)
    flag = torch.zeros(1, dtype=torch.int32)
    for rounds in range(1, S + 1):
        Pn = ops.hook_min_plain(P, u, v, first=rounds == 1)
        assert bool((Pn <= torch.arange(S)[:, None]).all())  # P[x] <= x
        P, _ = ops.pointer_jump_plain(Pn, P, tcl.N_COMPRESS, flag, rounds)
        if int(flag) != rounds:
            return P, rounds
    raise AssertionError("no fixpoint")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hook_and_jump_rounds_match_jax_labels(seed):
    u, v, S = _edge_list(seed)
    want = np.asarray(jcl._hook_compress_labels(jnp.asarray(u), jnp.asarray(v), S))
    tu, tv = torch.from_numpy(u), torch.from_numpy(v)
    got, rounds = _rounds_plain(tu, tv, S)
    np.testing.assert_array_equal(got.numpy(), want)
    assert rounds > 2 and len(np.unique(want)) > 10
    ops.reset_launch_counts()
    assert torch.equal(tcl.hook_compress_labels(tu, tv, S), got)
    assert ops.launch_counts()["hook_min"] == ops.launch_counts()["pointer_jump"] == 0


def test_pointer_jump_equals_separate_jumps_and_keeps_an_unchanged_flag():
    """One call of ``jumps`` jumps is ``Pn`` applied ``2**jumps`` times;
    the flag takes the tag only where a label changed."""
    u, v, S = _edge_list(3)
    P0 = torch.arange(S, dtype=torch.int32)[:, None].repeat(1, u.shape[1])
    Pn = ops.hook_min(P0, torch.from_numpy(u), torch.from_numpy(v), first=True)
    out, flag = ops.pointer_jump(Pn, P0, 2, tag=7)
    want = Pn  # Pn applied once, then three more times
    for _ in range(3):
        want = torch.gather(Pn, 0, want.long())
    assert torch.equal(out, want) and int(flag) == 7
    again, flag = ops.pointer_jump(out, out, 0, flag, 9)
    assert torch.equal(again, out) and int(flag) == 7


@pytest.mark.cuda
def test_cuda_k4_entry_points_equal_plain():
    """Every K4 entry point against its plain version on the card, with R a
    multiple of 4 (16-byte path) and not (one replica a thread)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc")
    for R in (8, 5):
        u, v, S = _edge_list(5, R=R)
        tu, tv = torch.from_numpy(u).cuda(), torch.from_numpy(v).cuda()
        P0 = torch.arange(S, dtype=torch.int32, device="cuda")[:, None].repeat(1, R)
        Pn = ops.hook_min(P0, tu, tv, first=True)
        assert torch.equal(Pn, ops.hook_min_plain(P0, tu, tv, first=True))
        P1, flag = ops.pointer_jump(Pn, P0, 2, tag=3)
        want, wflag = ops.pointer_jump_plain(Pn, P0, 2, tag=3)
        assert torch.equal(P1, want) and torch.equal(flag, wflag)
        assert torch.equal(ops.hook_min(P1, tu, tv), ops.hook_min_plain(P1, tu, tv))
        got = ops.take0(P1, tu, tv)
        for g, w in zip(got, ops.take0_plain(P1, tu, tv)):
            assert torch.equal(g, w)
        assert torch.equal(tcl.hook_compress_labels(tu, tv, S).cpu(),
                           tcl.hook_compress_labels(tu.cpu(), tv.cpu(), S))
