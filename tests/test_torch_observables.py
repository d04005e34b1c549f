"""The port's state observables against the JAX package's on the same
states, within 1e-6 (float32 FFTs and sums taken in other orders), on the
cases of ``tests/test_observables.py``, random states with several sample
axes, and the physics check of that file on the port's own chain."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isingmontecarlo_tpu import analysis as janalysis
from isingmontecarlo_tpu_torch import analysis as tanalysis
from isingmontecarlo_tpu_torch import lattice
from isingmontecarlo_tpu_torch.sse import QmcIsingGraph

from torch_port_utils import release_jax_executables  # noqa: F401  (autouse)

torch.set_num_threads(1)

NAMES = ("magnetization", "magnetization_squared", "binder_cumulant", "spin_spin_correlation",
         "structure_factor")
CASES = {
    "mixed": np.array([[True, True, False, True], [False, False, False, False]]),
    "aligned_samples": np.ones((10, 2, 6), bool),
    "aligned_ring": np.ones((1, 1, 8), bool),
    "neel": (np.arange(8) % 2 == 0)[None, None, :],
    "random_3d": np.random.default_rng(0).random((7, 5, 12)) < 0.5,
    "random_4d": np.random.default_rng(1).random((3, 4, 2, 9)) < 0.3,
}


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("case", list(CASES))
def test_observable_equals_jax(name, case):
    states = CASES[case]
    want = np.asarray(getattr(janalysis, name)(jnp.asarray(states)))
    got = getattr(tanalysis, name)(torch.from_numpy(states))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_exact_small_cases():
    s = torch.from_numpy(CASES["mixed"])
    np.testing.assert_allclose(tanalysis.magnetization(s).numpy(), [2.0, -4.0])
    np.testing.assert_allclose(tanalysis.magnetization_squared(s).numpy(), [4.0, 16.0])
    u = tanalysis.binder_cumulant(torch.ones((10, 2, 6), dtype=torch.bool)).numpy()
    np.testing.assert_allclose(u, 2.0 / 3.0, atol=1e-6)
    ring = torch.ones((1, 1, 8), dtype=torch.bool)
    np.testing.assert_allclose(tanalysis.spin_spin_correlation(ring).numpy(), 1.0, atol=1e-6)
    sq = tanalysis.structure_factor(ring).numpy()
    assert sq[0] == pytest.approx(8.0, abs=1e-5)
    np.testing.assert_allclose(sq[1:], 0.0, atol=1e-5)
    c = tanalysis.spin_spin_correlation(torch.from_numpy(CASES["neel"])).numpy()
    np.testing.assert_allclose(c, [1, -1, 1, -1, 1, -1, 1, -1], atol=1e-6)


def test_ferromagnetic_chain_orders_at_low_t():
    g = QmcIsingGraph(lattice.chain(8, j=-1.0), transverse=0.3, replicas=32, seed=3,
                      device="cpu")
    states, _ = g.timesteps_sample(120, beta=6.0)
    tail = states[len(states) // 2:]
    m2 = float(tanalysis.magnetization_squared(tail).mean()) / 64.0
    assert m2 > 0.6, m2
    c = tanalysis.spin_spin_correlation(tail).numpy()
    assert c[1] > 0.5 and c[4] > 0.4
    assert float(tanalysis.binder_cumulant(tail).mean()) > 0.5
