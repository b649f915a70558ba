"""Step sizes of the PyTorch port against the JAX package.

Power iteration from the JAX package's own start vector (injected as v0)
and the serial/minibatch SAGA step sizes, on float64 inputs made with
numpy from a seed.  Tolerance: rtol 1e-10 (the two libraries sum the
matrix-vector products in different orders over 30 iterations).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgdnet_tpu.solver import stepsize as jss
from sgdnet_tpu_torch.solver import stepsize as tss

torch.set_num_threads(1)


@pytest.mark.parametrize("shape", [(50, 4), (120, 30), (16, 40)])
def test_power_iteration_matches(shape):
    rng = np.random.default_rng(shape[0])
    x = rng.normal(size=shape) * rng.uniform(0.5, 3.0, size=shape[1])
    ref = float(jss.power_iteration_sq_norm(jnp.asarray(x)))
    v0 = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (shape[1],), dtype=jnp.float64))
    got = float(tss.power_iteration_sq_norm(torch.tensor(x), v0=torch.tensor(v0)))
    np.testing.assert_allclose(got, ref, rtol=1e-10)
    # and it is the top eigenvalue of X^T X
    np.testing.assert_allclose(got, np.linalg.eigvalsh(x.T @ x)[-1], rtol=1e-6)


def test_power_iteration_default_start_is_seeded():
    x = torch.tensor(np.random.default_rng(4).normal(size=(40, 6)))
    a = tss.power_iteration_sq_norm(x, seed=3)
    b = tss.power_iteration_sq_norm(x, seed=3)
    assert float(a) == float(b)
    # 30 iterations converge as fast as the eigengap allows: 1e-4 here
    np.testing.assert_allclose(float(a), np.linalg.eigvalsh((x.T @ x).numpy())[-1], rtol=1e-4)


@pytest.mark.parametrize("fit_intercept", [True, False])
@pytest.mark.parametrize("batch_size", [1, 8, 32, 500])
@pytest.mark.parametrize("L_scaling", [1.0, 0.25, 16.0])
def test_saga_step_sizes_match(batch_size, fit_intercept, L_scaling):
    rng = np.random.default_rng(batch_size)
    l2 = np.concatenate([[0.0], rng.uniform(0.0, 0.5, size=6)])
    n, max_sq, top = 300.0, 12.5, 3.25
    ref = np.asarray(jss.saga_step_sizes(max_sq, top, jnp.asarray(l2), n, batch_size, fit_intercept, L_scaling))
    got = tss.saga_step_sizes(max_sq, None if batch_size <= 1 else top, l2, n, batch_size, fit_intercept,
                              L_scaling)
    assert got.dtype == np.float64
    np.testing.assert_allclose(got, ref, rtol=1e-10)
