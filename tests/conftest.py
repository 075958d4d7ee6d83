"""Test harness configuration.

Tests run on a *CPU* backend with 8 virtual devices (the standard JAX idiom
for exercising shard_map/psum logic without a cluster) and x64 enabled so
the numerics match the all-fp64 reference implementation. The platform and
x64 flags are set via jax.config before any computation, so the suite runs
on the CPU even where JAX would pick a GPU by default.
"""

import os

# must be set before the CPU client is instantiated (first computation)
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


@pytest.fixture(scope="session")
def small_problem():
    """(A_csr, b, x0): small dense-ish logistic problem, fp64."""
    import scipy.sparse as sp

    rng = np.random.default_rng(7)
    n, d = 400, 60
    Ad = rng.standard_normal((n, d)) * (rng.random((n, d)) < 0.3)
    A = sp.csr_matrix(Ad)
    x_star = rng.standard_normal(d) / np.sqrt(d)
    b = np.where(Ad @ x_star + 0.3 * rng.standard_normal(n) > 0, 1.0, -1.0)
    x0 = np.ones(d) * 0.5
    return A, b, x0


@pytest.fixture(scope="session")
def sparse_problem():
    """Wider, sparser problem (rcv1-ish shape scaled down)."""
    from krylov_crn_tpu.data.synthetic import synthetic_logreg

    A, b = synthetic_logreg((600, 900, 8000), seed=3)
    x0 = np.ones(A.shape[1]) * 0.5
    return A, b.astype(np.float64), x0
