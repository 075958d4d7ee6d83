"""Gradient-norm early-exit branch of the CRN steps.

The reference returns from ``step`` without moving when ||g|| < tolerance
(/root/reference/optimizer/cubic.py:201-202), so its run loop terminates
via the iterate-diff test. crn_step_full / crn_step_cg / gram_crn_step
implement this as a ``lax.cond`` freeze — these tests drive that branch
directly and through the run loop.
"""

import jax.numpy as jnp
import numpy as np

from krylov_crn_tpu.models.logistic import LogisticRegression
from krylov_crn_tpu.solvers.crn import CubicNewton, crn_step_full
from krylov_crn_tpu.solvers.crn_gram import GramCRN, gram_crn_step
from krylov_crn_tpu.solvers.krylov_gram import GramKrylov


def test_crn_full_early_exit_freezes_state(small_problem):
    A, b, x0 = small_problem
    loss = LogisticRegression(A, b)
    alg = CubicNewton(loss=loss, reg_coef=1e-3, cubic_solver="full",
                      tqdm=False, label="crn")
    st = alg.init_state(jnp.asarray(x0), 42)
    # tolerance above any gradient norm -> the early branch must fire
    st2 = crn_step_full(loss.data, loss.b, st, tolerance=1e9,
                        accum_dtype=jnp.float64)
    np.testing.assert_array_equal(np.asarray(st2.x), np.asarray(st.x))
    assert float(st2.diff_norm) == 0.0
    assert float(st2.value) == float(st.value)
    assert int(st2.solver_it) == int(st.solver_it)
    assert np.isfinite(float(st2.grad_norm))


def test_gram_crn_early_exit_freezes_state(small_problem):
    A, b, x0 = small_problem
    loss = LogisticRegression(A, b)
    alg = GramCRN(loss=loss, reg_coef=1e-3, tqdm=False, label="gcrn")
    st = alg.init_state(jnp.asarray(x0), 42)
    st2 = gram_crn_step(alg.gd, st, tolerance=1e9,
                        accum_dtype=jnp.float64)
    np.testing.assert_array_equal(np.asarray(st2.zeta), np.asarray(st.zeta))
    assert float(st2.diff_norm) == 0.0
    assert float(st2.value) == float(st.value)
    assert np.isfinite(float(st2.grad_norm))


def test_crn_run_terminates_on_grad_tolerance(small_problem):
    """Run-loop termination: with a loose tolerance the solver must stop
    as soon as the measured gradient norm drops below it — exactly the
    reference's behavior (freeze -> diff tolerance fires next check)."""
    A, b, x0 = small_problem
    loss = LogisticRegression(A, b)
    alg = CubicNewton(loss=loss, reg_coef=1e-3, cubic_solver="full",
                      tolerance=1e-2, tqdm=False, label="crn")
    alg.run(x0=x0, it_max=200)
    assert alg.it < 200  # converged well before the cap
    assert float(alg.state.grad_norm) < 1e-2 or \
        float(alg.state.diff_norm) < 1e-2


def test_zero_gradient_step_is_nan_free(small_problem):
    """Post-convergence steps (g numerically zero) must freeze, not NaN:
    the Lanczos normalization guards 0/0 and ties are accepted."""
    from krylov_crn_tpu.solvers.krylov_gram import gram_krylov_multistep

    A, b, x0 = small_problem
    loss = LogisticRegression(A, b)
    alg = GramKrylov(loss=loss, reg_coef=1e-3, subspace_dim=10,
                     tolerance=0, tqdm=False, label="gk")
    st = alg.init_state(jnp.asarray(x0), 42)
    kw = dict(m=10, l2=0.0, beta=0.5, solver_eps=1e-8, solver_it_max=100,
              ls_max=20, reorth_passes=1, accum_dtype=jnp.float64)
    # 60 iterations on a 60-dim problem: far past exact convergence
    st, _ = gram_krylov_multistep(alg.gd, st, chunk=60, **kw)
    assert np.isfinite(float(st.value))
    assert np.isfinite(float(st.reg_coef))
    assert np.isfinite(float(st.gamma))
    assert np.all(np.isfinite(np.asarray(st.zeta)))
