"""Cubic-regularized subproblem:  min_s <g,s> + 1/2 <s,Hs> + M/3 ||s||^3.

Cartis–Gould–Toint secular-equation approach (the scheme the reference
implements with scipy root_scalar + a linear solve per evaluation,
the reference's optimizer/cubic.py:40-75). Device-native redesign:

* **Eigendecompose once, solve many.** H (the m x m Lanczos tridiagonal, or
  a small dense Hessian) is factored H = Q diag(theta) Q^T a single time per
  optimizer step; every secular-equation evaluation — across all Newton
  iterations *and all backtracking line-search trials* — is then O(m)
  closed-form work. The reference re-runs a dense/sparse linear solve for
  every phi(lambda) evaluation of every trial (cubic.py:60-71,214-220).
* The 1-D Newton iteration on phi(lambda) = lambda^2 - M^2 ||s(lambda)||^2
  is a ``lax.while_loop`` with scipy-newton stopping (|step| < xtol, capped
  iterations), safeguarded by clamping lambda above max(0, -theta_min)
  (the reference relies on H being PSD and has no safeguard).
* A matrix-free CG variant mirrors the reference's "CG" solver for the
  full-space CRN path (cubic.py:152-182): each phi needs one CG solve,
  each phi' a second.

Breakdown-masked Lanczos blocks (zero alpha/beta tails) are handled for
free: masked eigenpairs have zero Ritz weight c_i = ||g|| Q[0,i] = 0.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

__all__ = [
    "tridiag_eigh",
    "secular_newton",
    "cubic_solve_eigh",
    "cubic_subproblem_eigh",
    "cubic_solve_cg",
]


class CubicSolution(NamedTuple):
    s: jax.Array  # minimizer
    iterations: jax.Array  # 1-D Newton iterations used
    r: jax.Array  # the root lambda* (warm-start for the next call)
    model_decrease: jax.Array  # r/2||s||^2 - M/3||s||^3 - <g,s>/2


def tridiag_eigh(alphas: jax.Array, betas: jax.Array):
    """Eigendecomposition of the symmetric tridiagonal T(alphas, betas).

    m is tiny (10-1000): a dense eigh on the device is cheaper than bespoke
    tridiagonal QR and gives eigenvectors (jax's eigh_tridiagonal cannot).
    """
    T = jnp.diag(alphas) + jnp.diag(betas, -1) + jnp.diag(betas, 1)
    return jnp.linalg.eigh(T)


def secular_newton(
    theta: jax.Array,
    c: jax.Array,
    M,
    r0,
    xtol: float = 1e-8,
    it_max: int = 100,
):
    """Newton on phi(lam) = lam^2 - M^2 * sum_i c_i^2/(theta_i+lam)^2.

    Returns (lam, iterations). Matches scipy root_scalar(method='newton')
    semantics (absolute-step xtol, maxiter; cubic.py:70) plus a positivity/
    definiteness safeguard.
    """
    dt = theta.dtype
    M = jnp.asarray(M, dt)
    c2 = c * c
    # lower bound for lam: H + lam I must be PD and lam = M||s|| >= 0.
    # For indefinite H (lo > 0) start/stay strictly inside to avoid the
    # pole at lam = -theta_min; for PSD H lo = 0 and this is inactive.
    lo = jnp.maximum(jnp.asarray(0.0, dt), -jnp.min(theta))
    lo_strict = jnp.where(lo > 0, lo + 1e-6 * (1.0 + lo), lo)
    lam0 = jnp.maximum(jnp.asarray(r0, dt), lo_strict)

    def phi_and_grad(lam):
        # zero-weight eigenpairs (masked Lanczos tails, or an exactly
        # zero gradient at numerical convergence) must not produce 0/0:
        # drop their terms instead of dividing (c2 == 0 -> term == 0)
        denom = theta + lam
        safe = jnp.where(c2 > 0, denom, 1.0)
        s2 = jnp.sum(jnp.where(c2 > 0, c2 / (safe * safe), 0.0))
        s3 = jnp.sum(jnp.where(c2 > 0, c2 / (safe * safe * safe), 0.0))
        phi = lam * lam - M * M * s2
        dphi = 2.0 * lam + 2.0 * M * M * s3
        return phi, dphi

    def cond(state):
        lam, step, it = state
        return jnp.logical_and(jnp.abs(step) >= xtol, it < it_max)

    def body(state):
        lam, _, it = state
        phi, dphi = phi_and_grad(lam)
        step = phi / dphi
        lam_new = lam - step
        # bisection-style safeguard: never cross the pole
        lam_new = jnp.where(lam_new <= lo, (lam + lo) / 2.0, lam_new)
        return (lam_new, lam_new - lam, it + 1)

    big = jnp.asarray(jnp.inf, dt)
    lam, _, it = jax.lax.while_loop(cond, body, (lam0, big, jnp.asarray(0, jnp.int32)))
    return lam, it


def cubic_solve_eigh(
    theta: jax.Array,
    Q: jax.Array,
    g: jax.Array,
    M,
    r0,
    xtol: float = 1e-8,
    it_max: int = 100,
) -> CubicSolution:
    """Solve the cubic subproblem given a ready eigendecomposition of H."""
    dt = theta.dtype
    c = Q.T @ g.astype(dt)
    lam, it = secular_newton(theta, c, M, r0, xtol=xtol, it_max=it_max)
    u = jnp.where(c != 0, -c / jnp.where(c != 0, theta + lam, 1.0), 0.0)
    s = Q @ u
    norm_s = jnp.sqrt(jnp.sum(u * u))
    M = jnp.asarray(M, dt)
    model_decrease = (
        lam / 2.0 * norm_s**2 - M / 3.0 * norm_s**3 - jnp.dot(g.astype(dt), s) / 2.0
    )
    return CubicSolution(s=s, iterations=it, r=lam, model_decrease=model_decrease)


def cubic_subproblem_eigh(
    g: jax.Array,
    H: jax.Array,
    M,
    r0=0.1,
    xtol: float = 1e-8,
    it_max: int = 100,
) -> CubicSolution:
    """Dense-H convenience wrapper (factor + solve)."""
    theta, Q = jnp.linalg.eigh(H)
    return cubic_solve_eigh(theta, Q, g, M, r0, xtol=xtol, it_max=it_max)


def cubic_solve_cg(
    hvp: Callable,
    g: jax.Array,
    M,
    r0,
    it_max: int = 100,
    epsilon: float = 1e-8,
    cg_maxiter: int | None = None,
    accum_dtype=jnp.float32,
) -> CubicSolution:
    """Matrix-free cubic solve: every secular evaluation runs a CG solve
    over HVPs (parity with /root/reference/optimizer/cubic.py:152-182).

    ``hvp(v)`` must return H v (without the lam*I shift).
    """
    from krylov_crn_tpu.ops.cg import cg_solve

    dt = g.dtype
    adt = jnp.dtype(accum_dtype)
    M = jnp.asarray(M, dt)

    def solve_shifted(lam, rhs):
        mv = lambda v: hvp(v) + lam * v
        x, _ = cg_solve(mv, rhs, rtol=epsilon, maxiter=cg_maxiter,
                        accum_dtype=adt)
        return x

    def phi(lam):
        s = solve_shifted(lam, -g)
        return lam * lam - M * M * jnp.dot(s.astype(adt), s.astype(adt)).astype(dt), s

    def dphi(lam, s):
        Hinv_s = solve_shifted(lam, s)
        return 2.0 * lam + 2.0 * M * M * jnp.dot(
            s.astype(adt), Hinv_s.astype(adt)
        ).astype(dt)

    def cond(state):
        lam, step, it = state
        return jnp.logical_and(jnp.abs(step) >= epsilon, it < it_max)

    def body(state):
        lam, _, it = state
        p, s = phi(lam)
        dp = dphi(lam, s)
        step = p / dp
        lam_new = jnp.maximum(lam - step, jnp.asarray(0.0, dt))
        return (lam_new, lam_new - lam, it + 1)

    lam0 = jnp.asarray(r0, dt)
    big = jnp.asarray(jnp.inf, dt)
    lam, _, it = jax.lax.while_loop(cond, body, (lam0, big, jnp.asarray(0, jnp.int32)))
    s = solve_shifted(lam, -g)
    norm_s = jnp.sqrt(jnp.dot(s.astype(adt), s.astype(adt))).astype(dt)
    model_decrease = (
        lam / 2.0 * norm_s**2
        - M / 3.0 * norm_s**3
        - jnp.dot(g.astype(adt), s.astype(adt)).astype(dt) / 2.0
    )
    return CubicSolution(s=s, iterations=it, r=lam, model_decrease=model_decrease)
