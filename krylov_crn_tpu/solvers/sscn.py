"""Stochastic Subspace Cubic Newton (coordinate version, Hanzely et al.).

Redesign of /root/reference/optimizer/cubic.py:321-408. Per step, one
jitted program:

    sample m coordinates without replacement (jax PRNG in solver state)
    materialize the sampled columns as a dense n x m panel B (window
        gathers from the stored transpose — see ops/coords.py)
    partial gradient  B^T (sigma(Ax)-b)/n           (dense GEMV)
    partial Hessian   B^T diag(w) B / n             (dense GEMM)
    eigendecompose the m x m Hessian once; line-search trials re-solve
        only the O(m) secular equation
    scatter-update x[I] += s and incrementally refresh the margins
        Ax += B @ s  — the functional analogue of the reference's stateful
        ``update_mat_vec_product`` cache (loss.py:279-281), so a value
        evaluation costs O(n) instead of O(nnz).

The reference forces tolerance = 0 (cubic.py:345) — mirrored here.

Row-sharded data (ShardedDual): supported since round 5 — the column
panel assembles shard-locally (parallel/sharded.sharded_gather_columns),
and the B^T reductions + value evaluation psum under GSPMD; the iterate
x stays replicated and the scatter-update is local. Same trace as the
single-device run (tests/test_parallel.py::test_sscn_sharded_matches_single).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from krylov_crn_tpu.data.formats import DualSparse
from krylov_crn_tpu.models.logistic import (
    data_mask,
    logreg_partials,
    logreg_value_from_margins,
)
from krylov_crn_tpu.ops.math import ls_accept, pair_diff, reg_clamp
from krylov_crn_tpu.ops.subproblem import secular_newton
from krylov_crn_tpu.solvers.base import Optimizer
from krylov_crn_tpu.solvers.krylov_crn import _accum_dtype, _initial_value

__all__ = ["SSCN", "SSCNState", "sscn_step"]


class SSCNState(NamedTuple):
    x: jax.Array
    Ax: jax.Array
    value: jax.Array  # f(x) two-float hi part (lo = 0 under x64)
    value_lo: jax.Array
    reg_coef: jax.Array
    r0: jax.Array
    solver_it: jax.Array
    diff_norm: jax.Array
    f_best: jax.Array
    f_best_lo: jax.Array
    key: jax.Array  # PRNG key for coordinate sampling


@functools.partial(
    jax.jit,
    static_argnames=("m", "l2", "beta", "solver_eps", "solver_it_max",
                     "ls_max", "accum_dtype", "reg_ceil"),
)
def sscn_step(
    data: DualSparse,
    b: jax.Array,
    state: SSCNState,
    m: int = 100,
    l2: float = 0.0,
    beta: float = 0.5,
    solver_eps: float = float(np.finfo(np.float64).eps),
    solver_it_max: int = 100,
    ls_max: int = 200,
    accum_dtype=jnp.float32,
    reg_ceil: float = 1e6,
) -> SSCNState:
    """One SSCN iteration (cubic.py:352-398) as one XLA program."""
    cdt = state.x.dtype
    adt = jnp.dtype(accum_dtype)
    x, Ax, value = state.x, state.Ax, state.value

    key, sub = jax.random.split(state.key)
    I = jax.random.choice(sub, data.d, shape=(m,), replace=False)
    I = I.astype(jnp.int32)

    g, H, B = logreg_partials(data, b, Ax, x, I, l2=l2)
    theta, Q = jnp.linalg.eigh(H.astype(adt))
    c = Q.T @ g.astype(adt)

    def trial(reg, r0):
        lam, it = secular_newton(theta, c, reg, r0, xtol=solver_eps,
                                 it_max=solver_it_max)
        u = -c / (theta + lam)
        s = Q @ u
        norm_s = jnp.sqrt(jnp.sum(u * u))
        model_dec = (lam / 2.0 * norm_s**2 - reg / 3.0 * norm_s**3
                     - jnp.dot(g.astype(adt), s) / 2.0)
        s_c = s.astype(cdt)
        x_new = x.at[I].add(s_c)
        Ax_new = Ax + B @ s_c
        vhi, vlo = logreg_value_from_margins(
            b, Ax_new, x_new, l2=l2, mask=data_mask(data), n=data.n)
        return lam, it, model_dec, x_new, Ax_new, vhi, vlo

    # reg floor at machine eps mirrors cubic.py:366
    reg0 = jnp.maximum(state.reg_coef.astype(adt) * beta,
                       jnp.asarray(np.finfo(np.float64).eps, adt))
    carry0 = (reg0,) + trial(reg0, state.r0.astype(adt)) + \
        (jnp.asarray(0, jnp.int32),)

    def ls_cond(carry):
        model_dec, vhi, vlo, trials = (carry[3], carry[6], carry[7],
                                       carry[-1])
        bad = jnp.logical_not(
            ls_accept(vhi, vlo, value, state.value_lo, model_dec))
        return jnp.logical_and(bad, trials < ls_max)

    def ls_body(carry):
        reg = carry[0] / beta
        return (reg,) + trial(reg, state.r0.astype(adt)) + (carry[-1] + 1,)

    reg, lam, it, _, x_new, Ax_new, vhi, vlo, _ = jax.lax.while_loop(
        ls_cond, ls_body, carry0)

    diff = x_new - x
    diff_norm = jnp.sqrt(jnp.dot(diff.astype(adt), diff.astype(adt)))
    better = pair_diff(vhi, vlo, state.f_best, state.f_best_lo) < 0
    return SSCNState(
        x=x_new, Ax=Ax_new, value=vhi, value_lo=vlo,
        reg_coef=reg_clamp(reg, cdt, reg_ceil).astype(cdt),
        r0=lam.astype(cdt),
        solver_it=state.solver_it + it,
        diff_norm=diff_norm.astype(cdt),
        f_best=jnp.where(better, vhi, state.f_best),
        f_best_lo=jnp.where(better, vlo, state.f_best_lo),
        key=key,
    )


class SSCN(Optimizer):
    """Reference class ``SSCN`` (cubic.py:321-408)."""

    def __init__(self, reg_coef=None, subspace_dim=100, solver_eps=None,
                 beta=0.5, solver_it_max=100, ls_max=200, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.subspace_dim = int(subspace_dim)
        self.solver_eps = (float(np.finfo(np.float64).eps)
                           if solver_eps is None else float(solver_eps))
        self.solver_it_max = int(solver_it_max)
        self.beta = float(beta)
        self.ls_max = int(ls_max)
        self.reg_coef = (self.loss.hessian_lipschitz if reg_coef is None
                         else float(reg_coef))
        # the reference zeroes the iterate-diff tolerance (cubic.py:345)
        self.tolerance = 0

    def init_state(self, x0, seed):
        loss = self.loss
        value, value_lo, Ax = _initial_value(loss.data, loss.b, x0, loss.l2)
        cdt = x0.dtype
        loss.reset()
        self.trace.solver_its = [0]
        return SSCNState(
            x=x0, Ax=Ax, value=value, value_lo=value_lo,
            reg_coef=jnp.asarray(self.reg_coef, cdt),
            r0=jnp.asarray(0.1, cdt),
            solver_it=jnp.asarray(0, jnp.int32),
            diff_norm=jnp.asarray(jnp.inf, cdt),
            f_best=value, f_best_lo=value_lo,
            key=jax.random.PRNGKey(seed),
        )

    def step(self):
        self.state = sscn_step(
            self.loss.data, self.loss.b, self.state,
            m=self.subspace_dim, l2=self.loss.l2, beta=self.beta,
            solver_eps=self.solver_eps, solver_it_max=self.solver_it_max,
            ls_max=self.ls_max,
            accum_dtype=_accum_dtype(self.state.x.dtype),
            reg_ceil=max(1e6, 1e4 * float(self.reg_coef)),
        )

    def update_trace(self):
        super().update_trace()
        self.trace.solver_its.append(int(self.state.solver_it))
