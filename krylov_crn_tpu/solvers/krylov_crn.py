"""Krylov Cubic Regularized Newton — the paper's method, device-native.

Redesign of /root/reference/optimizer/cubic.py:238-319. One optimizer step
is a single jitted XLA program:

    gradient (from cached margins)                       1 transpose-SpMV
    Lanczos on the HVP operator, m steps, full reorth    m HVPs = 2m SpMVs
    tridiagonal eigendecomposition (m x m)               once per step
    backtracking line search (<= 20 trials):
        secular-equation Newton  (O(m) per trial)
        x_new  = x + s @ V        (GEMV)
        Ax_new = Ax + s @ AV      (GEMV)  <- AV collected during Lanczos
        f(x_new) from the fresh margins   (no SpMV!)

Two structural wins over the reference: the subspace Hessian is factored
once per step instead of re-solved per secular evaluation, and every
line-search trial costs two skinny GEMVs + an n-vector reduction instead
of a full SpMV (the reference pays A @ x_new per trial via its margins
cache, cubic.py:294-303 -> loss.py:270).

The accepted trial's margins become the next step's cache — functional
threading of the reference's mutable ``store_mat_vec_prod`` memoization
(loss.py:266-286).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from krylov_crn_tpu.data.formats import DualSparse
from krylov_crn_tpu.models.logistic import (
    data_mask,
    hessian_weights,
    logreg_gradient_from_margins,
    logreg_value_from_margins,
)
from krylov_crn_tpu.ops.lanczos import lanczos
from krylov_crn_tpu.ops.math import ls_accept, pair_diff, reg_clamp
from krylov_crn_tpu.ops.spmv import rmatvec, spmv
from krylov_crn_tpu.ops.subproblem import secular_newton, tridiag_eigh
from krylov_crn_tpu.solvers.base import Optimizer

__all__ = ["CubicKrylov", "KrylovState", "krylov_step"]


class KrylovState(NamedTuple):
    x: jax.Array  # iterate (d,)
    Ax: jax.Array  # cached margins A @ x (n,)
    value: jax.Array  # f(x) two-float hi part (lo = 0 under x64)
    value_lo: jax.Array
    reg_coef: jax.Array  # current Hessian-Lipschitz estimate M
    r0: jax.Array  # warm-started secular root (cubic.py:255,307)
    solver_it: jax.Array  # accumulated 1-D Newton iterations (int32)
    diff_norm: jax.Array  # ||x_new - x_old|| of the last step
    grad_norm: jax.Array  # ||grad|| observed in the last step
    f_best: jax.Array  # running min of observed f values (the empirical
    # f* protocol of loss.py:66-73 / cubic_newton.py:140, device-side)
    f_best_lo: jax.Array


def _asdt(v, dt):
    return jnp.asarray(v, dt)


@functools.partial(
    jax.jit,
    static_argnames=("m", "l2", "beta", "solver_eps", "solver_it_max",
                     "ls_max", "reorth_passes", "accum_dtype", "reg_ceil"),
)
def krylov_step(
    data: DualSparse,
    b: jax.Array,
    state: KrylovState,
    m: int = 10,
    l2: float = 0.0,
    beta: float = 0.5,
    solver_eps: float = 1e-8,
    solver_it_max: int = 100,
    ls_max: int = 20,
    reorth_passes: int = 1,
    accum_dtype=jnp.float32,
    reg_ceil: float = 1e6,
) -> KrylovState:
    """One Krylov-CRN iteration (cubic.py:265-309) as one XLA program."""
    cdt = state.x.dtype
    adt = jnp.dtype(accum_dtype)
    n = data.n

    x, Ax, value = state.x, state.Ax, state.value
    g = logreg_gradient_from_margins(data, b, Ax, x, l2=l2)
    mask = data_mask(data)
    w = hessian_weights(Ax, mask)

    def hvp_op(v):
        Av = spmv(data, v)
        Hv = rmatvec(data, w * Av) / n
        if l2:
            Hv = Hv + l2 * v
        return Hv, Av

    lz = lanczos(hvp_op, g, m, reorth_passes=reorth_passes,
                 accum_dtype=adt)
    AV = lz.aux  # (m, n): rows are A v_j

    # Subspace problem in accum precision: T = tridiag(alphas, betas),
    # g_sub = ||g|| e1  =>  Ritz weights c = ||g|| * Q[0, :]
    theta, Q = tridiag_eigh(lz.alphas.astype(adt), lz.betas.astype(adt))
    g_norm = jnp.sqrt(jnp.dot(g.astype(adt), g.astype(adt)))
    c = g_norm * Q[0, :]

    def trial(reg, r0):
        lam, it = secular_newton(theta, c, reg, r0, xtol=solver_eps,
                                 it_max=solver_it_max)
        u = -c / (theta + lam)
        s = Q @ u  # subspace step in Lanczos coordinates (m,)
        norm_s = jnp.sqrt(jnp.sum(u * u))
        model_dec = (lam / 2.0 * norm_s**2 - reg / 3.0 * norm_s**3
                     - g_norm * s[0] / 2.0)
        s_c = s.astype(cdt)
        x_new = x + s_c @ lz.V
        Ax_new = Ax + s_c @ AV
        vhi, vlo = logreg_value_from_margins(b, Ax_new, x_new, l2=l2,
                                             mask=mask, n=n)
        return lam, it, model_dec, x_new, Ax_new, vhi, vlo

    # Backtracking line search (cubic.py:286-303): optimistic first trial at
    # reg*beta, then multiply by 1/beta until sufficient decrease, <= ls_max.
    reg0 = state.reg_coef.astype(adt) * beta
    first = trial(reg0, state.r0.astype(adt))
    carry0 = (reg0,) + first + (jnp.asarray(0, jnp.int32),)

    def ls_cond(carry):
        reg, lam, it, model_dec, x_new, Ax_new, vhi, vlo, trials = carry
        # NaN-robust form of `value_new > value - model_dec` (a fp32
        # overflow retries with larger reg instead of being accepted);
        # the two-float gap resolves accepts below fp32 eps
        bad = jnp.logical_not(
            ls_accept(vhi, vlo, value, state.value_lo, model_dec))
        return jnp.logical_and(bad, trials < ls_max)

    def ls_body(carry):
        reg = carry[0] / beta
        out = trial(reg, state.r0.astype(adt))
        return (reg,) + out + (carry[-1] + 1,)

    reg, lam, it, model_dec, x_new, Ax_new, value_new, value_new_lo, _ = \
        jax.lax.while_loop(ls_cond, ls_body, carry0)

    diff = x_new - x
    diff_norm = jnp.sqrt(jnp.dot(diff.astype(adt), diff.astype(adt)))
    better = pair_diff(value_new, value_new_lo,
                       state.f_best, state.f_best_lo) < 0
    return KrylovState(
        x=x_new,
        Ax=Ax_new,
        value=value_new,
        value_lo=value_new_lo,
        reg_coef=reg_clamp(reg, cdt, reg_ceil).astype(cdt),
        r0=lam.astype(cdt),
        solver_it=state.solver_it + it,
        diff_norm=diff_norm.astype(cdt),
        grad_norm=g_norm.astype(cdt),
        f_best=jnp.where(better, value_new, state.f_best),
        f_best_lo=jnp.where(better, value_new_lo, state.f_best_lo),
    )


class CubicKrylov(Optimizer):
    """Reference class ``Cubic_Krylov_LS`` (cubic.py:238-319).

    Arguments mirror the reference: reg_coef (Hessian-Lipschitz estimate;
    defaults to the oracle's), subspace_dim m, solver_eps, beta.
    """

    def __init__(self, reg_coef=None, subspace_dim=100, solver_eps=1e-8,
                 beta=0.5, solver_it_max=100, ls_max=20, reorth_passes=1,
                 *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.subspace_dim = int(subspace_dim)
        self.solver_eps = float(solver_eps)
        self.solver_it_max = int(solver_it_max)
        self.beta = float(beta)
        self.ls_max = int(ls_max)
        self.reorth_passes = int(reorth_passes)
        self.reg_coef = (self.loss.hessian_lipschitz if reg_coef is None
                         else float(reg_coef))

    def init_state(self, x0, seed):
        loss = self.loss
        value, value_lo, Ax = _initial_value(loss.data, loss.b, x0, loss.l2)
        cdt = x0.dtype
        self.loss.reset()
        self.trace.solver_its = [0]
        return KrylovState(
            x=x0,
            Ax=Ax,
            value=value,
            value_lo=value_lo,
            reg_coef=jnp.asarray(self.reg_coef, cdt),
            r0=jnp.asarray(0.1, cdt),
            solver_it=jnp.asarray(0, jnp.int32),
            diff_norm=jnp.asarray(jnp.inf, cdt),
            grad_norm=jnp.asarray(jnp.inf, cdt),
            f_best=value,
            f_best_lo=value_lo,
        )

    def step(self):
        self.state = krylov_step(
            self.loss.data, self.loss.b, self.state,
            m=self.subspace_dim, l2=self.loss.l2, beta=self.beta,
            solver_eps=self.solver_eps, solver_it_max=self.solver_it_max,
            ls_max=self.ls_max, reorth_passes=self.reorth_passes,
            accum_dtype=_accum_dtype(self.state.x.dtype),
            reg_ceil=max(1e6, 1e4 * float(self.reg_coef)),
        )

    def update_trace(self):
        super().update_trace()
        self.trace.solver_its.append(int(self.state.solver_it))


def _accum_dtype(cdt):
    import jax as _jax

    return (jnp.float64 if _jax.config.read("jax_enable_x64")
            else jnp.dtype(cdt))


@functools.partial(jax.jit, static_argnames=("l2",))
def _initial_value(data, b, x0, l2):
    """(value_hi, value_lo, margins) at the start point."""
    Ax = spmv(data, x0)
    hi, lo = logreg_value_from_margins(b, Ax, x0, l2=l2,
                                       mask=data_mask(data), n=data.n)
    return hi, lo, Ax
