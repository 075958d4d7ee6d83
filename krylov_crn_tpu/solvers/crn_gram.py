"""Full-space CRN (CG backend) in Gram space.

The reference's large-d CRN variant (cubic.py:152-182) is the hottest nest
in its codebase: secular Newton x CG x SpMV. Here the same nest runs with
rep-space vectors (ops/gram.py): each CG matvec is one dense K-matvec, all
inner products are closed form — no sparse op anywhere in the loop.

Dispatch granularity is deliberately ONE CG SOLVE per device program: the
secular Newton and the backtracking line search run on the host, exactly
like the reference's ``root_scalar``-over-CG structure (cubic.py:157-182).
A fully fused step (line search x Newton x CG in one XLA program) was the
first design, but a single dispatch can then run minutes of device time
on ill-conditioned problems with zero progress visibility. The host
overhead is O(ms) per CG solve against O(100ms..s) of device time per
solve — noise.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from krylov_crn_tpu.ops.gram import (
    GramData,
    Rep,
    k_matvec,
    rep_axpy,
    rep_dot,
)
from krylov_crn_tpu.ops.math import reg_clamp, two_sum
from krylov_crn_tpu.solvers.base import Optimizer
from krylov_crn_tpu.solvers.krylov_crn import _accum_dtype
from krylov_crn_tpu.solvers.krylov_gram import (
    GramKrylov,
    GramKrylovState,
    _candidate_df,
    _gram_value,
    _x_sqnorm,
)

__all__ = ["GramCRN", "gram_crn_step"]


def _rep_zero(npad, cdt):
    return Rep(jnp.zeros((), cdt), jnp.zeros(npad, cdt),
               jnp.zeros(npad, cdt))


def cg_rep(gd: GramData, matvec, b: Rep, rtol, maxiter, adt):
    """CG over rep-space vectors; mirrors ops/cg.py semantics."""
    cdt = b.w.dtype

    def dot(u, v):
        return rep_dot(gd, u, v, adt)

    bnorm2 = dot(b, b)
    tol2 = (rtol * rtol) * bnorm2
    x0 = _rep_zero(b.w.shape[0], cdt)
    r0 = b
    gamma0 = bnorm2
    init = (x0, r0, r0, gamma0, jnp.asarray(0, jnp.int32))

    def cond(st):
        _, _, _, gamma, it = st
        return jnp.logical_and(gamma > tol2, it < maxiter)

    def body(st):
        x, r, p, gamma, it = st
        Ap = matvec(p)
        alpha = (gamma / dot(p, Ap)).astype(cdt)
        x = rep_axpy(x, alpha, p)
        r = rep_axpy(r, -alpha, Ap)
        gamma_new = dot(r, r)
        beta = (gamma_new / gamma).astype(cdt)
        p = Rep(r.beta + beta * p.beta, r.w + beta * p.w,
                r.u + beta * p.u)
        return (x, r, p, gamma_new, it + 1)

    x, _, _, _, it = jax.lax.while_loop(cond, body, init)
    return x, it


# ------------------------- jitted dispatch units -------------------------
#
# Each device program below is one bounded unit of work (a gradient probe,
# one CG solve, one trial evaluation); the Newton and line-search loops
# that sequence them live on the host in gram_crn_step.


@functools.partial(jax.jit, static_argnames=("l2", "accum_dtype"))
def _grad_probe(gd: GramData, state: GramKrylovState, l2, accum_dtype):
    """Gradient rep g, ||g||, Hessian weights D — one K-matvec.

    The gradient image is maintained incrementally through the state's
    (w_g, uK) invariant (see GramKrylovState): the matvec runs on the
    step-sized dw, so its error floor scales with convergence. Returns
    the refreshed (w_new, uK) for the caller to commit."""
    cdt = state.zeta.dtype
    adt = jnp.dtype(accum_dtype)
    n = gd.n
    sig0 = jax.nn.sigmoid(state.Ax)
    sig = sig0 + sig0 * (1.0 - sig0) * state.Ax_lo
    residual = (sig - gd.b) * gd.mask
    w_new = residual / n + (l2 * state.zeta if l2 else 0.0)
    dw = w_new - state.w_g
    uK = state.uK + k_matvec(gd, gd.K, dw)
    beta_g = jnp.asarray(l2, cdt) * state.gamma
    u_g = beta_g * gd.Ax0 + uK
    g = Rep(beta_g, w_new, u_g)
    g_norm = jnp.sqrt(jnp.maximum(rep_dot(gd, g, g, adt), 0.0))
    D = sig0 * (1.0 - sig0) * gd.mask / n
    return g, g_norm, D, w_new, uK


def _hop(gd: GramData, D, l2, cdt):
    def hop(v: Rep) -> Rep:
        q = D * v.u
        w_H = q + (l2 * v.w if l2 else 0.0)
        u_H = k_matvec(gd, gd.K, q) + (l2 * v.u if l2 else 0.0)
        return Rep(jnp.asarray(l2, cdt) * v.beta, w_H, u_H)

    return hop


@functools.partial(
    jax.jit,
    static_argnames=("l2", "solver_eps", "cg_maxiter", "accum_dtype"))
def _cg_shifted(gd: GramData, D, rhs: Rep, lam, l2, solver_eps,
                cg_maxiter, accum_dtype):
    """Solve (H + lam*I) s = rhs by CG; one bounded device program.

    Returns (s, <s, s>, cg_iterations)."""
    cdt = rhs.w.dtype
    adt = jnp.dtype(accum_dtype)
    hop = _hop(gd, D, l2, cdt)
    lam_c = lam.astype(cdt)
    mv = lambda v: rep_axpy(hop(v), lam_c, v)
    s, it = cg_rep(gd, mv, rhs, solver_eps, cg_maxiter, adt)
    return s, rep_dot(gd, s, s, adt), it


@functools.partial(jax.jit, static_argnames=("accum_dtype",))
def _rep_dot_j(gd: GramData, u: Rep, v: Rep, accum_dtype):
    return rep_dot(gd, u, v, jnp.dtype(accum_dtype))


@functools.partial(jax.jit, static_argnames=("l2", "accum_dtype"))
def _trial_eval(gd: GramData, state: GramKrylovState, g: Rep, s: Rep,
                lam, reg, l2, accum_dtype):
    """Candidate state pieces + model decrease for one line-search trial.

    For l2 == 0 the loss CHANGE is evaluated in difference form
    (_candidate_df — same numerics as gram_krylov_step's batched line
    search): the accept decision and the committed value pair then carry
    error proportional to the decrease at any gap scale, instead of the
    absolute evaluation's ~eps*|margin|/sqrt(n) noise floor (which capped
    the fp32 GramCRN rcv1-like leg at a 1.4e-7 gap in the round-4
    Figure-2 artifact while the Krylov path's difference form reached
    2.1e-11 on the same problem). l2 > 0 keeps the absolute path (the
    l2 term needs |x|^2), mirroring the Krylov step's split.

    Returns (..., dfh, dfl): the change pair, for difference-form accept
    tests; under the absolute path it is the exact pair difference."""
    adt = jnp.dtype(accum_dtype)
    s2 = rep_dot(gd, s, s, adt)
    norm_s = jnp.sqrt(jnp.maximum(s2, 0.0))
    model_dec = (lam.astype(adt) / 2.0 * s2
                 - reg.astype(adt) / 3.0 * norm_s**3
                 - rep_dot(gd, g, s, adt) / 2.0)
    gamma_new = state.gamma + s.beta
    zeta_new = state.zeta + s.w
    Ax_new, e = two_sum(state.Ax, s.u)
    Ax_lo_new = state.Ax_lo + e
    if l2:
        xsq = _x_sqnorm(gd, gamma_new, zeta_new, Ax_new, adt,
                        Ax_lo=Ax_lo_new)
        vhi, vlo = _gram_value(gd, Ax_new, xsq, l2, adt, Ax_lo=Ax_lo_new)
        dfh, err = two_sum(vhi, -state.value)
        dfl = err + (vlo - state.value_lo)
    else:
        dfh, dfl = _candidate_df(gd, state.Ax, s.u, adt)
        vhi, err = two_sum(state.value, dfh)
        vlo = state.value_lo + err + dfl
    return (gamma_new, zeta_new, Ax_new, Ax_lo_new, vhi, vlo, model_dec,
            norm_s, dfh, dfl)


def _pair64(hi, lo):
    return float(hi) + float(lo)


def _ls_accept_host(dfh, dfl, fhi, model_dec, cdt):
    """Host mirror of gram_krylov_step's difference-form accept test: the
    trial's change pair (dfh, dfl) sums exactly in fp64, so the gap the
    decision sees is the difference-form value — change-accurate near the
    floor, not absolute-evaluation noise. Second clause as in the Krylov
    step: once the model decrease is below one ulp of f, accept any
    non-increase up to the same ulp (fp64 comparisons cannot see below
    that either; at exact convergence the difference form reads
    +-eps^2-level noise rather than exactly 0)."""
    gap = _pair64(dfh, dfl)
    ulp = float(jnp.finfo(cdt).eps) * abs(float(fhi))
    md = float(model_dec)
    if not np.isfinite(gap):
        return False
    return (gap <= -md) or (md <= ulp and gap <= ulp)


def gram_crn_step(
    gd: GramData,
    state: GramKrylovState,
    l2: float = 0.0,
    beta: float = 0.5,
    solver_eps: float = 1e-8,
    solver_it_max: int = 100,
    tolerance: float = 0.0,
    ls_max: int = 200,
    cg_maxiter: int = 500,
    accum_dtype=jnp.float32,
    reg_ceil: float = 1e6,
) -> GramKrylovState:
    """One CRN-CG iteration: host-sequenced secular Newton + backtracking
    line search over jitted one-CG-solve device programs (mirrors the
    reference's control structure, cubic.py:152-182 + 190-226)."""
    cdt = state.zeta.dtype
    adt = jnp.dtype(accum_dtype)
    l2 = float(l2)

    g, g_norm_dev, D, w_new, uK_new = _grad_probe(gd, state, l2, adt)
    state = state._replace(w_g=w_new, uK=uK_new)
    g_norm = float(g_norm_dev)

    if tolerance > 0.0 and g_norm < tolerance:
        return state._replace(diff_norm=jnp.zeros((), cdt),
                              grad_norm=jnp.asarray(g_norm, cdt))

    neg_g = Rep(-g.beta, -g.w, -g.u)

    def solve(lam):
        return _cg_shifted(gd, D, neg_g, jnp.asarray(lam, adt), l2,
                           solver_eps, cg_maxiter, adt)

    def newton(reg):
        """Safeguarded 1-D Newton on phi(lam) = lam^2 - reg^2 ||s(lam)||^2
        with s(lam) = -(H + lam I)^{-1} g; two CG solves per iteration
        (one for s, one for the derivative term), like the reference's
        func/fprime pair (cubic.py:157-171).

        PSD assumption: lam is clamped at 0 only (like the reference) —
        no indefinite-H pole safeguard, because CG itself requires
        H + lam I to be PD. Logistic Hessians are PSD, so this holds on
        every oracle this solver is used with; for indefinite problems
        use the eigh path (ops/subproblem.py:78-101), whose secular
        Newton carries the pole safeguard."""
        lam = float(state.r0)
        it = 0
        while it < solver_it_max:
            s, s2_dev, _ = solve(lam)
            s2 = float(s2_dev)
            phi = lam * lam - reg * reg * s2
            hinv_s, _, _ = _cg_shifted(gd, D, s, jnp.asarray(lam, adt),
                                       l2, solver_eps, cg_maxiter, adt)
            dphi = 2.0 * lam + 2.0 * reg * reg * float(
                _rep_dot_j(gd, s, hinv_s, adt))
            step = phi / dphi
            lam = max(lam - step, 0.0)
            it += 1
            if abs(step) < solver_eps:
                break
        return lam, it

    reg = float(state.reg_coef) * beta  # optimistic decrease first
    trials = 0
    accepted = False
    while True:
        lam, newton_it = newton(reg)
        s, _, _ = solve(lam)
        (gamma_new, zeta_new, Ax_new, Ax_lo_new, vhi, vlo, model_dec,
         norm_s, dfh, dfl) = _trial_eval(gd, state, g, s,
                                         jnp.asarray(lam, adt),
                                         jnp.asarray(reg, adt), l2, adt)
        if _ls_accept_host(dfh, dfl, state.value, model_dec, cdt):
            accepted = True
            break
        if trials >= ls_max:
            break
        reg /= beta
        trials += 1

    if not accepted:
        # All-reject episode: the reference's cap-and-commit semantics
        # (cubic.py:214-220 has no cap; our ls_max bound would commit
        # the last trial) can only fire here through fp32 trial noise
        # near the numerical floor — and committing that trial was
        # observed to DIVERGE the run (round 4: the rcv1-like Figure-2
        # CRN leg's late iterations exploding to f ~ 1.6e6 while its
        # best value sat at gap 1.4e-7). Mirror gram_krylov_step's
        # policy: freeze the iterate, raise reg ONE backtracking notch,
        # report diff_norm = inf (not claiming tolerance convergence).
        # Unreachable for fp64 runs, so reference parity is unaffected.
        return state._replace(
            reg_coef=reg_clamp(state.reg_coef.astype(adt) / beta,
                               cdt, reg_ceil).astype(cdt),
            r0=jnp.asarray(lam, cdt),
            solver_it=state.solver_it + jnp.asarray(newton_it, jnp.int32),
            diff_norm=jnp.asarray(jnp.inf, cdt),
            grad_norm=jnp.asarray(g_norm, cdt),
        )

    value_new = vhi.astype(cdt)
    value_new_lo = vlo.astype(cdt)
    better = _pair64(vhi, vlo) < _pair64(state.f_best, state.f_best_lo)
    return GramKrylovState(
        gamma=gamma_new, zeta=zeta_new, Ax=Ax_new, Ax_lo=Ax_lo_new,
        w_g=state.w_g, uK=state.uK,
        value=value_new, value_lo=value_new_lo,
        reg_coef=reg_clamp(jnp.asarray(reg, cdt), cdt, reg_ceil),
        r0=jnp.asarray(lam, cdt),
        solver_it=state.solver_it + jnp.asarray(newton_it, jnp.int32),
        diff_norm=norm_s.astype(cdt),
        grad_norm=jnp.asarray(g_norm, cdt),
        f_best=value_new if better else state.f_best,
        f_best_lo=value_new_lo if better else state.f_best_lo,
    )


class GramCRN(GramKrylov):
    """Reference ``Cubic_LS`` with cubic_solver="CG", Gram-space."""

    def __init__(self, reg_coef=None, solver_it_max=100, solver_eps=1e-8,
                 beta=0.5, cg_maxiter=500, ls_max=200, *args, **kwargs):
        super().__init__(reg_coef=reg_coef, solver_eps=solver_eps,
                         beta=beta, solver_it_max=solver_it_max,
                         ls_max=ls_max, *args, **kwargs)
        self.cg_maxiter = int(cg_maxiter)

    def step(self):
        import jax.numpy as jnp

        if (self.state.zeta.dtype == jnp.float32
                and getattr(self, "_crn_verified", None) is None):
            # seed trust-but-verify from the exact initial state (it IS
            # exact: init_state computes the value in host fp64 and the
            # rep is (gamma=1, zeta=0)) — without this the FIRST
            # iteration would be accepted unconditionally, so a
            # first-step explosion would become the verified baseline
            # (advisor round-4 finding; run_fused seeds its snapshot the
            # same way)
            st0 = self.state
            self._crn_verified = dict(
                gamma=float(st0.gamma),
                zeta=np.asarray(st0.zeta, np.float64)[
                    : self.loss.A_host.shape[0]].copy(),
                f=float(st0.value) + float(st0.value_lo))
        self.state = gram_crn_step(
            self.gd, self.state,
            l2=self.loss.l2, beta=self.beta, solver_eps=self.solver_eps,
            solver_it_max=self.solver_it_max,
            tolerance=float(self.tolerance), ls_max=self.ls_max,
            cg_maxiter=self.cg_maxiter,
            accum_dtype=_accum_dtype(self.state.zeta.dtype),
            reg_ceil=max(1e6, 1e4 * float(self.reg_coef)),
        )
        if self.state.zeta.dtype == jnp.float32:
            # fp32 runs: pin the committed state to exact fp64 host
            # values every iteration (the step is host-sequenced anyway;
            # two sparse SpMVs ~ the cost of one CG iteration). Without
            # this the incremental fp32 margins floor the reachable gap
            # at ~1e-5 (measured in the round-3 Figure-2 artifact).
            # A_host is guaranteed: GramKrylov.init_state raises without
            # it (the K build needs the host matrix), so fp32 GramCRN
            # never runs correction-less — there is no device-only-data
            # drift path (advisor round-3 finding).
            self._ensure_exact_setup()
            st = self.state
            n = self.loss.A_host.shape[0]
            gamma_h = float(st.gamma)
            zeta_h = np.asarray(st.zeta, np.float64)[:n]
            v64 = self._exact_reinject(gamma_h, zeta_h)
            # ---- trust-but-verify (same reason as run_fused's): near
            # the fp32 floor, CG steps on a near-singular (H + lam I)
            # can be huge and their fp32 trial values garbage-low — the
            # accept test passes on noise, and the committed exact f
            # EXPLODES (observed: the rcv1-like Figure-2 CRN leg's tail
            # at f ~ 1.6e6 against a 1.4e-7 best gap). An iteration
            # must not increase the exact f: otherwise roll back to the
            # last verified iterate and raise reg one notch.
            prev = getattr(self, "_crn_verified", None)
            m = self.trace.metrics
            if prev is not None and v64 > prev["f"]:
                m.setdefault("rollback_its", []).append(self.it + 1)
                m.setdefault("rollback_fs", []).append(v64)
                # same scaled ceiling as every other reg clamp site
                # (reg_clamp's max(1e6, 1e4*reg_coef)); a hardcoded 1e6
                # would pin reg below what the step itself allows on
                # problems with a large legitimate reg scale
                self._exact_reinject(
                    prev["gamma"], prev["zeta"],
                    reg=min(float(st.reg_coef) / self.beta,
                            max(1e6, 1e4 * float(self.reg_coef))),
                    r0=float(st.r0), solver_it=int(st.solver_it))
                v64 = prev["f"]
            else:
                self._crn_verified = dict(gamma=gamma_h,
                                          zeta=zeta_h.copy(), f=v64)
            # record the exact value stream: these per-iteration fp64
            # host-verified values are what lets the Figure-2 artifact
            # prove its own f* anchor (curve_of / final_gaps read
            # exact_fs when present) — without them the CRN leg that
            # *defines* f_star carried fp64_verified: false
            m.setdefault("exact_its", []).append(self.it + 1)
            m.setdefault("exact_fs", []).append(v64)

    def check_convergence(self):
        if (self.tolerance > 0 and self.it > 0
                and float(self.state.grad_norm) < self.tolerance):
            return True
        return Optimizer.check_convergence(self)
