"""Krylov CRN in Gram space — the flagship solver.

Same algorithm as solvers/krylov_crn.py (reference cubic.py:238-319), but
every iteration runs on dense n x n K-matvecs instead of sparse gathers
(see ops/gram.py for why: dense streaming of device memory instead of
gather/scatter). The iterate never materializes: the state carries
(gamma, zeta, margins) with x = gamma*x0 + A^T zeta.

Per iteration: m + 1 K-matvecs + O(m n) vector work + the O(m) secular
line search. Checkpoints store (gamma, zeta, margins) — loss re-evaluation
is O(n) per checkpoint with no SpMV at all; materializing an explicit x
costs one transpose SpMV, paid only on demand.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from krylov_crn_tpu.ops.gram import (
    GramData,
    Rep,
    build_gram,
    gram_lanczos,
    k_matvec,
    pad_rows,
    rep_dot,
)
from krylov_crn_tpu.ops.math import (
    accum_sum_pair,
    logsig,
    ls_accept,
    pair_diff,
    reg_clamp,
    two_sum,
)
from krylov_crn_tpu.ops.subproblem import secular_newton, tridiag_eigh
from krylov_crn_tpu.solvers.base import Optimizer
from krylov_crn_tpu.solvers.krylov_crn import _accum_dtype

__all__ = ["GramKrylov", "GramKrylovState", "gram_krylov_step"]


class GramKrylovState(NamedTuple):
    """Committed Gram-space iterate plus the fp32-tail numerics state.

    Margins are a two-float pair (Ax, Ax_lo): incremental updates are
    accumulated with error-free two-sums, so the pair tracks the exact
    margins to ~2x fp32 precision between host corrections — a plain
    fp32 margin array drifts one rounding per iteration, which round-2
    measured as accept-test corruption (f increases of 1e-4+) whenever
    exact corrections were more than ~8 iterations apart.

    (w_g, uK) maintain the *gradient image* incrementally: uK == K @ w_g
    with w_g the previous iteration's weight vector. A fresh fp32
    matvec K @ w carries absolute error ~1.3e-7*||K||*||w|| — constant
    while the true image ||A g|| -> 0, so recomputing from scratch
    drowns the tail gradient (and hence g_norm, the Lanczos start
    vector, and the whole subspace) in noise once ||g|| drops ~4 orders.
    Updating uK += K @ (w_new - w_g) makes the matvec error
    proportional to the *step-sized* dw instead: the error floor scales
    down with convergence (classic iterative-refinement structure).
    Under x64 (CPU verification) the pairs carry lo = 0 and the
    incremental path is exact to fp64 roundoff."""

    gamma: jax.Array  # coefficient of x0 in x = gamma*x0 + A^T zeta
    zeta: jax.Array  # (n_pad,)
    Ax: jax.Array  # margins hi (n_pad,), invariant: gamma*Ax0 + K zeta
    Ax_lo: jax.Array  # margins lo (two-float pair with Ax)
    w_g: jax.Array  # (n_pad,) weight vector of the last gradient image
    uK: jax.Array  # (n_pad,) == K @ w_g, maintained incrementally
    value: jax.Array  # f(x) two-float hi part (lo below; lo = 0 under x64)
    value_lo: jax.Array
    reg_coef: jax.Array
    r0: jax.Array
    solver_it: jax.Array
    diff_norm: jax.Array
    grad_norm: jax.Array
    f_best: jax.Array  # running-min f as a two-float pair
    f_best_lo: jax.Array


class GramCheckpoint(NamedTuple):
    """Stored per trace checkpoint; x materializes as gamma*x0 + A^T zeta."""

    gamma: jax.Array
    zeta: jax.Array
    Ax: jax.Array
    x_sqnorm: jax.Array


def _gram_value(gd: GramData, Ax, x_sqnorm, l2, adt, Ax_lo=None):
    """f from margins as a two-float (hi, lo) pair.

    Under x64 (CPU verification) lo = 0 and hi is the plain fp64 value; in
    fp32 device runs the pair carries ~2x fp32 precision so line-search
    accept tests and suboptimality gaps resolve below fp32 eps (the
    reference is fp64 end-to-end and needs none of this). Terms are scaled
    by 1/n *before* the reduction: each term's rounding error then enters
    at eps*|term|/n and the compensated sum keeps the total near eps^2.

    ``Ax_lo``: optional margin-pair lo part, enabling the high-accuracy
    split evaluation. phi(m) = (1-b)m - logsig(m) has a margin-LINEAR
    part whose per-term fp32 rounding scales with |m| — once iterates
    grow (|m| ~ 30+), evaluating phi directly costs ~eps*|m|/sqrt(n)
    absolute error (measured ~2.4e-9 at n=4k — enough to bias accept
    tests near the floor). Split: the linear part (1-b)*m sums as a
    compensated pair-dot against the margin PAIR (error ~eps^2-grade);
    the nonlinear remainder -logsig(m) is bounded by log 2 per term, so
    its fp32 rounding is ~eps*0.7/n per term. First-order lo correction
    on the nonlinear part only: d(-logsig)/dm = sigmoid(m) - 1."""
    scale = gd.mask / gd.n
    if Ax_lo is not None:
        from krylov_crn_tpu.ops.math import dot2

        p = ((1.0 - gd.b) * scale).astype(adt)
        hi, lo = dot2(p, Ax.astype(adt))
        lo = lo + jnp.sum(p * Ax_lo.astype(adt))
        nl = -logsig(Ax) * scale
        nhi, nlo = accum_sum_pair(nl.astype(adt), adt)
        hi, e = two_sum(hi, nhi)
        lo = lo + e + nlo
        corr = (jax.nn.sigmoid(Ax) - 1.0) * scale * Ax_lo
        lo = lo + jnp.sum(corr.astype(adt))
    else:
        terms = ((1.0 - gd.b) * Ax - logsig(Ax)) * scale
        hi, lo = accum_sum_pair(terms.astype(adt), adt)
    if l2:
        t = jnp.asarray(l2 / 2.0, adt) * x_sqnorm.astype(adt)
        hi, e = two_sum(hi, t)
        lo = lo + e
    return hi, lo


def _x_sqnorm(gd: GramData, gamma, zeta, Ax, adt, Ax_lo=None):
    """|x|^2 = g^2|x0|^2 + 2g Ax0.zeta + zeta.K zeta, with
    K zeta = Ax - g Ax0 (margins invariant)."""
    z = zeta.astype(adt)
    g = gamma.astype(adt)
    out = (g * g * gd.x0_sqnorm.astype(adt)
           + g * jnp.dot(gd.Ax0.astype(adt), z)
           + jnp.dot(z, Ax.astype(adt)))
    if Ax_lo is not None:
        out = out + jnp.dot(z, Ax_lo.astype(adt))
    return out


def _candidate_df(gd: GramData, Ax, inc_c, adt):
    """Difference-form loss change for ONE candidate margin increment:

        dphi = (1-b).delta + [softplus(-m-delta) - softplus(-m)]

    with the bracket evaluated as log1p(sigmoid(-m) * expm1(-delta)) where
    |delta| is small (the cancellation-prone regime) and as the direct
    softplus difference where |delta| >= 15 — there the difference is
    O(|delta|), not O(eps), so the direct form is accurate AND avoids the
    fp32 failure modes of the log1p form (advisor round-3 finding: for
    inc >= ~+17 with m <= -17 the product rounds to exactly -1 and log1p
    returns -inf, which the accept test then unconditionally accepts; for
    inc <= -88 expm1 overflows). Returns the change as an (hi, lo) pair.

    Module-level (rather than a closure in gram_krylov_step) so the
    extreme-margin guards are unit-testable against fp64."""
    from krylov_crn_tpu.ops.math import dot2

    n = gd.n
    p = ((1.0 - gd.b) * gd.mask / n).astype(adt)
    sig_neg = jax.nn.sigmoid(-Ax)
    scale = gd.mask / n
    lin_hi, lin_lo = dot2(p, inc_c.astype(adt))
    inc_s = jnp.clip(inc_c, -15.0, 15.0)
    nl_log1p = jnp.log1p(sig_neg * jnp.expm1(-inc_s))
    nl_direct = (jax.nn.softplus(-(Ax + inc_c))
                 - jax.nn.softplus(-Ax))
    nl = scale * jnp.where(jnp.abs(inc_c) < 15.0, nl_log1p, nl_direct)
    shi, slo = accum_sum_pair(nl.astype(adt), adt)
    hi, e = two_sum(lin_hi, shi)
    return hi, lin_lo + e + slo


def _lr_matvec(K_lr, q, cdt):
    """Low-precision K-matvec with fp32 accumulation."""
    return jax.lax.dot_general(
        K_lr, q.astype(K_lr.dtype), (((1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
    ).astype(cdt)


def _mm(a, b):
    """fp32 mat-mat product at explicit HIGHEST precision.

    Rank-2 x rank-2 fp32 products at DEFAULT precision may run at reduced
    precision on the matrix units (TF32 on the GPU: ~1e-3 relative error
    — a convergence stall once traced back to exactly this in the Vu
    refresh and the batched line-search margin updates). The package pins
    the global default (config.pin_fp32_matmul_precision), and the
    load-bearing sites use this helper so correctness doesn't hinge on
    the global."""
    return jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST)


@functools.partial(
    jax.jit,
    static_argnames=("m", "l2", "beta", "solver_eps", "solver_it_max",
                     "ls_max", "reorth_passes", "accum_dtype", "rederive",
                     "use_lr", "reg_ceil", "repl"),
)
def gram_krylov_step(
    gd: GramData,
    state: GramKrylovState,
    m: int = 10,
    l2: float = 0.0,
    beta: float = 0.5,
    solver_eps: float = 1e-8,
    solver_it_max: int = 100,
    ls_max: int = 20,
    reorth_passes: int = 1,
    accum_dtype=jnp.float32,
    rederive: bool = False,
    use_lr: bool = True,
    reg_ceil: float = 1e6,
    repl=None,
) -> GramKrylovState:
    """One Krylov-CRN iteration, accelerator-shaped:

    * Lanczos matvecs optionally use the bf16 copy of K (half the
      device-memory traffic); the committed margins are re-derived through the fp32 K so
      loss values never degrade;
    * the backtracking line search is *batched*: all ls_max+1 candidate
      regularizations are solved at once (vmapped secular Newton, one
      (L,m)x(m,n) matmul for all candidate margins) and the first
      acceptable candidate is selected — no sequential while_loop, exact
      same accept decision as the reference's loop (cubic.py:294-303).
    """
    cdt = state.zeta.dtype
    adt = jnp.dtype(accum_dtype)
    n = gd.n
    L = ls_max + 1

    gamma, zeta, Ax, Ax_lo, value = (state.gamma, state.zeta, state.Ax,
                                     state.Ax_lo, state.value)

    # gradient rep: g = l2*gamma * x0 + A^T (residual/n + l2*zeta);
    # sigma evaluated from the margin pair (first-order in lo)
    sig0 = jax.nn.sigmoid(Ax)
    sig = sig0 + sig0 * (1.0 - sig0) * Ax_lo
    residual = (sig - gd.b) * gd.mask
    w_new = residual / n + (l2 * zeta if l2 else 0.0)
    # incremental gradient image: uK == K @ w_g held by the state; the
    # fresh matvec runs on the *step-sized* dw, so its absolute error
    # ~1.3e-7*||K||*||dw|| scales down with convergence instead of
    # staying at the ~1.3e-7*||K||*||w|| floor that drowned the tail
    # gradient when the image was recomputed from scratch (round 2).
    # ``repl`` (mesh runs; a static replicated NamedSharding): pin every
    # matvec OUTPUT to replicated right after its all-gather. Without the
    # constraint GSPMD computes the Lanczos/line-search reductions on the
    # PRE-gather row-sharded operand, emitting an extra all-gather per
    # compensated dot fold (+2 bulk (L, n) gathers in the line search) —
    # 38 collectives/iteration at the bench shape. With the pin,
    # reductions on replicated
    # data lower collective-free: the (m+1) matvec gathers remain (the
    # sequential Lanczos chain structurally needs each hop's output
    # replicated) plus a handful of scalar combines.
    def _repl(x):
        if repl is None:
            return x
        from jax.sharding import NamedSharding, PartitionSpec

        from krylov_crn_tpu.parallel.mesh import DATA_AXIS

        # two-stage pin: first force the matvec OUTPUT row-sharded (so
        # the product itself stays a local (n/D x n) matvec — a single
        # replicated pin here makes GSPMD instead all-gather the whole
        # 1.7 GB K, measured), then replicate = exactly one n-vector
        # all-gather per matvec
        rowv = NamedSharding(repl.mesh, PartitionSpec(DATA_AXIS))
        x = jax.lax.with_sharding_constraint(x, rowv)
        return jax.lax.with_sharding_constraint(x, repl)

    dw = w_new - state.w_g
    uK = state.uK + _repl(k_matvec(gd, gd.K, dw))
    beta_g = jnp.asarray(l2, cdt) * gamma
    u_g = beta_g * gd.Ax0 + uK
    g = Rep(beta_g, w_new, u_g)

    D = sig * (1.0 - sig) * gd.mask / n
    # `use_lr` is a *static* switch between the bf16 Lanczos K (head
    # phase) and the full-precision K (tail): the round-2 version flipped
    # by mutating gd (K_lr -> None), which changed the pytree structure
    # and forced a mid-run recompile of the whole multistep program.
    K_lz = gd.K_lr if (use_lr and gd.K_lr is not None) else gd.K

    def hop(v: Rep) -> Rep:
        q = D * v.u
        w_H = q + (l2 * v.w if l2 else 0.0)
        if K_lz.dtype == gd.K.dtype:
            Kq = _repl(k_matvec(gd, K_lz, q))
        else:
            Kq = _repl(_lr_matvec(K_lz, q, cdt))
        u_H = Kq + (l2 * v.u if l2 else 0.0)
        return Rep(jnp.asarray(l2, cdt) * v.beta, w_H, u_H)

    lz = gram_lanczos(gd, hop, g, m, reorth_passes=reorth_passes,
                      accum_dtype=adt)
    if K_lz.dtype != gd.K.dtype:
        # bf16 K constructs the *subspace* (half the memory traffic per
        # Lanczos matvec — directions tolerate low precision), but the
        # basis IMAGES feed the line-search trial margins and the
        # committed state, where bf16's ~2e-3 relative error produces
        # accepted steps that *increase* the true f by up to ~1e-4
        # (fp64-verified). Refresh all m images through the fp32 K in
        # one symmetric GEMM: u_j = beta_j*Ax0 + K w_j, so
        # Vu = Vb x Ax0 + Vw @ K (K = K^T) — K streams once, costing
        # about one matvec's bandwidth for all m columns.
        Vu32 = lz.Vb[:, None] * gd.Ax0[None, :] + _mm(lz.Vw, gd.K)
        lz = lz._replace(Vu=Vu32)

    theta, Q = tridiag_eigh(lz.alphas.astype(adt), lz.betas.astype(adt))
    g_norm = jnp.sqrt(jnp.maximum(rep_dot(gd, g, g, adt), 0.0))
    c = g_norm * Q[0, :]

    # ---- batched line search over all candidate regularizations ----
    ks = jnp.arange(L, dtype=adt)
    regs = state.reg_coef.astype(adt) * beta * (1.0 / beta) ** ks
    lams, its = jax.vmap(
        lambda M: secular_newton(theta, c, M, state.r0.astype(adt),
                                 xtol=solver_eps, it_max=solver_it_max)
    )(regs)
    # (L, m); zero-weight modes (masked tails / exactly-converged g)
    # contribute a zero step, not 0/0
    denom = theta[None, :] + lams[:, None]
    U = jnp.where(c[None, :] != 0,
                  -c[None, :] / jnp.where(c[None, :] != 0, denom, 1.0), 0.0)
    S = U @ Q.T  # (L, m) steps in Lanczos coordinates
    norm_s = jnp.sqrt(jnp.sum(U * U, axis=1))
    model_decs = (lams / 2.0 * norm_s**2 - regs / 3.0 * norm_s**3
                  - g_norm * S[:, 0] / 2.0)
    S_c = S.astype(cdt)
    gammas = gamma + S_c @ lz.Vb  # (L,)
    zetas = zeta[None, :] + _mm(S_c, lz.Vw)  # (L, n_pad)
    # candidate margins as two-float pairs: the increment is added with
    # an error-free two-sum so the committed pair carries the exact
    # update (drift enters only through the increment's own ~1e-7 GEMM
    # rounding, which is step-sized — not through pair accumulation)
    inc = _mm(S_c, lz.Vu)  # (L, n_pad)
    Axs, inc_err = two_sum(Ax[None, :], inc)
    Axs_lo = Ax_lo[None, :] + inc_err

    if l2:
        # absolute candidate values (the l2 term needs |x|^2)
        xsqs = jax.vmap(lambda gm, zt, ax, axl: _x_sqnorm(
            gd, gm, zt, ax, adt, Ax_lo=axl))(gammas, zetas, Axs, Axs_lo)
        vhis, vlos = jax.vmap(lambda ax, axl, xq: _gram_value(
            gd, ax, xq, l2, adt, Ax_lo=axl))(Axs, Axs_lo, xsqs)
        # pair_diff structure: hi difference exact by Sterbenz, errors
        # and lo parts folded into the lo
        dfhs, errs = jax.vmap(lambda vh: two_sum(vh, -value))(vhis)
        dfls = errs + (vlos - state.value_lo)
    else:
        # ---- difference-form candidate evaluation ----
        # Direct evaluation of each candidate's f costs absolute error
        # ~eps*|margin|/sqrt(n) per trial (~2.4e-9 measured at n=4k once
        # iterates grow) — enough that the batched accept test picks
        # trials whose *noise* reads as decrease, and the committed
        # value chain drifts downhill while the true f wanders (the
        # round-3 n=4k stall). Computing the CHANGE instead is
        # relatively accurate in the change itself:
        #   dphi = (1-b) * delta + [softplus(-m-delta) - softplus(-m)]
        # with the bracket evaluated stably as
        #   log1p(sigmoid(-m) * expm1(-delta))
        # — the linear part is an exact pair-dot against the known
        # increment, the nonlinear part scales with |sigmoid'*delta|.
        # Accept decisions and the committed value pair then carry
        # error proportional to the decrease at ANY gap scale.
        dfhs, dfls = jax.vmap(
            lambda inc_c: _candidate_df(gd, Ax, inc_c, adt))(inc)
        vhis, es = jax.vmap(lambda dh: two_sum(value, dh))(dfhs)
        vlos = state.value_lo + es + dfls

    # accept test on the pair decrease: NaN-safe (NaN -> not ok). The
    # second clause mirrors ls_accept's: once the model decrease is
    # below one ulp of f, accept any non-increase up to the same ulp —
    # the reference's fp64 comparison cannot see below that either, and
    # at exact convergence the difference-form gap reads +-eps^2-level
    # noise rather than exactly 0.
    gaps_c = dfhs + dfls
    ulp = jnp.asarray(jnp.finfo(value.dtype).eps, adt) * jnp.abs(value)
    ok = ((gaps_c <= -model_decs)
          | ((model_decs <= ulp) & (gaps_c <= ulp)))
    any_ok = jnp.any(ok)
    idx = jnp.where(any_ok, jnp.argmax(ok), 0)

    # All-reject episode: the reference's cap-and-commit semantics
    # (cubic.py:294-303) would commit the last trial with its reg
    # inflated by 2^ls_max — one such episode (which fp32 trial noise
    # near the floor CAN produce, unlike fp64) pins reg at ~1e9 and the
    # recovery at x0.5/iteration freezes the run for ~30 iterations
    # (measured: the n=4k fp32 stall at gap 2.4e-6 was exactly this).
    # Instead: freeze the iterate, raise reg by ONE backtracking notch.
    # Unreachable for fp64 runs, so reference parity is unaffected.
    gamma_new = jnp.where(any_ok, gammas[idx], gamma)
    zeta_new = jnp.where(any_ok, zetas[idx], zeta)
    value_new = jnp.where(any_ok, vhis[idx], value)
    value_new_lo = jnp.where(any_ok, vlos[idx], state.value_lo)
    s_c = jnp.where(any_ok, S_c[idx], jnp.zeros_like(S_c[idx]))

    if rederive and (K_lz.dtype != gd.K.dtype or cdt == jnp.float32):
        # Re-derive the committed margins through the full-precision K
        # and refresh the value. With pair margins this is normally OFF
        # (run_fused passes rederive=False): the incremental pair is
        # *more* accurate than a fresh matvec — re-derivation injects a
        # fresh ~1.3e-7-relative matvec rounding into the committed
        # value every iteration, flooring the reachable gap (measured at
        # ~1e-5 in round 2), while the incremental pair only accumulates
        # step-sized increment errors that the host fp64 correction at
        # chunk boundaries resets. Kept for A/B and for callers without
        # a host matrix (no exact correction available).
        Ax_new = gamma_new * gd.Ax0 + _repl(k_matvec(gd, gd.K, zeta_new))
        Ax_lo_new = jnp.zeros_like(Ax_new)
        xsq_new = _x_sqnorm(gd, gamma_new, zeta_new, Ax_new, adt)
        value_new, value_new_lo = _gram_value(gd, Ax_new, xsq_new, l2, adt)
    else:
        Ax_new = jnp.where(any_ok, Axs[idx], Ax)
        Ax_lo_new = jnp.where(any_ok, Axs_lo[idx], Ax_lo)

    # ||x_new - x|| = ||V s|| in d-space, closed via the rep of the delta;
    # a frozen (all-reject) iteration reports inf, not 0 — the iterate
    # did not move but the solver is not claiming tolerance convergence
    delta = Rep(jnp.dot(s_c, lz.Vb), s_c @ lz.Vw, s_c @ lz.Vu)
    diff_norm = jnp.where(
        any_ok,
        jnp.sqrt(jnp.maximum(rep_dot(gd, delta, delta, adt), 0.0)),
        jnp.asarray(jnp.inf, adt))

    better = pair_diff(value_new, value_new_lo,
                       state.f_best, state.f_best_lo) < 0
    reg_new = jnp.where(any_ok, regs[idx],
                        state.reg_coef.astype(adt) / beta)
    return GramKrylovState(
        gamma=gamma_new, zeta=zeta_new, Ax=Ax_new, Ax_lo=Ax_lo_new,
        w_g=w_new, uK=uK,
        value=value_new, value_lo=value_new_lo,
        reg_coef=reg_clamp(reg_new, cdt, reg_ceil).astype(cdt),
        r0=jnp.where(any_ok, lams[idx], state.r0.astype(adt)).astype(cdt),
        solver_it=state.solver_it + its[idx],
        diff_norm=diff_norm.astype(cdt),
        grad_norm=g_norm.astype(cdt),
        f_best=jnp.where(better, value_new, state.f_best),
        f_best_lo=jnp.where(better, value_new_lo, state.f_best_lo),
    )


@functools.partial(
    jax.jit,
    static_argnames=("chunk", "stack_reps", "m", "l2", "beta", "solver_eps",
                     "solver_it_max", "ls_max", "reorth_passes",
                     "accum_dtype", "rederive", "use_lr", "reg_ceil",
                     "repl"),
)
def gram_krylov_multistep(gd: GramData, state: GramKrylovState,
                          chunk: int = 16, stack_reps: bool = False, **kw):
    """`chunk` iterations in one device program (no host round-trips);
    returns the final state plus per-iteration (value, grad_norm,
    diff_norm, solver_it) stacks for full-resolution tracing.

    ``stack_reps`` additionally stacks each iteration's (gamma, zeta)
    rep — chunk * n_pad * 4 B, ~2.6 MB at n=20k — letting the host
    exact-evaluate EVERY within-chunk iterate post-hoc (full-resolution
    fp64-verified curves instead of boundary-only; see run_fused's
    ``certify`` flag)."""

    def body(st, _):
        st2 = gram_krylov_step(gd, st, **kw)
        out = ((st2.value, st2.value_lo), st2.grad_norm,
               st2.diff_norm, st2.solver_it)
        if stack_reps:
            out = out + ((st2.gamma, st2.zeta),)
        return st2, out

    return jax.lax.scan(body, state, None, length=chunk)


@functools.partial(jax.jit, static_argnames=("npad", "vdt"))
def _init_state_packed(Ax0, buf, npad, vdt):
    """Construct the initial GramKrylovState from ONE packed host buffer
    [Ax_lo; w_g; uK; value_hi, value_lo, reg_coef] — one transfer instead
    of one per array, and the zeros/constants are created on device
    inside this program.

    ``vdt`` is the state's value dtype (the accum dtype: fp64 under x64
    verification runs, else the storage dtype). The buffer carries the
    value as a storage-dtype two-float pair; when vdt is wider the pair
    collapses into one exact wide scalar (hi + lo recovers the fp64
    value to pair precision) with lo = 0, matching the step's carry
    types."""
    cdt = Ax0.dtype
    Ax_lo, w0, uK0 = buf[:npad], buf[npad:2 * npad], buf[2 * npad:3 * npad]
    s = buf[3 * npad:3 * npad + 3]
    if jnp.dtype(vdt) == cdt:
        value, value_lo = s[0], s[1]
    else:
        value = s[0].astype(vdt) + s[1].astype(vdt)
        value_lo = jnp.zeros((), vdt)
    zero = jnp.zeros((), cdt)
    return GramKrylovState(
        gamma=jnp.ones((), cdt), zeta=jnp.zeros(npad, cdt),
        Ax=Ax0, Ax_lo=Ax_lo, w_g=w0, uK=uK0,
        value=value, value_lo=value_lo,
        reg_coef=s[2], r0=jnp.asarray(0.1, cdt),
        solver_it=jnp.zeros((), jnp.int32),
        diff_norm=zero + jnp.inf, grad_norm=zero + jnp.inf,
        f_best=value, f_best_lo=value_lo,
    )


@functools.partial(jax.jit, static_argnames=("npad", "full"))
def _apply_correction(state: GramKrylovState, buf: jax.Array, npad: int,
                      full: bool = False):
    """Unpack one host-corrected buffer [margins; lo; w_g; uK; scalars,
    padded to 5*npad] into the state — one transfer + one dispatch.

    ``full`` additionally restores gamma/zeta/reg_coef/r0/solver_it from
    the buffer (rollback to a verified boundary snapshot); the scalar
    block is [vhi, vlo, bhi, blo, gamma, reg, r0, solver_it] followed by
    zeta at buf[-npad:]... zeta is packed in rows (see _pack_exact)."""
    m, m_lo, w, uK = (buf[:npad], buf[npad:2 * npad],
                      buf[2 * npad:3 * npad], buf[3 * npad:4 * npad])
    s = buf[4 * npad:4 * npad + 8]
    st = state._replace(Ax=m, Ax_lo=m_lo, w_g=w, uK=uK,
                        value=s[0], value_lo=s[1],
                        f_best=s[2], f_best_lo=s[3])
    if full:
        st = st._replace(gamma=s[4], reg_coef=s[5], r0=s[6],
                         solver_it=s[7].astype(jnp.int32),
                         zeta=buf[5 * npad:6 * npad],
                         diff_norm=jnp.asarray(jnp.inf, m.dtype),
                         grad_norm=jnp.asarray(jnp.inf, m.dtype))
    return st


@functools.partial(jax.jit, static_argnames=("adt",))
def _checkpoint_of(gd: GramData, state: GramKrylovState, adt):
    """Chunk-boundary checkpoint pieces in ONE dispatch (the eager
    op-by-op x_sqnorm was a dispatch per op)."""
    xsq = _x_sqnorm(gd, state.gamma, state.zeta, state.Ax, adt,
                    Ax_lo=state.Ax_lo)
    return GramCheckpoint(gamma=state.gamma, zeta=state.zeta,
                          Ax=state.Ax, x_sqnorm=xsq)


def _dev_like(arr, like):
    """Device-put a host array with the sharding of an existing array
    (mesh runs: reinjected state must not silently drop its sharding)."""
    a = jnp.asarray(arr)
    try:
        sh = getattr(like, "sharding", None)
        return jax.device_put(a, sh) if sh is not None else a
    except Exception:
        return a


class RepMaterializer:
    """Picklable rep -> x converter: x = gamma * x0 + A^T zeta.

    Travels inside pickled traces (Trace.save nulls the loss handle and
    Trace.from_pickle re-attaches it), so distance plots and loss
    re-evaluation work on reloaded Gram traces whose checkpoints are
    compact (gamma, zeta, Ax) reps rather than explicit d-vectors."""

    def __init__(self, x0, loss=None):
        self.x0 = np.asarray(x0, np.float64)
        self.loss = loss

    def __call__(self, ck):
        if self.loss is None:
            raise ValueError(
                "RepMaterializer has no loss attached; load the trace via "
                "Trace.from_pickle(path, loss=...) to materialize iterates")
        A = getattr(self.loss, "A_host", None)
        if A is not None:
            # host sparse transpose SpMV (~ms): avoids building the
            # device COO pytree just to materialize a checkpoint (the
            # loss builds its device data lazily; a Gram run otherwise
            # never needs it)
            z = np.asarray(ck.zeta, np.float64)[: A.shape[0]]
            x = float(ck.gamma) * self.x0 + A.T.dot(z)
            return jnp.asarray(x.astype(np.asarray(ck.zeta).dtype))
        from krylov_crn_tpu.ops.spmv import rmatvec

        data = self.loss.data
        z = jnp.asarray(ck.zeta)[: data.n]
        at = rmatvec(data, z.astype(self.loss.b.dtype))
        return jnp.asarray(ck.gamma, at.dtype) * jnp.asarray(
            self.x0, at.dtype) + at


class GramKrylov(Optimizer):
    """Krylov CRN over the Gram-space representation.

    Drop-in for CubicKrylov on problems with n small enough for a dense
    n x n K (<~45k rows at fp32 / 8 GB). Requires the oracle to retain its
    host scipy matrix (LogisticRegression does) for the one-time K build.
    """

    def __init__(self, reg_coef=None, subspace_dim=100, solver_eps=1e-8,
                 beta=0.5, solver_it_max=100, ls_max=20, reorth_passes=1,
                 cache_dir=None, mesh=None, fp32_tail_rtol=1e-3,
                 gram_data=None, bf16_head=False, *args, **kwargs):
        super().__init__(*args, **kwargs)
        # a pre-built GramData skips the one-time K build (must have been
        # built with the same A and the same x0 — checked in init_state)
        self._gd_preset = gram_data
        self.subspace_dim = int(subspace_dim)
        self.solver_eps = float(solver_eps)
        self.solver_it_max = int(solver_it_max)
        self.beta = float(beta)
        self.ls_max = int(ls_max)
        self.reorth_passes = int(reorth_passes)
        self.cache_dir = cache_dir
        self.mesh = mesh
        # mesh runs: replicated sharding pin for matvec outputs (static
        # jit arg — see gram_krylov_step's ``repl``); hashable, so it
        # rides the jit cache key like the other static kwargs
        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec

            self._repl = NamedSharding(mesh, PartitionSpec())
        else:
            self._repl = None
        # ``bf16_head``: start Lanczos on a bf16 copy of K (half the
        # memory traffic per matvec) and switch to the fp32 K once the gradient
        # norm has dropped by fp32_tail_rtol. Default OFF (round-4
        # measurement, PROBLEM_VERSION 4 rcv1-like): the bf16 subspace
        # makes no progress on low-curvature directions, pushing the
        # 1e-8 crossing from iteration 33 to 57 — the ~40%/matvec
        # bandwidth saving lost 2.8x of wall clock. Worthwhile only on
        # spectra the head phase fully resolves (news20-like: ~0.15 s).
        self.bf16_head = bool(bf16_head)
        self.fp32_tail_rtol = float(fp32_tail_rtol)
        self._gn_first = None
        self._use_lr = self.bf16_head
        self.reg_coef = (self.loss.hessian_lipschitz if reg_coef is None
                         else float(reg_coef))
        self.gd: GramData | None = None
        self._x0_host = None

    def _maybe_enter_fp32_tail(self, grad_norm):
        """Switch Lanczos off the bf16 K once the tail begins.

        The baseline ``_gn_first`` is the FIRST recorded gradient norm
        (iteration 1; run_fused seeds it from the first entry of the
        first chunk's grad-norm stack). The round-2 version baselined at
        the first chunk *boundary* (it=chunk, after the large early
        drop), so the 1e3x-drop trigger was unreachable and the switch
        never fired. The switch flips a static jit flag (`use_lr`), not
        the gd pytree, so it costs one cached compile, not a rebuild."""
        if not self._use_lr or self.gd is None or self.gd.K_lr is None:
            return
        if not np.isfinite(grad_norm):
            return
        if self._gn_first is None:
            self._gn_first = grad_norm
            return
        if grad_norm < self.fp32_tail_rtol * self._gn_first:
            self._use_lr = False

    def init_state(self, x0, seed):
        loss = self.loss
        A = getattr(loss, "A_host", None)
        if A is None:
            raise ValueError(
                "GramKrylov needs the oracle's host scipy matrix "
                "(construct LogisticRegression from a scipy matrix)")
        x0h = np.asarray(x0, np.float64)
        self._x0_host = x0h
        self._gn_first = None
        self._use_lr = self.bf16_head
        # clear lazily-cached exact-correction constants: a second run on
        # the same instance with a different x0 must not reinject exact
        # margins computed from the stale x0, nor leak the previous run's
        # _f_best_exact into this run (advisor round-3 finding);
        # _ensure_exact_setup / run_fused recompute them per run
        self._Ax0_64 = None
        self._b01_64 = None
        self._f_best_exact = None
        self._crn_verified = None  # GramCRN's trust-but-verify snapshot
        dtype = np.dtype(loss.b.dtype)
        cdt = jnp.dtype(dtype)
        adt = _accum_dtype(cdt)
        npad = pad_rows(A.shape[0])

        # exact fp64 margins pair + initial gradient image (w_g, uK) on
        # the host (three sparse SpMVs, one-time): seeds the incremental
        # invariants exactly instead of with a device matvec's noise
        from scipy.special import expit

        n_real = A.shape[0]
        m64 = A.dot(x0h)
        b64 = np.asarray(loss.b, np.float64)[:n_real]
        w64 = (expit(m64) - b64) / n_real  # zeta = 0: no l2 term yet
        uK64 = A.dot(A.T.dot(w64))
        # initial f exactly in host fp64 (the margins m64 are already
        # exact): no eager device reductions at init — each eager op is
        # a compile + a dispatch
        ls = np.where(m64 < 0, m64 - np.log1p(np.exp(m64)),
                      -np.log1p(np.exp(-m64)))
        value64 = float(np.mean((1.0 - b64) * m64 - ls))
        if loss.l2:
            value64 += 0.5 * loss.l2 * float(x0h @ x0h)
        # packed initial-state buffer: value rides as a storage-dtype
        # two-float pair, collapsed to the accum dtype in-program.
        # Ax_lo = m64 - fl(Ax0): fl(Ax0) computed with the same host
        # cast the build uses for the device Ax0 — bit-identical, no
        # device fetch needed.
        cd = np.dtype(dtype)
        vhi = cd.type(value64)
        buf = np.zeros(3 * npad + 3, dtype)
        buf[:n_real] = (m64 - m64.astype(dtype).astype(np.float64)
                        ).astype(dtype)
        buf[npad:npad + n_real] = w64.astype(dtype)
        buf[2 * npad:2 * npad + n_real] = uK64.astype(dtype)
        buf[3 * npad:3 * npad + 3] = (vhi, cd.type(value64 - float(vhi)),
                                      self.reg_coef)
        self.loss.reset()
        self.trace.solver_its = [0]

        if self._gd_preset is not None:
            gd = self._gd_preset
            if not np.isclose(float(gd.x0_sqnorm), float(x0h @ x0h),
                              rtol=1e-5):
                raise ValueError(
                    "gram_data was built for a different x0 "
                    f"(|x0|^2={float(gd.x0_sqnorm):.6g} vs "
                    f"{float(x0h @ x0h):.6g})")
            self.gd = gd
        elif (self.mesh is None and self.cache_dir is None
              and jax.default_backend() != "cpu"):
            # fused build: K build + bf16 copy + aux unpack + initial
            # state in the minimum number of device programs (one for
            # single-segment builds instead of five)
            from krylov_crn_tpu.ops.gram import build_gram_fused

            # the bf16 K copy is only built when the bf16 head phase is
            # enabled (saves ~n_pad^2 * 2 B of HBM and the copy pass)
            self.gd, flat = build_gram_fused(
                A, np.asarray(loss.b)[:n_real], x0h, buf, dtype,
                jnp.dtype(adt),
                low_res_lanczos=self.bf16_head
                and np.dtype(dtype) == np.float32)
            return GramKrylovState(*flat)
        else:
            self.gd = build_gram(A, np.asarray(loss.b)[: A.shape[0]], x0h,
                                 dtype=dtype, cache_dir=self.cache_dir,
                                 mesh=self.mesh,
                                 low_res_lanczos=self.bf16_head
                                 and np.dtype(dtype) == np.float32)
        Ax = self.gd.Ax0
        return _init_state_packed(Ax, _dev_like(buf, Ax), npad,
                                  jnp.dtype(adt))

    def step(self):
        self.state = gram_krylov_step(
            self.gd, self.state,
            m=self.subspace_dim, l2=self.loss.l2, beta=self.beta,
            solver_eps=self.solver_eps, solver_it_max=self.solver_it_max,
            ls_max=self.ls_max, reorth_passes=self.reorth_passes,
            accum_dtype=_accum_dtype(self.state.zeta.dtype),
            use_lr=self._use_lr,
            reg_ceil=max(1e6, 1e4 * float(self.reg_coef)),
            repl=self._repl,
        )
        self._maybe_enter_fp32_tail(float(self.state.grad_norm))

    # ---- trace integration (checkpoints are reps, not iterates) ----
    def update_trace(self):
        st = self.state
        adt = _accum_dtype(st.zeta.dtype)
        ck = _checkpoint_of(self.gd, st, adt)
        self.trace.xs.append(ck)
        self.trace.ts.append(self.t)
        self.trace.its.append(self.it)
        self.trace.solver_its.append(int(st.solver_it))

    def init_run(self, x0, seed):
        super().init_run(x0, seed)
        # replace the base class's raw-x0 first checkpoint with a rep.
        # At x = x0 the checkpoint is closed-form (gamma=1, zeta=0,
        # Ax=Ax0, |x|^2 = |x0|^2) from arrays that already exist on
        # device — zero dispatches (a jitted _checkpoint_of here costs a
        # per-process executable load ~0.4 s inside the timed build)
        st = self.state
        self.trace.xs = [GramCheckpoint(
            gamma=st.gamma, zeta=st.zeta, Ax=st.Ax,
            x_sqnorm=self.gd.x0_sqnorm)]
        # checkpoints are reps; plotting/analysis that needs explicit
        # iterates converts through this (one transpose SpMV each); the
        # converter is picklable and survives Trace.save/from_pickle
        self.trace.materializer = RepMaterializer(self._x0_host, self.loss)

    def _ensure_exact_setup(self):
        """Lazy init of the host fp64 constants _exact_correct needs, so
        step-by-step runs (not only run_fused) can use corrections."""
        if getattr(self, "_Ax0_64", None) is None:
            A = self.loss.A_host
            n = A.shape[0]
            self._Ax0_64 = A.dot(np.asarray(self._x0_host, np.float64))
            self._b01_64 = np.asarray(self.loss.b, np.float64)[:n]
            self._f_best_exact = (float(self.state.value)
                                  + float(self.state.value_lo))

    def _exact_correct(self, gamma_h=None, zeta_h=None):
        """Exact fp64 margins/value on host, reinjected into device state.

        The incremental fp32 margin updates drift by one rounding per
        iteration; this recomputes the committed margins exactly through
        the *sparse* A on the host (two scipy SpMVs per chunk boundary —
        milliseconds; the rep x = gamma*x0 + A^T zeta makes the exact
        margins A x = gamma*Ax0 + A(A^T zeta) available without K) and
        reinjects them, so drift never spans more than one chunk. The
        returned value is the exact fp64 f at the current iterate — the
        trace records it, making boundary gap readings ground truth
        rather than fp32 readouts. The running-best f (state pair + the
        oracle's f_opt protocol) is likewise pinned to exact boundary
        values only: within-chunk device values carry ~1e-6 noise and
        must not define the empirical f*."""
        from scipy.special import expit

        self._ensure_exact_setup()
        st = self.state
        n = self.loss.A_host.shape[0]
        # callers that already hold host copies pass them in — every
        # separate device fetch is a host round trip
        gamma = float(st.gamma) if gamma_h is None else float(gamma_h)
        zeta = np.asarray(st.zeta if zeta_h is None else zeta_h,
                          np.float64)[:n]
        return self._exact_reinject(gamma, zeta)

    def _exact_reinject(self, gamma, zeta64, reg=None, r0=None,
                        solver_it=None):
        """Exact fp64 (margins, value, gradient image) from a host
        (gamma, zeta) rep, reinjected as one packed transfer + one
        dispatch. With reg/r0/solver_it given, also restores those — the
        rollback path of run_fused's trust-but-verify loop."""
        from scipy.special import expit

        st = self.state
        A = self.loss.A_host
        n = A.shape[0]
        full = reg is not None
        t = A.T.dot(zeta64)  # = A^T zeta, the rep's d-vector (exact)
        margins = gamma * self._Ax0_64 + A.dot(t)
        ls = np.where(margins < 0, margins - np.log1p(np.exp(margins)),
                      -np.log1p(np.exp(-margins)))
        value64 = float(np.mean((1.0 - self._b01_64) * margins - ls))
        if self.loss.l2:
            x = gamma * np.asarray(self._x0_host, np.float64) + t
            value64 += 0.5 * self.loss.l2 * float(x @ x)
        # exact gradient image: resets the incremental (w_g, uK)
        # invariant so in-chunk matvec drift never spans two chunks
        w64 = (expit(margins) - self._b01_64) / n
        if self.loss.l2:
            w64 = w64 + self.loss.l2 * zeta64
        uK64 = A.dot(A.T.dot(w64))
        cdt = np.dtype(st.Ax.dtype)
        npad = st.Ax.shape[0]
        # scalars keep the state's value dtype (fp32 pairs on device; fp64
        # under x64 verification, where the step accumulates in fp64)
        vdt = np.dtype(st.value.dtype)
        vhi = vdt.type(value64)
        vlo = vdt.type(value64 - float(vhi))
        self._f_best_exact = min(self._f_best_exact, value64)
        bhi = vdt.type(self._f_best_exact)
        blo = vdt.type(self._f_best_exact - float(bhi))
        # ONE packed device transfer + one jitted unpack instead of one
        # transfer per array. Row blocks of npad so a row-sharded
        # placement stays divisible.
        buf = np.zeros((6 if full else 5) * npad, cdt)
        buf[:n] = margins.astype(cdt)
        buf[npad:npad + n] = (margins
                              - buf[:n].astype(np.float64)).astype(cdt)
        buf[2 * npad:2 * npad + n] = w64.astype(cdt)
        buf[3 * npad:3 * npad + n] = uK64.astype(cdt)
        buf[4 * npad:4 * npad + 4] = (vhi, vlo, bhi, blo)
        if full:
            buf[4 * npad + 4:4 * npad + 8] = (gamma, reg, r0,
                                              float(solver_it))
            buf[5 * npad:5 * npad + n] = zeta64.astype(cdt)
        buf_d = _dev_like(buf, st.Ax)
        self.state = _apply_correction(st, buf_d, npad, full=full)
        if np.dtype(st.value.dtype) != cdt:
            # x64 verification path: value scalars live in the accum
            # dtype — restore it (the packed buffer carries cdt)
            self.state = self.state._replace(
                value=self.state.value.astype(st.value.dtype),
                value_lo=self.state.value_lo.astype(st.value.dtype),
                f_best=self.state.f_best.astype(st.value.dtype),
                f_best_lo=self.state.f_best_lo.astype(st.value.dtype))
        return value64

    def _fused_kwargs(self, cert):
        """The EXACT static-kwarg set of run_fused's multistep calls
        (minus chunk/use_lr). jax.jit keys its cache on passed-vs-
        defaulted static kwargs separately — an omitted `rederive=False`
        in a warm-up call warms a DIFFERENT cache entry than the
        explicit one in the run, and the run then pays the per-entry
        executable load inside the timed race. Warm-ups must build their
        calls from this dict."""
        cdt = self.state.zeta.dtype
        return dict(
            m=self.subspace_dim, l2=self.loss.l2, beta=self.beta,
            solver_eps=self.solver_eps, solver_it_max=self.solver_it_max,
            ls_max=self.ls_max, reorth_passes=self.reorth_passes,
            accum_dtype=_accum_dtype(cdt), rederive=False,
            stack_reps=cert,
            reg_ceil=max(1e6, 1e4 * float(self.reg_coef)),
            repl=self._repl,
        )

    def warm_fused(self, chunk=16, certify=False):
        """Execute-once warm-up of every device program a subsequent
        run_fused(chunk=..., certify=...) will dispatch (both use_lr
        phases, the correction unpack, the chunk checkpoint) — one-time
        per-process costs (compile or persistent-cache executable load)
        that benchmarks keep outside their timed region. Requires an initialized state
        (call init_run first)."""
        if self.state is None:
            raise ValueError("warm_fused needs an initialized state")
        cdt = self.state.zeta.dtype
        exact = cdt == jnp.float32 and \
            getattr(self.loss, "A_host", None) is not None
        kw = self._fused_kwargs(bool(certify) and exact)
        for lr in (True, False) if self.gd.K_lr is not None else (False,):
            st, _ = gram_krylov_multistep(self.gd, self.state, chunk=chunk,
                                          use_lr=lr, **kw)
            float(st.value)
        npad = self.gd.n_padded
        _apply_correction(self.state, jnp.zeros(5 * npad, cdt), npad)
        _checkpoint_of(self.gd, self.state, _accum_dtype(cdt))

    def run_fused(self, x0, it_max, t_max=np.inf, chunk=16, seed=42,
                  exact_correction=True, certify=False):
        """Device-fused run: `chunk` iterations per dispatch (lax.scan),
        host sync only at chunk boundaries. Produces a *full-resolution*
        loss-vs-iteration trace (the reference can only subsample,
        optimizer.py:136-145); wall-times are interpolated within chunks.

        ``exact_correction`` (fp32 runs with a host scipy matrix): at
        every chunk boundary the margins, gradient image and f are
        recomputed exactly in fp64 on the host and reinjected (see
        _exact_correct). Boundary entries of the loss trace are then
        exact; the full-resolution entries in between are device fp32
        readings (~1e-6 noise) — consumers chasing 1e-8 gaps should use
        metrics["exact_its"] / metrics["exact_fs"]. The correction's
        wall cost stays INSIDE the timed trace deliberately: it drives
        the committed state (drift reset), so it is part of the
        algorithm, not instrumentation."""
        import time as _time

        self.t_max = t_max
        self.it_max = it_max
        if not self.initialized:
            self.init_run(jnp.asarray(x0), seed)
            self.initialized = True
        cdt = self.state.zeta.dtype
        exact = (exact_correction and cdt == jnp.float32
                 and getattr(self.loss, "A_host", None) is not None)
        if exact:
            A = self.loss.A_host
            n = A.shape[0]
            self._Ax0_64 = A.dot(np.asarray(self._x0_host, np.float64))
            self._b01_64 = np.asarray(self.loss.b, np.float64)[:n]
            self._f_best_exact = float(self.state.value) \
                + float(self.state.value_lo)
        cert0 = bool(certify) and exact
        kw = self._fused_kwargs(cert0)
        v0h, v0l = jax.device_get((self.state.value, self.state.value_lo))
        self.trace.loss_vals = [float(v0h) + float(v0l)]
        metrics = self.trace.metrics
        metrics.setdefault("grad_norm", [])
        metrics.setdefault("diff_norm", [])
        if exact:
            metrics.setdefault("exact_its", [])
            metrics.setdefault("exact_fs", [])
            # verify-loop observability: iteration counter at each
            # rollback and the exact f the rejected chunk produced
            metrics.setdefault("rollback_its", [])
            metrics.setdefault("rollback_fs", [])
        cert = cert0
        cert_stacks = []  # (first_it, reps-on-device) of accepted chunks
        t_start = _time.perf_counter()
        t_prev = 0.0
        n_real = self.gd.n
        chunk_cur = chunk
        rollbacks = 0
        rejects_at_1 = 0
        if exact:
            # the initial state is host-exact (init_state): it is the
            # first verified snapshot for the trust-but-verify loop
            snap = dict(gamma=1.0, zeta=np.zeros(n_real),
                        reg=float(self.reg_coef), r0=0.1, solver_it=0,
                        f=self.trace.loss_vals[0])
        while self.it < it_max:
            k = int(min(chunk_cur, it_max - self.it))
            # incremental pair margins are the accurate choice in every
            # phase (see GramKrylovState): re-derivation would inject a
            # fresh matvec rounding into the committed value each
            # iteration; the exact boundary correction (fp32 runs)
            # additionally zeroes inter-chunk drift.
            self.state, outs = gram_krylov_multistep(
                self.gd, self.state, chunk=k, use_lr=self._use_lr, **kw)
            vpairs, gns, dns, sits = outs[:4]
            reps = outs[4] if cert else None
            # ONE bundled host fetch per chunk: every separate fetch is a
            # host round trip (five fetches plus the correction's two
            # would be seven per chunk)
            fetch = (vpairs[0], vpairs[1], gns, dns, sits)
            if exact:
                fetch += (self.state.gamma, self.state.zeta,
                          self.state.reg_coef, self.state.r0)
            got = jax.device_get(fetch)
            now = _time.perf_counter() - t_start
            vals = (np.asarray(got[0], np.float64)
                    + np.asarray(got[1], np.float64))
            gns = np.asarray(got[2], np.float64)
            dns = np.asarray(got[3], np.float64)
            sits = got[4]
            if exact:
                gamma_h = float(got[5])
                zeta_h = np.asarray(got[6], np.float64)[:n_real]
                value64 = self._exact_reinject(gamma_h, zeta_h)
                # ---- trust-but-verify: the device accept tests run on
                # fp32 trial values whose noise is selection-biased (the
                # batched search prefers trials whose noise reads low —
                # measured: device f "decreasing" ~5e-8/it while exact f
                # stalls). A chunk must IMPROVE THE EXACT f to be kept;
                # otherwise roll back to the last verified snapshot and
                # halve the chunk. At chunk=1 repeated failures raise
                # reg one notch each try; persistent failure ends the
                # run at an exact-verified fp32 floor. Monotone exact
                # boundary values by construction. Accepted superlinear
                # runs (the benchmark datasets) never roll back and pay
                # only the bundled scalar fetches.
                if value64 >= snap["f"]:
                    rollbacks += 1
                    metrics["rollback_its"].append(self.it)
                    metrics["rollback_fs"].append(value64)
                    if rollbacks >= 64:
                        self._exact_reinject(
                            snap["gamma"], snap["zeta"], reg=snap["reg"],
                            r0=snap["r0"], solver_it=snap["solver_it"])
                        break
                    if k == 1:
                        rejects_at_1 += 1
                        if rejects_at_1 >= 6:
                            break
                    else:
                        # drop straight to single-iteration verification:
                        # every DISTINCT scan length compiles its own
                        # multistep program (seconds each), so a halving
                        # ladder (8, 4, 2, ...)
                        # burns more wall clock in compiles than the
                        # iterations it saves
                        chunk_cur = 1
                    # retry reg policy: RESET to the base scale (the
                    # dominant failure mode near the fp32 floor is
                    # reg inflated so high that genuine decreases fall
                    # below the trial-evaluation noise — raising reg
                    # further spirals); escalate from base only on
                    # repeated single-iteration failures.
                    self._exact_reinject(
                        snap["gamma"], snap["zeta"],
                        reg=float(self.reg_coef) * (4.0 ** rejects_at_1),
                        r0=snap["r0"], solver_it=snap["solver_it"])
                    t_prev = now
                    self.t = now
                    if now >= t_max:
                        break
                    continue
                rejects_at_1 = 0
                chunk_cur = chunk
                snap = dict(gamma=gamma_h, zeta=zeta_h.copy(),
                            reg=float(got[7]), r0=float(got[8]),
                            solver_it=int(sits[k - 1]), f=value64)
            metrics["grad_norm"].extend(gns[:k])
            metrics["diff_norm"].extend(dns[:k])
            if self._gn_first is None and np.isfinite(gns[0]):
                self._gn_first = float(gns[0])
            self._maybe_enter_fp32_tail(float(np.min(gns[:k])))
            for j in range(k):
                self.it += 1
                self.trace.its.append(self.it)
                self.trace.ts.append(t_prev + (now - t_prev) * (j + 1) / k)
                self.trace.loss_vals.append(float(vals[j]))
                self.trace.solver_its.append(int(sits[j]))
            if exact:
                self.trace.loss_vals[-1] = value64
                metrics["exact_its"].append(self.it)
                metrics["exact_fs"].append(value64)
            if cert:
                # keep the rep stacks ON DEVICE during the race (~2.6 MB
                # each; fetching them inline would add a transfer to
                # every chunk) — _certify_stacks pulls them after
                # the timed loop, like the reference's post-run
                # compute_loss_of_iterates pass
                cert_stacks.append((self.it - k + 1, k, reps))
            t_prev = now
            self.t = now
            # checkpoint the rep at chunk boundaries (for materialization)
            self.update_trace_checkpoint_only()
            if (self.tolerance > 0 and np.isfinite(dns[k - 1])
                    and dns[k - 1] < self.tolerance):
                break
            if now >= t_max:
                break
        if cert and cert_stacks:
            self._certify_stacks(cert_stacks, metrics)
        self.trace.loss_vals = np.asarray(self.trace.loss_vals)
        if exact:
            f_best = self._f_best_exact
        else:
            f_best = float(self.state.f_best) + float(self.state.f_best_lo)
        if f_best < self.loss.f_opt:
            self.loss.f_opt = f_best
            self.loss.x_opt = self.current_x()
        self.initialized = False
        self.finished_seeds.append(seed)
        return self.trace

    def _certify_stacks(self, cert_stacks, metrics):
        """Post-run exact fp64 host evaluation of EVERY stacked iterate
        (run_fused ``certify=True``): upgrades the exact_its/exact_fs
        series from chunk-boundary resolution to full per-iteration
        resolution — each value computed from the committed (gamma, zeta)
        rep through the sparse host matrix, the same ground-truth path as
        the chunk-boundary corrections. Runs AFTER the timed loop: two
        host SpMVs per iterate (~15 ms at rcv1 scale) would otherwise
        inflate every chunk.

        The trace's interpolated within-chunk timestamps are unchanged —
        this refines the VALUES at those timestamps, so a crossing that
        happened mid-chunk is certified at its interpolated time instead
        of being deferred to the boundary (the reference records
        per-iteration times natively; boundary-only detection
        under-reports our crossing by up to one chunk)."""
        A = self.loss.A_host
        n_real = self.gd.n
        exact_its, exact_fs = [], []
        for first_it, k, reps in cert_stacks:
            g_dev, z_dev = reps
            got = jax.device_get((g_dev, z_dev))
            gammas = np.asarray(got[0], np.float64)[:k]
            zetas = np.asarray(got[1], np.float64)[:k, :n_real]
            for j in range(len(gammas)):
                it = first_it + j
                t = A.T.dot(zetas[j])
                margins = gammas[j] * self._Ax0_64 + A.dot(t)
                ls = np.where(margins < 0,
                              margins - np.log1p(np.exp(margins)),
                              -np.log1p(np.exp(-margins)))
                v64 = float(np.mean((1.0 - self._b01_64) * margins - ls))
                if self.loss.l2:
                    x = (gammas[j] * np.asarray(self._x0_host, np.float64)
                         + t)
                    v64 += 0.5 * self.loss.l2 * float(x @ x)
                exact_its.append(it)
                exact_fs.append(v64)
                # the full-resolution trace entry becomes ground truth
                if it < len(self.trace.loss_vals):
                    self.trace.loss_vals[it] = v64
                self._f_best_exact = min(self._f_best_exact, v64)
        metrics["exact_its"] = exact_its
        metrics["exact_fs"] = exact_fs

    def update_trace_checkpoint_only(self):
        adt = _accum_dtype(self.state.zeta.dtype)
        self.trace.xs.append(_checkpoint_of(self.gd, self.state, adt))

    def materialize(self, ck: GramCheckpoint):
        """x = gamma * x0 + A^T zeta (one transpose SpMV, on demand)."""
        return RepMaterializer(self._x0_host, self.loss)(ck)

    def current_x(self):
        """Materialized current iterate (for loss.x_opt tracking; the
        state carries the rep, not x). Monotone line-search runs end at
        their running-best iterate, so this is the argmin iterate in the
        reference's sense (loss.py:66-73)."""
        st = self.state
        return np.asarray(self.materialize(GramCheckpoint(
            gamma=st.gamma, zeta=st.zeta, Ax=st.Ax,
            x_sqnorm=jnp.zeros((), st.Ax.dtype))))

    def compute_loss_of_iterates(self):
        """O(n) per checkpoint from stored margins — no SpMV re-eval pass
        (the reference pays one full SpMV per stored iterate,
        opt_trace.py:39-43).

        The re-evaluated values fold into ``loss.f_opt`` only under x64
        (where they are fp64-exact). On fp32 runs the checkpoints store
        only the margin hi part, so these readings carry ~eps*|margin|
        noise — letting them define the empirical f* violates the rule
        that device readings must not define f* (the exact host-verified
        boundary values, already folded by run_fused / the step-by-step
        exact corrections, are the f* source on fp32 paths)."""
        if len(self.trace.loss_vals):
            return
        x64 = jax.config.read("jax_enable_x64")
        adt = jnp.float64 if x64 else jnp.float32
        vals = []
        for ck in self.trace.xs:
            hi, lo = _gram_value(self.gd, ck.Ax, ck.x_sqnorm,
                                 self.loss.l2, adt)
            v = float(hi) + float(lo)
            if x64 and v < self.loss.f_opt:
                self.loss.f_opt = v
            vals.append(v)
        self.trace.loss_vals = np.asarray(vals)
