"""Lanczos tridiagonalization as a fixed-shape ``lax.scan``.

Device-native redesign of the reference's dynamic-length host loop
(/root/reference/optimizer/cubic.py:77-111):

* static subspace dimension ``m`` with *breakdown masking* instead of array
  truncation — on breakdown (beta < tol, reference line 98) the remaining
  basis rows stay zero and ``k`` records the valid count; downstream
  spectral math is automatically exact because masked rows contribute
  zero Ritz components;
* optional **full reorthogonalization** (one or two classical Gram-Schmidt
  passes against all stored vectors) — the reference's plain three-term
  recurrence loses orthogonality fast in fp32 on news20-like spectra
  (SURVEY.md §7 step 4); unfilled basis rows are zero so no masking is
  needed in the correction;
* the operator returns ``(H v, aux)`` so per-step byproducts are stacked
  and returned — the logistic solver passes ``aux = A v`` and gets the
  n x m matrix ``AV`` for free, which turns every line-search function
  evaluation into a GEMV instead of a fresh SpMV (a capability the
  reference lacks: it pays one full SpMV per trial, cubic.py:294-303).

Inner products accumulate in ``accum_dtype`` (fp64 when x64 is on).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

__all__ = ["lanczos", "LanczosResult"]


class LanczosResult(NamedTuple):
    alphas: jax.Array  # (m,) diagonal of T, masked entries zero
    betas: jax.Array  # (m-1,) off-diagonal, masked entries zero
    V: jax.Array  # (m, d) basis rows, masked rows zero
    k: jax.Array  # scalar int32: number of valid basis vectors
    beta_last: jax.Array  # final residual norm (reference's `beta` return)
    aux: jax.Array | None  # stacked per-step operator aux, leading dim m


def _dot(x, y, adt):
    return jnp.dot(x.astype(adt), y.astype(adt))


def lanczos(
    op: Callable,
    g: jax.Array,
    m: int,
    reorth_passes: int = 1,
    breakdown_tol: float = 1e-6,
    accum_dtype=jnp.float32,
):
    """Tridiagonalize the operator on the Krylov space K_m(op, g).

    ``op(v) -> (H v, aux)`` where aux may be None (use `lambda v: (Hv, 0.)`
    style wrappers for aux-free operators).
    """
    d = g.shape[0]
    cdt = g.dtype
    adt = jnp.dtype(accum_dtype)

    g_norm = jnp.sqrt(_dot(g, g, adt)).astype(cdt)
    # numerically-zero gradient (exact convergence): zero basis, not NaNs
    v0 = g / jnp.where(g_norm > 0, g_norm, 1.0)

    V0 = jnp.zeros((m, d), cdt).at[0].set(v0)

    def reorth(w, V):
        for _ in range(reorth_passes):
            coeffs = (V.astype(adt) @ w.astype(adt)).astype(cdt)
            w = w - coeffs @ V
        return w

    def body(carry, j):
        V, v_prev, v, beta_prev, active, k = carry
        Hv, aux = op(v)
        w = Hv - beta_prev * v_prev
        alpha = _dot(v, w, adt).astype(cdt)
        alpha_j = jnp.where(active, alpha, jnp.zeros((), cdt))
        w = w - alpha * v
        if reorth_passes > 0:
            w = reorth(w, V)
        beta = jnp.sqrt(_dot(w, w, adt)).astype(cdt)
        ok = jnp.abs(beta) >= jnp.asarray(breakdown_tol, cdt)
        proceed = jnp.logical_and(active, ok)
        beta_j = jnp.where(proceed, beta, jnp.zeros((), cdt))
        v_next = jnp.where(proceed, w / jnp.where(ok, beta, 1.0), v)
        v_prev_next = jnp.where(proceed, v, v_prev)
        V = jnp.where(proceed, V.at[j + 1].set(v_next), V)
        k = jnp.where(proceed, j + 2, k)
        return (
            (V, v_prev_next, v_next, beta_j, proceed, k),
            (alpha_j, beta_j, aux),
        )

    init = (
        V0,
        jnp.zeros_like(v0),
        v0,
        jnp.zeros((), cdt),
        jnp.asarray(True),
        jnp.asarray(1, jnp.int32),
    )
    (V, _, v_last, beta_last, _, k), (alphas, betas, auxs) = jax.lax.scan(
        body, init, jnp.arange(m - 1, dtype=jnp.int32)
    )

    # Final exact diagonal entry on the last valid vector
    # (reference cubic.py:109: alphas[-1] = <v, A v>).
    Hv, aux_last = op(v_last)
    alpha_last = _dot(v_last, Hv, adt).astype(cdt)
    alphas = jnp.concatenate([alphas, jnp.zeros((1,), cdt)])
    alphas = alphas.at[k - 1].set(alpha_last)

    if auxs is not None and aux_last is not None:
        # stack the m-th aux at the last valid slot so AV matches V's rows:
        # aux rows for steps taken are Av_j; row k-1 must be A v_{k-1}.
        auxs = jnp.concatenate([auxs, jnp.zeros_like(auxs[:1])])
        auxs = auxs.at[k - 1].set(aux_last)
        auxs = auxs[:m]
    return LanczosResult(alphas=alphas, betas=betas, V=V, k=k,
                         beta_last=beta_last, aux=auxs)
