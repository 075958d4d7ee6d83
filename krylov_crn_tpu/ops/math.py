"""Elementwise math + compensated (double-single) accumulation.

The reference's numba-jitted piecewise ``logsig`` and scipy ``expit``
(/root/reference/optimizer/loss.py:161-176, 225) become jax.nn primitives,
which use the same numerically-stable formulations and fuse into the
surrounding XLA graphs.

The second half of this module is the fp32 numerics layer that lets the
fp32 device solver resolve 1e-9 suboptimality gaps (BASELINE.md convergence-parity
row) without fp64 bulk arithmetic: sums and dot products are carried as
**two-float pairs** (hi, lo) where hi = fl(sum) and lo holds the rounding
residue (Knuth two-sum / Dekker two-product, error-free transformations).
A pair evaluated as float64(hi) + float64(lo) on the host recovers ~2x the
working precision; *differences* of nearby pairs (line-search accept tests,
suboptimality gaps) are exact in fp32 by Sterbenz cancellation of the hi
parts. The reference needs none of this because it is fp64 end-to-end.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = [
    "logsig", "sigmoid",
    "two_sum", "sum2", "dot2",
    "accum_sum", "accum_dot", "accum_sum_pair",
    "pair_diff", "ls_accept", "reg_clamp",
]


def logsig(x):
    """log(sigmoid(x)) = -softplus(-x), numerically stable across the line."""
    return jax.nn.log_sigmoid(x)


def sigmoid(x):
    return jax.nn.sigmoid(x)


# --------------------- error-free transformations ---------------------

def two_sum(a, b):
    """Knuth two-sum: s = fl(a+b) and the exact rounding error e, such
    that a + b == s + e exactly (branch-free, any sign ordering)."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def _split(a):
    """Dekker split of a float into hi+lo halves with non-overlapping
    mantissas (fp32: 24 = 12+12 bits, splitter 2^12+1; fp64: 2^27+1)."""
    splitter = 134217729.0 if a.dtype == jnp.float64 else 4097.0
    c = jnp.asarray(splitter, a.dtype) * a
    hi = c - (c - a)
    return hi, a - hi


def _two_prod(a, b):
    """Dekker two-product: p = fl(a*b) and the exact error e
    (a * b == p + e). No FMA assumed — XLA exposes none, and the
    split form is exact whether or not the compiler contracts it."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def _lane_fold(x, lanes=1024):
    """Compensated fold of a 1-D array into per-lane (hi, lo) pairs via a
    scan over rows, then a binary-tree pair merge across lanes. Whole-lane
    vector ops only (VPU-friendly); error O(n * eps^2)."""
    n = x.shape[0]
    steps = max(-(-n // lanes), 1)
    pad = steps * lanes - n
    xf = jnp.pad(x, (0, pad)).reshape(steps, lanes)

    def body(carry, row):
        hi, lo = carry
        s, e = two_sum(hi, row)
        return (s, lo + e), None

    init = (jnp.zeros((lanes,), x.dtype), jnp.zeros((lanes,), x.dtype))
    (hi, lo), _ = jax.lax.scan(body, init, xf)
    # tree-merge the lanes, propagating the exact merge errors into lo.
    # The halving uses a leading-axis reshape + index rather than
    # hi[:h]/hi[h:] slices: under GSPMD, sliced halves of an array whose
    # lane dim inherited row-sharding reshard via chains of
    # collective-permutes (measured: 884 permutes per sharded Gram step,
    # all from these slices); indexing a size-2 leading axis does not.
    while hi.shape[0] > 1:
        h = hi.shape[0] // 2
        hi2 = hi.reshape(2, h)
        lo2 = lo.reshape(2, h)
        s, e = two_sum(hi2[0], hi2[1])
        hi = s
        lo = lo2[0] + lo2[1] + e
    return hi[0], lo[0]


def sum2(x):
    """Compensated sum of a 1-D array -> (hi, lo) pair in x.dtype.

    hi is within one rounding of the true sum; float64(hi) + float64(lo)
    carries ~2x the working precision. Used for fp32 loss reductions on
    the device (SURVEY.md hard part (c))."""
    return _lane_fold(x)


def dot2(x, y):
    """Compensated <x, y> -> (hi, lo) pair (Ogita-Rump-Oishi dot2):
    exact per-element products via Dekker two-product, compensated sum of
    the product hi parts, plain sum of the (already O(eps)-sized) product
    errors folded into lo."""
    p, e = _two_prod(x, y)
    hi, lo = _lane_fold(p)
    return hi, lo + jnp.sum(e)


def pair_diff(ahi, alo, bhi, blo):
    """(a - b) for two pairs, accurate when a and b are close: the hi
    difference is exact by Sterbenz when within 2x of each other (the
    line-search / suboptimality-gap regime)."""
    s, e = two_sum(ahi, -bhi)
    return s + (e + (alo - blo))


def reg_clamp(reg, cdt, ceil: float = 1e6):
    """Ceiling for the committed cubic regularization coefficient.

    When every line-search trial is rejected (possible only at the
    numerical optimum, where trial values tie or sit one rounding above
    f), the reference commits the last trial and its reg doubles per
    trial without bound (cubic.py:294-303 has no cap — its runs stop on
    tolerance first). A fixed-iteration device run must survive this.
    The default ceiling is 1e6: the legitimate scale of reg is the
    Hessian Lipschitz constant (<~1 for unit-row logistic; line searches
    push a few orders beyond during hard steps), so 1e6 is ample headroom
    — while recovery from an inflated reg costs log2(reg/M) iterations at
    the optimistic x0.5/iteration decrease, so a runaway to fp32-max^0.25
    (~4e9, the round-2 ceiling) freezes a run for ~30+ iterations
    (measured: the n=4k fp32 stall).

    ``ceil``: problems whose legitimate reg scale approaches 1e6 (losses
    or data far from the unit-row regime) pass a scaled ceiling — the
    solvers use max(1e6, 1e4 * initial reg_coef), keeping 1e6 as the
    floor of the cap (advisor round-3 finding)."""
    return jnp.minimum(reg, jnp.asarray(ceil, reg.dtype))


def ls_accept(vhi, vlo, fhi, flo, model_dec):
    """Backtracking line-search accept test on two-float values — the
    fp-robust form of the reference's ``f(x+s) <= f(x) - model_decrease``
    (cubic.py:294-303). Two clauses:

    * sufficient decrease at full pair resolution: gap <= -model_dec;
    * once model_dec is below one ulp of f (where the reference's fp64
      subtraction ``f - model_dec`` rounds to ``f`` and it de-facto accepts
      any non-increase), accept non-increase — without this, an exactly-
      resolved gap keeps failing at the optimum and the reg coefficient
      doubles per trial until overflow.

    NaN values fail both clauses (an overflowed trial retries with a
    larger reg instead of being accepted)."""
    gap = pair_diff(vhi, vlo, fhi, flo)
    ulp = jnp.asarray(jnp.finfo(vhi.dtype).eps, vhi.dtype) * jnp.abs(fhi)
    return (gap <= -model_dec) | ((model_dec <= ulp) & (gap <= 0))


# --------------------------- accum dispatch ---------------------------

def accum_sum(x, accum_dtype):
    """Sum with upcast accumulation; compensated (collapsed pair) when the
    accum dtype equals the storage dtype (i.e. x64 disabled)."""
    if jnp.dtype(accum_dtype) == x.dtype:
        hi, lo = sum2(x)
        return hi + lo
    return jnp.sum(x.astype(accum_dtype))


def accum_dot(x, y, accum_dtype):
    """<x, y> with upcast (or compensated) accumulation."""
    if jnp.dtype(accum_dtype) == x.dtype:
        hi, lo = dot2(x, y)
        return hi + lo
    return jnp.dot(x.astype(accum_dtype), y.astype(accum_dtype))


def accum_sum_pair(x, accum_dtype):
    """Sum -> (hi, lo) pair: compensated in-dtype when accum == storage,
    else a plain upcast sum with lo = 0 (the fp64 verification path)."""
    if jnp.dtype(accum_dtype) == x.dtype:
        return sum2(x)
    s = jnp.sum(x.astype(accum_dtype))
    return s, jnp.zeros((), accum_dtype)
