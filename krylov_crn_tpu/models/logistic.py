"""Logistic-regression oracle: the sparse-linear-algebra heart.

Accelerator-native re-design of the reference's optimizer/loss.py:179-383. Two
layers:

* a **functional core** of pure jitted module-level functions on the
  ``DualSparse`` pytree (shared compile cache across oracle instances);
  solvers thread the margin cache ``Ax`` through their state explicitly
  instead of the reference's mutable memoization (loss.py:266-286);
* a **class wrapper** with the reference's exact API surface — ``value``
  (with running-best f_opt), ``gradient``, ``hessian``, ``hess_vec_prod``,
  ``partial_gradient``/``partial_hessian``, ``mat_vec_product`` caching,
  ``update_mat_vec_product``, ``reset`` — plus the smoothness constants.

Math (loss.py:215-302):
    f(x)  = mean((1-b) * Ax - logsig(Ax)) + l2/2 ||x||^2
    g(x)  = A^T (sigma(Ax) - b) / n + l2 x
    H(x)  = A^T diag(w) A / n + l2 I,   w = sigma(Ax) (1 - sigma(Ax))
    Hv    = A^T (w * (A v)) / n + l2 v          (never materializes H)
"""

from __future__ import annotations

import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np

from krylov_crn_tpu.data.formats import DualSparse, build_dual
from krylov_crn_tpu.data.libsvm import canonicalize_labels
from krylov_crn_tpu.models.base import Oracle
from krylov_crn_tpu.ops.coords import gather_columns_dense
from krylov_crn_tpu.ops.math import (
    accum_dot,
    accum_sum_pair,
    logsig,
    sigmoid,
    two_sum,
)
from krylov_crn_tpu.ops.spmv import hvp_sparse, rmatvec, row_sqnorms, spmv

__all__ = ["LogisticRegression"]


# ------------------------- functional core (jitted) -------------------------

def _adt(x):
    """Accumulation dtype: f64 when x64 is live, else the compute dtype."""
    return jnp.float64 if jax.config.read("jax_enable_x64") else x.dtype


def data_mask(data):
    """Row-validity mask for padded sharded layouts; None on single-chip."""
    return getattr(data, "mask", None)


@jax.jit
def logreg_matvec(data: DualSparse, x):
    return spmv(data, x)


@functools.partial(jax.jit, static_argnames=("l2", "n"))
def logreg_value_from_margins(b, Ax, x, l2: float = 0.0, mask=None,
                              n: int | None = None):
    """f from cached margins as a two-float (hi, lo) pair.

    ``mask``/``n`` handle padded sharded rows (padding would otherwise
    contribute -logsig(0) = log 2 each). Under x64, lo = 0 and hi is the
    plain fp64 value; in fp32 the compensated pair resolves 1e-9 gaps
    (see ops/math.py). Terms are scaled by 1/n before the reduction so
    per-term rounding enters at eps*|term|/n."""
    adt = _adt(Ax)
    terms = (1.0 - b) * Ax - logsig(Ax)
    if mask is not None:
        terms = terms * mask
    if n is None:
        n = Ax.shape[0]
    hi, lo = accum_sum_pair(terms.astype(adt) / n, adt)
    if l2:
        t = jnp.asarray(l2 / 2.0, adt) * accum_dot(x, x, adt).astype(adt)
        hi, e = two_sum(hi, t)
        lo = lo + e
    return hi, lo


@functools.partial(jax.jit, static_argnames=("l2",))
def logreg_value(data, b, x, l2: float = 0.0):
    Ax = spmv(data, x)
    hi, lo = logreg_value_from_margins(b, Ax, x, l2, mask=data_mask(data),
                                       n=data.n)
    return hi + lo, Ax


@functools.partial(jax.jit, static_argnames=("l2",))
def logreg_gradient_from_margins(data, b, Ax, x, l2: float = 0.0):
    residual = sigmoid(Ax) - b
    mask = data_mask(data)
    if mask is not None:
        residual = residual * mask
    g = rmatvec(data, residual) / data.n
    if l2:
        g = g + l2 * x
    return g


@functools.partial(jax.jit, static_argnames=("l2",))
def logreg_gradient(data, b, x, l2: float = 0.0):
    Ax = spmv(data, x)
    return logreg_gradient_from_margins(data, b, Ax, x, l2), Ax


def hessian_weights(Ax, mask=None):
    a = sigmoid(Ax)
    w = a * (1.0 - a)
    if mask is not None:
        w = w * mask
    return w


@functools.partial(jax.jit, static_argnames=("l2",))
def logreg_hvp(data, Ax, v, l2: float = 0.0):
    """Exact HVP from cached margins (two SpMVs; loss.py:289-302)."""
    w = hessian_weights(Ax, data_mask(data))
    return hvp_sparse(data, w, v, l2=l2)


@functools.partial(jax.jit, static_argnames=("l2",))
def logreg_hessian_dense(data: DualSparse, Ax, l2: float = 0.0):
    """Dense Hessian for the small-d "full" solver path (loss.py:249-255).
    Requires the dense copy of A (DualSparse.dense)."""
    if data.dense is None:
        raise ValueError("dense Hessian requires DualSparse built with "
                         "want_dense=True (small-d problems)")
    w = hessian_weights(Ax)
    H = (data.dense * w[:, None]).T @ data.dense / data.n
    if l2:
        H = H + l2 * jnp.eye(data.d, dtype=H.dtype)
    return H


@functools.partial(jax.jit, static_argnames=("l2", "k_pad"))
def logreg_partials(data, b, Ax, x, I, l2: float = 0.0,
                    k_pad: int | None = None):
    """Coordinate-subspace gradient, Hessian, and column panel for SSCN.

    Returns (g_I, H_I, B) where B = dense A[:, I]; one fused program:
      g_I = B^T (sigma(Ax)-b)/n + l2 x_I        (loss.py:234-247)
      H_I = B^T diag(w) B / n + l2 I_m          (loss.py:257-264)

    Row-sharded data (ShardedDual): the panel assembles shard-locally
    (parallel/sharded.sharded_gather_columns) and comes out row-sharded;
    the B^T reductions below then lower to one psum each under GSPMD —
    the sharded-SSCN design of the round-4 verdict (reference analog
    cubic.py:321-408). Padded rows are masked out of the residual and
    Hessian weights (sigma(0) - 0 = 0.5 and w(0) = 0.25 would otherwise
    pollute the partials).
    """
    from krylov_crn_tpu.parallel.sharded import (
        ShardedDual,
        sharded_gather_columns,
    )

    if isinstance(data, ShardedDual):
        B = sharded_gather_columns(data, I)
        residual = (sigmoid(Ax) - b) * data.mask
        w = hessian_weights(Ax) * data.mask
    else:
        B = gather_columns_dense(data, I, k_pad)
        residual = sigmoid(Ax) - b
        w = hessian_weights(Ax)
    g = B.T @ residual / data.n
    if l2:
        g = g + l2 * jnp.take(x, I)
    H = (B * w[:, None]).T @ B / data.n
    if l2:
        H = H + l2 * jnp.eye(I.shape[0], dtype=H.dtype)
    return g, H, B


# ------------------------------ class wrapper ------------------------------

class LogisticRegression(Oracle):
    """Reference-API logistic oracle over the device functional core."""

    def __init__(self, A, b, store_mat_vec_prod=True, dtype=None,
                 want_dense=None, *args, **kwargs):
        super().__init__(*args, **kwargs)
        from krylov_crn_tpu.parallel.sharded import ShardedDual, pad_rowvec

        if dtype is None:
            dtype = (np.float64 if jax.config.read("jax_enable_x64")
                     else np.float32)
        self._data = None
        self._want_dense = want_dense
        self._dtype = np.dtype(dtype)
        if isinstance(A, ShardedDual):
            # distributed oracle: row-sharded matrix + padded sharded
            # labels. A global jax Array of padded length (produced by
            # parallel.multihost.load_sharded_libsvm) is used as-is —
            # multi-host processes cannot materialize the global raw
            # label vector on one host.
            self._data = A
            if isinstance(b, jax.Array) and b.shape[0] == A.n_padded:
                self.b = b
            else:
                b = canonicalize_labels(np.asarray(b))
                self.b = pad_rowvec(b.astype(dtype), A)
        else:
            if isinstance(A, DualSparse):
                self._data = (A.astype(dtype) if A.a.vals.dtype != dtype
                              else A)
            else:
                # device COO/dense data is built LAZILY on first .data
                # access: Gram-space runs never touch it (they work off
                # A_host + the device K), so an eager build would be a
                # wasted transfer
                import scipy.sparse as sp

                # retained for Gram-space solvers (one-time K = A A^T
                # build) and as the lazy .data build source
                self.A_host = (A.tocsr() if sp.issparse(A)
                               else sp.csr_matrix(np.asarray(A)))
            b = canonicalize_labels(np.asarray(b))
            self.b = jnp.asarray(b.astype(dtype))
        if self._data is not None:
            self.n, self.dim = self._data.shape
        else:
            self.n, self.dim = map(int, self.A_host.shape)
        self.store_mat_vec_prod = store_mat_vec_prod
        self.reuse = False
        self.x_last = None
        self._mat_vec_prod = jnp.zeros(self.b.shape[0], dtype)

    @property
    def data(self):
        """Device data pytree (DualSparse/ShardedDual), built on first use."""
        if self._data is None:
            self._data = build_dual(self.A_host, dtype=self._dtype,
                                    want_dense=self._want_dense)
        return self._data

    @data.setter
    def data(self, value):
        self._data = value

    # ---- margins cache (parity with loss.py:266-286) ----
    def mat_vec_product(self, x):
        x = jnp.asarray(x)
        if self.store_mat_vec_prod and (
            self.reuse or (self.x_last is not None and (
                x is self.x_last or self.is_equal(x, self.x_last)))
        ):
            return self._mat_vec_prod
        Ax = logreg_matvec(self.data, x)
        if self.store_mat_vec_prod:
            self._mat_vec_prod = Ax
            self.x_last = x
        return Ax

    def update_mat_vec_product(self, Ax, delta, I):
        """Incremental margin update Ax += A[:, I] @ delta (loss.py:279-281)."""
        B = gather_columns_dense(self.data, jnp.asarray(I, jnp.int32))
        self._mat_vec_prod = jnp.asarray(Ax) + B @ jnp.asarray(delta)
        self.reuse = True

    def reset(self):
        self.reuse = False
        self.x_last = None
        self._mat_vec_prod = jnp.zeros_like(self.b)

    # ---- oracle surface ----
    def _value(self, x):
        x = jnp.asarray(x)
        Ax = self.mat_vec_product(x)
        hi, lo = logreg_value_from_margins(self.b, Ax, x, l2=self.l2,
                                           mask=data_mask(self.data),
                                           n=self.n)
        # combine the pair on host: full precision even in fp32 runs
        return float(hi) + float(lo)

    def gradient(self, x):
        x = jnp.asarray(x)
        Ax = self.mat_vec_product(x)
        return logreg_gradient_from_margins(self.data, self.b, Ax, x,
                                            l2=self.l2)

    def hessian(self, x):
        x = jnp.asarray(x)
        Ax = self.mat_vec_product(x)
        return logreg_hessian_dense(self.data, Ax, l2=self.l2)

    def hess_vec_prod(self, x, v, grad_dif=False, eps=None):
        """Exact HVP from cached margins, or the finite-difference
        gradient-difference fallback (loss.py:289-293) when
        ``grad_dif=True`` with step ``eps``."""
        x = jnp.asarray(x)
        v = jnp.asarray(v)
        if grad_dif:
            if eps is None:
                raise ValueError("grad_dif HVP requires an eps step size")
            return (self.gradient(x + eps * v) - self.gradient(x)) / eps
        Ax = self.mat_vec_product(x)
        return logreg_hvp(self.data, Ax, v, l2=self.l2)

    def partial_gradient(self, x, I):
        x = jnp.asarray(x)
        Ax = self.mat_vec_product(x)
        g, _, _ = logreg_partials(self.data, self.b, Ax, x,
                                  jnp.asarray(I, jnp.int32), l2=self.l2)
        return g

    def partial_hessian(self, x, I):
        x = jnp.asarray(x)
        Ax = self.mat_vec_product(x)
        _, H, _ = logreg_partials(self.data, self.b, Ax, x,
                                  jnp.asarray(I, jnp.int32), l2=self.l2)
        return H

    # ---- smoothness constants (loss.py:308-347) ----
    def _vals(self):
        d = self.data
        return d.a_vals if hasattr(d, "a_vals") else d.a.vals

    def _row_sqnorms(self):
        d = self.data
        if hasattr(d, "a_vals"):
            from krylov_crn_tpu.parallel.sharded import sharded_row_sqnorms

            return sharded_row_sqnorms(d)
        return row_sqnorms(d.a)

    @property
    def smoothness(self):
        if self._smoothness is None:
            if self.dim > 20000 and self.n > 20000:
                warnings.warn(
                    "The matrix is too large to estimate the smoothness "
                    "constant, so Frobenius estimate is used instead."
                )
                fro2 = float(jnp.sum(self._vals().astype(jnp.float32) ** 2))
                self._smoothness = 0.25 * fro2 / self.n + self.l2
            else:
                smax = float(_sigma_max(self.data))
                self._smoothness = 0.25 * smax**2 / self.n + self.l2
        return self._smoothness

    @property
    def max_smoothness(self):
        if self._max_smoothness is None:
            mx = float(jnp.max(self._row_sqnorms()))
            self._max_smoothness = 0.25 * mx + self.l2
        return self._max_smoothness

    @property
    def average_smoothness(self):
        if self._ave_smoothness is None:
            # mean over *real* rows (padding rows report 0)
            av = float(jnp.sum(self._row_sqnorms())) / self.n
            self._ave_smoothness = 0.25 * av + self.l2
        return self._ave_smoothness

    @property
    def hessian_lipschitz(self):
        if self._hessian_lipschitz is None:
            a_max = float(jnp.sqrt(jnp.max(self._row_sqnorms())))
            A_norm = (self.smoothness - self.l2) * 4
            self._hessian_lipschitz = A_norm * a_max / (6 * np.sqrt(3))
        return self._hessian_lipschitz

    @staticmethod
    def density(x):
        x = np.asarray(x)
        return 0.0 if x.size == 0 else float((x != 0).sum()) / x.size


@jax.jit
def _sigma_max(data: DualSparse, tol: float = 1e-12, it_max: int = 10000):
    """Largest singular value of A by tolerance-driven power iteration on
    A^T A (replaces scipy svds, loss.py:319). Converges the Rayleigh
    quotient sigma^2 to relative `tol`."""
    d = data.d
    vals = data.a_vals if hasattr(data, "a_vals") else data.a.vals
    v0 = jnp.full((d,), 1.0 / np.sqrt(d), vals.dtype)

    def step(v):
        w = rmatvec(data, spmv(data, v))
        sig2 = jnp.linalg.norm(w)  # = sigma_max^2 estimate (||v|| == 1)
        return w / sig2, sig2

    def cond(state):
        _, sig2, sig2_prev, it = state
        rel = jnp.abs(sig2 - sig2_prev) / jnp.maximum(sig2, 1e-300)
        return jnp.logical_and(rel > tol, it < it_max)

    def body(state):
        v, sig2, _, it = state
        v_new, sig2_new = step(v)
        return (v_new, sig2_new, sig2, it + 1)

    v1, sig2_1 = step(v0)
    v, sig2, _, _ = jax.lax.while_loop(
        cond, body, (v1, sig2_1, jnp.zeros_like(sig2_1),
                     jnp.asarray(1, jnp.int32)))
    return jnp.sqrt(sig2)
