"""Sparse matrix products: SpMV, transpose SpMV, fused logistic HVP.

Device replacements for the reference's scipy CSR/CSC products
(the reference's optimizer/loss.py:270,227,299-302). Formulation:

    A @ x   = segment_sum(vals * x[cols], rows, n)        (gather + sorted seg-sum)
    A.T @ z = the same kernel on the explicitly-stored transpose

This path is gather/segment-sum-bound and exists as the general and
row-sharded fallback; the fast single-device compute path is the dense
Gram formulation (ops/gram.py). bench.py reports its fused-HVP rate on
the GPU (PERF.md).
All sparse arrays MUST arrive as function arguments (pytree leaves) — XLA
constant-embedded index arrays compile pathologically (~800x slower).

A dense matmul path is auto-selected when ``DualSparse.dense`` is present
(small-d problems, mirroring the reference's dense/sparse switch at
/root/reference/optimizer/cubic.py:47-58).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from krylov_crn_tpu.data.formats import DualSparse, SparseMatrix

__all__ = ["spmv_coo", "spmv", "rmatvec", "hvp_sparse", "row_sqnorms"]


def spmv_coo(m: SparseMatrix, x: jax.Array) -> jax.Array:
    """y = M @ x for a row-sorted SparseMatrix."""
    prod = m.vals * jnp.take(x, m.cols, axis=0)
    return jax.ops.segment_sum(
        prod, m.rows, num_segments=m.n, indices_are_sorted=True
    )


def spmv(data, x: jax.Array) -> jax.Array:
    """Ax. Dispatches: dense matmul path, sharded shard_map path, or COO."""
    from krylov_crn_tpu.parallel.sharded import ShardedDual, sharded_spmv

    if isinstance(data, ShardedDual):
        return sharded_spmv(data, x)
    if data.dense is not None:
        return data.dense @ x
    return spmv_coo(data.a, x)


def rmatvec(data, z: jax.Array) -> jax.Array:
    """A.T z (d-vector) via the stored transpose — gather + seg-sum, no
    scatter. Sharded inputs psum the d-vector over the data axis."""
    from krylov_crn_tpu.parallel.sharded import (
        ShardedDual,
        sharded_rmatvec,
    )

    if isinstance(data, ShardedDual):
        return sharded_rmatvec(data, z)
    if data.dense is not None:
        return data.dense.T @ z
    return spmv_coo(data.at, z)


def hvp_sparse(data: DualSparse, w: jax.Array, v: jax.Array,
               l2: float = 0.0, n_scale: float | None = None) -> jax.Array:
    """Fused generalized-linear-model HVP:  A.T (w * (A v)) / n + l2 * v.

    Never materializes the Hessian — the exact-HVP structure of
    /root/reference/optimizer/loss.py:289-302, fused into one XLA program
    (two gathers + two sorted segment-sums + elementwise).
    """
    n = data.n if n_scale is None else n_scale
    Av = spmv(data, v)
    z = w * Av
    out = rmatvec(data, z) / n
    if l2:
        out = out + l2 * v
    return out


def row_sqnorms(m: SparseMatrix) -> jax.Array:
    """Per-row squared norms (replaces sklearn row_norms,
    /root/reference/optimizer/loss.py:327,335,344)."""
    return jax.ops.segment_sum(
        m.vals * m.vals, m.rows, num_segments=m.n, indices_are_sorted=True
    )
