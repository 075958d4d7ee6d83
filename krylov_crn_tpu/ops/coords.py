"""Coordinate-subspace (column) operations for SSCN.

The reference slices CSC columns ``A[:, I]`` on the host
(/root/reference/optimizer/loss.py:234-264). Variable-length column slicing
is shape-dynamic and hostile to compiled device code, so the redesign
materializes the sampled
columns as a **dense n x m panel B** in one shot:

1. window-gather each sampled column's nnz from the stored transpose
   (offsets from ``at_indptr``, padded to the static ``max_col_nnz`` and
   masked) — pure gathers;
2. scatter-add the m*K window into B — index arrays are jit arguments, so
   this runs at memory speed (see package design rule 1).

Everything downstream is then dense matmuls: partial gradient B^T r / n,
partial Hessian B^T diag(w) B / n, and the incremental margin update
Ax += B @ s (the functional analogue of the reference's stateful
``update_mat_vec_product``, loss.py:279-281).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from krylov_crn_tpu.data.formats import DualSparse

__all__ = ["gather_columns_dense"]


def gather_columns_dense(data: DualSparse, I: jax.Array, k_pad: int | None = None):
    """Return B = dense A[:, I] with shape (n, m) for index vector I (m,)."""
    if k_pad is None:
        k_pad = data.max_col_nnz
    n = data.n
    m = I.shape[0]
    offs = data.at_indptr[I]  # (m,)
    counts = data.at_indptr[I + 1] - offs
    k = jnp.arange(k_pad, dtype=jnp.int32)
    mask = k[None, :] < counts[:, None]  # (m, K)
    idx = jnp.where(mask, offs[:, None] + k[None, :], 0)
    vals = jnp.where(mask, jnp.take(data.at.vals, idx), 0.0)  # (m, K)
    rows = jnp.where(mask, jnp.take(data.at.cols, idx), n)  # row ids of A
    col_of = jnp.broadcast_to(
        jnp.arange(m, dtype=jnp.int32)[:, None], (m, k_pad)
    )
    B = jnp.zeros((n + 1, m), data.at.vals.dtype)
    B = B.at[rows.reshape(-1), col_of.reshape(-1)].add(vals.reshape(-1))
    return B[:n]
