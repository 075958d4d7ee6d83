"""Device sparse-matrix formats.

The compute format is row-sorted COO ("sorted-COO CSR"): three flat arrays
``vals``, ``rows``, ``cols`` with ``rows`` nondecreasing, padded to an aligned
length with zero-valued entries that target (row 0, col 0). A matvec is then

    y = segment_sum(vals * x[cols], rows, num_segments=n, indices_are_sorted)

— one gather plus one sorted segment-sum. Gathers move far fewer bytes
per cycle than dense streaming, which is why the dense Gram path
(ops/gram.py) is the fast single-device route and this format serves as
the general/row-sharded fallback. The transpose
product uses an explicitly stored transpose (memory x2, as anticipated in
SURVEY.md "hard parts" (b)): no scatter ever runs.

Replaces the reference's ``scipy.sparse`` CSR/CSC usage
(the reference's optimizer/loss.py:266-302, cubic_newton.py:52-55) with a
device layout. All leaves are jit-argument pytree fields — never bake
these arrays into a jaxpr as constants (see package docstring, rule 1).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["SparseMatrix", "DualSparse", "from_scipy", "from_coo"]


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SparseMatrix:
    """Row-sorted COO sparse matrix, padded; shape/meta static under jit."""

    vals: jax.Array  # (nnz_pad,) float
    rows: jax.Array  # (nnz_pad,) int32, nondecreasing
    cols: jax.Array  # (nnz_pad,) int32
    n: int = dataclasses.field(metadata=dict(static=True))
    d: int = dataclasses.field(metadata=dict(static=True))
    nnz: int = dataclasses.field(metadata=dict(static=True))  # true nnz

    @property
    def shape(self):
        return (self.n, self.d)

    @property
    def nnz_padded(self) -> int:
        return self.vals.shape[0]

    def astype(self, dtype) -> "SparseMatrix":
        return dataclasses.replace(self, vals=self.vals.astype(dtype))

    def density(self) -> float:
        return self.nnz / float(self.n * self.d)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class DualSparse:
    """A together with its explicit transpose (and optional dense copy).

    ``at_indptr``/``col_counts`` index the transpose's row segments (i.e. the
    columns of A) for SSCN's coordinate-subspace window gathers; see
    ops/coords.py. ``dense`` is populated for small-d problems where dense
    matmuls beat gather-based SpMV (the reference's analogous switch is
    dense-vs-sparse linear solves at its optimizer/cubic.py:47-58).
    """

    a: SparseMatrix  # (n, d)
    at: SparseMatrix  # (d, n) — transpose of a
    at_indptr: jax.Array  # (d + 1,) int32: segment offsets into at.*
    dense: Any  # jax.Array (n, d) or None
    max_col_nnz: int = dataclasses.field(metadata=dict(static=True))

    @property
    def n(self) -> int:
        return self.a.n

    @property
    def d(self) -> int:
        return self.a.d

    @property
    def nnz(self) -> int:
        return self.a.nnz

    @property
    def shape(self):
        return self.a.shape

    def astype(self, dtype) -> "DualSparse":
        return dataclasses.replace(
            self,
            a=self.a.astype(dtype),
            at=self.at.astype(dtype),
            dense=None if self.dense is None else self.dense.astype(dtype),
        )


def from_coo(
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    shape: tuple[int, int],
    dtype=np.float32,
    pad_to: int = 1024,
) -> SparseMatrix:
    """Build a padded row-sorted SparseMatrix from host COO arrays."""
    n, d = map(int, shape)
    nnz = int(len(vals))
    order = np.argsort(rows, kind="stable")
    rows = np.asarray(rows, np.int32)[order]
    cols = np.asarray(cols, np.int32)[order]
    vals = np.asarray(vals, dtype)[order]
    nnz_pad = max(_round_up(max(nnz, 1), pad_to), pad_to)
    pad = nnz_pad - nnz
    if pad:
        # zero-valued entries hitting (last row, col 0) keep `rows` sorted
        rows = np.concatenate([rows, np.full(pad, max(n - 1, 0), np.int32)])
        cols = np.concatenate([cols, np.zeros(pad, np.int32)])
        vals = np.concatenate([vals, np.zeros(pad, dtype)])
    return SparseMatrix(
        vals=jnp.asarray(vals), rows=jnp.asarray(rows), cols=jnp.asarray(cols),
        n=n, d=d, nnz=nnz,
    )


def from_scipy(A, dtype=np.float32, pad_to: int = 1024) -> SparseMatrix:
    """Convert a scipy.sparse matrix (any format) to SparseMatrix."""
    coo = A.tocoo()
    return from_coo(coo.row, coo.col, coo.data, coo.shape, dtype, pad_to)


def build_dual(
    A,
    dtype=np.float32,
    pad_to: int = 1024,
    dense_threshold_bytes: int = 512 * 1024 * 1024,
    want_dense: bool | None = None,
) -> DualSparse:
    """Build the DualSparse device format from a scipy matrix or host COO.

    ``want_dense``: force/forbid carrying a dense copy of A. By default a
    dense copy is kept when it fits ``dense_threshold_bytes`` *and* d is
    small enough (<=2048) that downstream dense Hessians are sane — the
    regime where the reference picks its "full" cubic solver
    (/root/reference/cubic_newton.py:76-82 uses dim < 500).
    """
    import scipy.sparse as sp

    if not sp.issparse(A):
        A = sp.csr_matrix(np.asarray(A))
    A = A.tocsr()
    n, d = A.shape
    a = from_scipy(A, dtype, pad_to)
    At = A.T.tocsr()
    at = from_scipy(At, dtype, pad_to)
    col_counts = np.diff(At.indptr).astype(np.int64)
    # at_indptr indexes into the *sorted padded* transpose arrays: because
    # from_scipy sorts by row (= column of A) stably, real entries occupy the
    # first `nnz` slots in CSR order, so scipy's indptr is directly valid.
    at_indptr = jnp.asarray(At.indptr.astype(np.int32))
    max_col = int(col_counts.max()) if d > 0 and col_counts.size else 0
    itemsize = np.dtype(dtype).itemsize
    if want_dense is None:
        want_dense = (n * d * itemsize <= dense_threshold_bytes) and d <= 2048
    dense = jnp.asarray(A.toarray().astype(dtype)) if want_dense else None
    return DualSparse(a=a, at=at, at_indptr=at_indptr, dense=dense,
                      max_col_nnz=max_col)
