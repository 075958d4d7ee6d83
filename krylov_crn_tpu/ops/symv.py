"""Symmetric dense matvec (SYMV) — a Pallas kernel on the Triton route.

Every Gram-space iteration is m + 1 K-matvecs with K = A A^T
*symmetric* (ops/gram.py): the m Lanczos hops and the incremental
gradient image (plus the margin re-derivation, when on) all stream the
n x n K, which bounds the per-iteration cost. A generic matvec must
read all n^2 elements; a symmetric matvec only needs the upper
triangle — each
off-diagonal tile K_ij (i < j) contributes

    y[i_blk] += K_ij @ x[j_blk]      (row combination)
    y[j_blk] += K_ij^T @ x[i_blk]    (column combination)

so streaming n(n+1)/2 elements yields the full product: about half the
device-memory traffic on a bandwidth-bound op. XLA has no
triangle-aware matvec; this kernel supplies it.

Kernel structure (GPU blocks run in parallel and in no order, so
nothing is carried from one block to the next):

* one block per upper-triangle tile (i, j) of size ``tile x tile``. The
  nb(nb+1)/2 tiles fold into an (nb/2) x (nb+1) rectangular grid: grid
  row r holds tile-row r (nb - r tiles) followed by tile-row nb-1-r
  (r + 1 tiles), so every block does the same work and no block is
  empty. Each block computes its own (i, j) from its grid position;
* inside the block a loop walks the tile in ``rows``-high strips. A
  strip's row sums are complete (the strip spans the tile's columns)
  and are stored at once; the column sums accumulate in registers over
  the strips and are stored after the loop;
* the two partial products land in a partial buffer P of shape
  (nb, n): the row part of tile (i, j) at P[j, i_blk], the column part
  at P[i, j_blk]. Each (slot, block) of P is written by exactly one
  tile, so y = P.sum(0) needs no atomics and no zero-fill. P costs
  (n / tile) * n * 4 B written and read once — about 2 * 2 / tile of
  the triangle's bytes (1.6% at tile 256).

Exactness: K is exactly symmetric by construction (the build rounds
0.5 * (K + K^T), bitwise symmetric because fp add commutes, see
ops/gram._round_K), so reading only the upper triangle computes the
same matrix product; per-element rounding differs from XLA's matvec
only in summation order (same fp32 error class). For a given K and x
the result is bitwise reproducible: no atomics, and the launch does
not depend on autotuning.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

__all__ = ["TILE", "symv", "symv_bytes", "symv_supported"]

# Tile edge, strip height and launch parameters, chosen by measurement
# on the card (PERF.md). The tile is a power of two; ops/gram.pad_rows
# pads n to a multiple of 2 * TILE on the GPU so that the tile count nb
# is even (the folded grid pairs tile-rows r and nb-1-r).
TILE = 256
ROWS = 32
NUM_WARPS = 4
NUM_STAGES = 3


def tile_coords(r, c, nb):
    """Upper-triangle tile (i, j) of folded grid position (r, c),
    0 <= r < nb/2, 0 <= c <= nb. Works on Python ints and traced
    scalars alike."""
    first = c < nb - r
    i = jnp.where(first, r, nb - 1 - r)
    j = jnp.where(first, r + c, c - 1)
    return i, j


def _symv_kernel(K_ref, x_ref, p_ref, *, nb: int, tile: int, rows: int):
    i, j = tile_coords(pl.program_id(0), pl.program_id(1), nb)
    r0 = i * tile
    c0 = j * tile
    xj = x_ref[pl.ds(c0, tile)]

    def strip(s, col_acc):
        rs = r0 + s * rows
        Ks = K_ref[pl.ds(rs, rows), pl.ds(c0, tile)]
        # rows rs..rs+rows of y_i: sum_c K[r, c] x_j[c]
        p_ref[j, pl.ds(rs, rows)] = jnp.sum(Ks * xj[None, :], axis=1)
        xi = x_ref[pl.ds(rs, rows)]
        # y_j[c] += sum_r K[r, c] x_i[r]
        return col_acc + jnp.sum(Ks * xi[:, None], axis=0)

    col = jax.lax.fori_loop(0, tile // rows, strip,
                            jnp.zeros((tile,), jnp.float32))

    # a diagonal tile's row part already covers the whole tile
    @pl.when(i != j)
    def _():
        p_ref[i, pl.ds(c0, tile)] = col


def symv_bytes(n: int, tile: int = TILE) -> int:
    """Bytes one call streams: the upper-triangle tiles of K and the
    partial buffer, written and read once (the reads of x are a few
    n-vectors per tile row and are not counted)."""
    nb = n // tile
    return 4 * (n * (n + tile) // 2 + 2 * nb * n)


def symv_supported(n: int, dtype, tile: int = TILE) -> bool:
    """Static predicate: the kernel handles square fp32 K with n a
    multiple of 2 * tile, on a GPU backend."""
    return (jnp.dtype(dtype) == jnp.float32
            and n % (2 * tile) == 0
            and jax.default_backend() == "gpu")


@functools.partial(jax.jit, static_argnames=("tile", "rows", "interpret"))
def symv(K, q, tile: int = TILE, rows: int = ROWS, interpret: bool = False):
    """y = K @ q for symmetric fp32 K, streaming only the upper triangle.

    Traceable (usable inside jit). The caller gates on symv_supported;
    this function asserts the shape. ``tile``/``rows`` other than the
    defaults and ``interpret`` (the Pallas interpreter) serve the CPU
    tests of the tile folding and the partial-buffer layout; the launch
    parameters are the module constants NUM_WARPS/NUM_STAGES."""
    n = K.shape[0]
    assert K.shape == (n, n) and K.dtype == jnp.float32
    assert n % (2 * tile) == 0 and tile % rows == 0
    nb = n // tile
    P = pl.pallas_call(
        functools.partial(_symv_kernel, nb=nb, tile=tile, rows=rows),
        out_shape=jax.ShapeDtypeStruct((nb, n), jnp.float32),
        grid=(nb // 2, nb + 1),
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=NUM_WARPS,
                                           num_stages=NUM_STAGES),
        cost_estimate=pl.CostEstimate(
            flops=2 * n * n,
            bytes_accessed=symv_bytes(n, tile),
            transcendentals=0,
        ),
        interpret=interpret,
        name="symv_upper",
    )(K, q.astype(jnp.float32))
    return P.sum(axis=0)
