"""Upper-triangle SYMV kernel (ops/symv.py) — CPU coverage via the Pallas
interpreter, plus the Python around it: tile folding, padding, the byte
count and the choice of kernel. The kernel's compiled run on the GPU is
checked against XLA's matvec and the fp64 product by chip_smoke.py (its
time beside XLA's is in PERF.md).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from krylov_crn_tpu.ops import symv as symv_mod
from krylov_crn_tpu.ops.symv import (
    TILE,
    symv,
    symv_bytes,
    symv_supported,
    tile_coords,
)


def _sym_fp32(n, seed=0):
    rng = np.random.default_rng(seed)
    B = (rng.standard_normal((n, n)) / np.sqrt(2 * n)).astype(np.float32)
    return B + B.T  # exactly symmetric: fp add commutes


def _rel_fp64(y, K, q):
    want = K.astype(np.float64) @ q.astype(np.float64)
    return np.linalg.norm(np.asarray(y, np.float64) - want) / \
        np.linalg.norm(want)


@pytest.mark.parametrize("nb", [1, 2, 5])
def test_symv_interpret_matches_matmul(nb):
    """nb pairs of tile-rows (2 * nb tiles of 16) against fp64."""
    n = 2 * 16 * nb
    K = _sym_fp32(n)
    q = np.random.default_rng(1).standard_normal(n).astype(np.float32)
    y = symv(jnp.asarray(K), jnp.asarray(q), tile=16, rows=8,
             interpret=True)
    rel = _rel_fp64(y, K, q)
    assert rel < 1e-6, f"symv rel err {rel:.3g}"


@pytest.mark.parametrize("tile,rows,n_real", [
    (16, 16, 20),   # one strip per tile; heavy padding
    (16, 4, 61),    # many strips; 3 rows of padding
    (32, 8, 128),   # no padding, four tiles
    (8, 8, 90),     # twelve tiles
])
def test_symv_interpret_tiles_and_padding(tile, rows, n_real):
    """Zero-padded K (as ops/gram pads it) at several tile counts: the
    real rows match fp64 and the padded rows stay exactly zero."""
    n = -(-n_real // (2 * tile)) * 2 * tile
    K = np.zeros((n, n), np.float32)
    K[:n_real, :n_real] = _sym_fp32(n_real, seed=n_real)
    q = np.zeros(n, np.float32)
    q[:n_real] = np.random.default_rng(2).standard_normal(n_real)
    y = np.asarray(symv(jnp.asarray(K), jnp.asarray(q), tile=tile,
                        rows=rows, interpret=True))
    assert _rel_fp64(y[:n_real], K[:n_real, :n_real], q[:n_real]) < 1e-6
    assert np.all(y[n_real:] == 0.0)


def test_upper_blocks_cover_triangle():
    """The folded (nb/2) x (nb+1) grid visits every upper-triangle tile
    exactly once, and each grid row holds nb+1 tiles."""
    for nb in (2, 4, 8, 10):
        seen = []
        for r in range(nb // 2):
            for c in range(nb + 1):
                i, j = (int(v) for v in tile_coords(r, c, nb))
                assert 0 <= i <= j < nb
                seen.append((i, j))
        assert len(seen) == nb * (nb + 1) // 2
        assert set(seen) == {(i, j) for i in range(nb)
                             for j in range(i, nb)}


def test_symv_bytes_counts_triangle_and_partials():
    n, t = 20480, 256
    nb = n // t
    tri = nb * (nb + 1) // 2 * t * t  # elements in the upper tiles
    assert symv_bytes(n, t) == 4 * (tri + 2 * nb * n)
    assert symv_bytes(n, t) < 0.52 * 4 * n * n


def test_symv_supported_gates(monkeypatch):
    n = 4 * TILE
    assert not symv_supported(n, jnp.float32)  # CPU backend here
    monkeypatch.setattr(symv_mod.jax, "default_backend", lambda: "gpu")
    assert symv_supported(n, jnp.float32)
    assert not symv_supported(n, jnp.float64)
    assert not symv_supported(n, jnp.bfloat16)
    assert not symv_supported(n + TILE, jnp.float32)  # odd tile count


@pytest.mark.parametrize("n", [100, 19996, 20242, 49749])
def test_pad_rows_matches_kernel_tile(monkeypatch, n):
    from krylov_crn_tpu.ops import gram

    cpu = gram.pad_rows(n)
    assert cpu % 256 == 0 and 0 <= cpu - n < 256
    monkeypatch.setattr(gram.jax, "default_backend", lambda: "gpu")
    gpu = gram.pad_rows(n)
    assert gpu % (2 * TILE) == 0 and 0 <= gpu - n < 2 * TILE
    assert symv_supported(gpu, jnp.float32)


def _gram_data(K, symv_flag):
    from krylov_crn_tpu.ops.gram import GramData

    n = K.shape[0]
    z = jnp.zeros(n, K.dtype)
    return GramData(K=K, Ax0=z, b=z, mask=z, x0_sqnorm=jnp.zeros(()),
                    K_lr=None, n=n, d=n, nnz=n, symv=symv_flag)


@pytest.mark.parametrize("dtype,flag,want_kernel", [
    (jnp.float32, True, True),
    (jnp.float32, False, False),
    (jnp.bfloat16, True, False),  # the bf16 Lanczos copy never takes it
    (jnp.float64, True, False),
])
def test_k_matvec_choice(monkeypatch, dtype, flag, want_kernel):
    from krylov_crn_tpu.ops import gram

    calls = []

    def fake_symv(K, q):
        calls.append(K.shape)
        return K @ q

    monkeypatch.setattr(symv_mod, "symv", fake_symv)
    K = jnp.asarray(_sym_fp32(32)).astype(dtype)
    q = jnp.ones(32, dtype)
    gd = _gram_data(K, flag)
    y = gram.k_matvec(gd, gd.K, q)
    assert bool(calls) == want_kernel
    np.testing.assert_allclose(np.asarray(y, np.float64),
                               np.asarray(K @ q, np.float64))


def test_build_gram_sets_symv_flag_from_support(monkeypatch, small_problem):
    """build_gram asks symv_supported; a mesh always turns it off."""
    from krylov_crn_tpu.ops import gram

    A, b, x0 = small_problem
    seen = []

    def fake_supported(n, dtype):
        seen.append(n)
        return True

    monkeypatch.setattr(symv_mod, "symv_supported", fake_supported)
    gd = gram.build_gram(A, b, x0, dtype=np.float32, device_build=False)
    assert gd.symv and seen == [gram.pad_rows(A.shape[0])]

    from krylov_crn_tpu.parallel.mesh import make_mesh

    gd_mesh = gram.build_gram(A, b, x0, dtype=np.float32,
                              device_build=False, mesh=make_mesh(2))
    assert not gd_mesh.symv
