"""Gram-space formulation: rep algebra identities and solver parity."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp

from krylov_crn_tpu import CubicKrylov, LogisticRegression
from krylov_crn_tpu.ops.gram import Rep, build_gram, rep_dot
from krylov_crn_tpu.solvers.krylov_gram import GramKrylov


@pytest.fixture(scope="module")
def gram_problem():
    rng = np.random.default_rng(11)
    n, d = 300, 700  # wide: n << d, the Gram regime
    density = 0.05
    Ad = rng.standard_normal((n, d)) * (rng.random((n, d)) < density)
    A = sp.csr_matrix(Ad)
    x_star = rng.standard_normal(d) / np.sqrt(d)
    b = np.where(Ad @ x_star + 0.4 * rng.standard_normal(n) > 0, 1.0, -1.0)
    x0 = np.ones(d) * 0.5
    return A, b, x0


def test_build_gram(gram_problem):
    A, b, x0 = gram_problem
    gd = build_gram(A, (b + 1) / 2, x0, dtype=np.float64)
    n = A.shape[0]
    K = np.asarray(gd.K)[:n, :n]
    np.testing.assert_allclose(K, (A @ A.T).toarray(), rtol=1e-12)
    np.testing.assert_allclose(np.asarray(gd.Ax0)[:n], A @ x0, rtol=1e-12)
    assert abs(float(gd.x0_sqnorm) - x0 @ x0) < 1e-10


def test_rep_dot_identity(gram_problem):
    """rep_dot must equal the true d-space inner product."""
    A, b, x0 = gram_problem
    gd = build_gram(A, (b + 1) / 2, x0, dtype=np.float64)
    n = A.shape[0]
    rng = np.random.default_rng(0)

    def mk(beta, w_host):
        w = np.zeros(gd.n_padded)
        w[:n] = w_host
        u = beta * np.asarray(gd.Ax0) + np.asarray(gd.K) @ w
        return (Rep(jnp.asarray(float(beta)), jnp.asarray(w),
                    jnp.asarray(u)),
                beta * x0 + A.T @ w_host)

    ra, xa = mk(0.7, rng.standard_normal(n))
    rb, xb = mk(-1.3, rng.standard_normal(n))
    got = float(rep_dot(gd, ra, rb, jnp.float64))
    want = float(xa @ xb)
    assert abs(got - want) < 1e-8 * max(1.0, abs(want))


@pytest.mark.parametrize("l2", [0.0, 1e-2])
def test_gram_krylov_matches_standard(gram_problem, l2):
    """Gram-space Krylov CRN must track the d-space solver step-for-step."""
    A, b, x0 = gram_problem
    it_max = 15

    loss_std = LogisticRegression(A, b, l2=l2)
    std = CubicKrylov(loss=loss_std, reg_coef=1e-3, subspace_dim=8,
                      tolerance=1e-9, tqdm=False, label="std")
    t_std = std.run(x0=x0, it_max=it_max)
    std.compute_loss_of_iterates()

    loss_gram = LogisticRegression(A, b, l2=l2)
    gram = GramKrylov(loss=loss_gram, reg_coef=1e-3, subspace_dim=8,
                      tolerance=1e-9, tqdm=False, label="gram")
    t_gram = gram.run(x0=x0, it_max=it_max)
    gram.compute_loss_of_iterates()

    # the 1e-9 iterate-diff stopping test may fire a few iterations
    # apart between the two formulations (their fp64 rounding streams
    # differ at ~1e-16 and the final steps are sub-1e-9 knife-edges) —
    # the parity claim is the common-prefix trace match below, not the
    # tie-break of the terminal iterations
    k = min(len(t_std.its), len(t_gram.its))
    assert abs(len(t_std.its) - len(t_gram.its)) <= 3
    assert list(t_std.its)[:k] == list(t_gram.its)[:k]
    np.testing.assert_allclose(np.asarray(t_gram.loss_vals)[:k],
                               np.asarray(t_std.loss_vals)[:k],
                               rtol=1e-8, atol=1e-11)
    # the last common iterate materializes to the same point
    x_gram = np.asarray(gram.materialize(t_gram.xs[k - 1]))
    x_std = np.asarray(t_std.xs[k - 1])
    np.testing.assert_allclose(x_gram, x_std, rtol=1e-6, atol=1e-8)


def test_gram_krylov_converges_deep(gram_problem):
    """Reach a tiny gradient norm — validates long-horizon rep stability."""
    A, b, x0 = gram_problem
    loss = LogisticRegression(A, b, l2=1e-3)
    alg = GramKrylov(loss=loss, reg_coef=1e-3, subspace_dim=10,
                     tolerance=1e-12, tqdm=False, label="gram")
    alg.run(x0=x0, it_max=60)
    assert float(alg.state.grad_norm) < 1e-8
    # margins invariant: Ax == gamma*Ax0 + K zeta (rep consistency)
    gd = alg.gd
    st = alg.state
    want = float(st.gamma) * np.asarray(gd.Ax0) + \
        np.asarray(gd.K) @ np.asarray(st.zeta)
    np.testing.assert_allclose(np.asarray(st.Ax), want, rtol=1e-8,
                               atol=1e-10)


def test_device_K_build_matches_host(gram_problem):
    """_build_K_device (scatter + panel GEMMs) == scipy A @ A.T."""
    from krylov_crn_tpu.ops.gram import _build_K_device

    A, b, x0 = gram_problem
    n = A.shape[0]
    n_pad = ((n + 255) // 256) * 256
    K = np.asarray(_build_K_device(A, n_pad, np.float64, col_block=256))
    np.testing.assert_allclose(K[:n, :n], (A @ A.T).toarray(),
                               rtol=1e-10, atol=1e-12)
    np.testing.assert_array_equal(K[n:], 0)


def test_device_K_build_fp32_split_matches_host(gram_problem):
    """fp32 K builds accumulate their panel GEMMs in fp64 and round once
    (ops/gram.KACC): the device K is the exact A A^T correctly rounded —
    elementwise within half an fp32 ulp, no bias. A build that
    accumulates in fp32 (biased on GPU tensor cores, measured -6.6e-7
    mean relative error on the H100) fails the ulp bound."""
    from krylov_crn_tpu.ops.gram import KACC, _build_K_device

    A, b, x0 = gram_problem
    assert KACC == jnp.float64
    n = A.shape[0]
    n_pad = ((n + 255) // 256) * 256
    K = np.asarray(_build_K_device(A, n_pad, np.float32, col_block=256))
    assert K.dtype == np.float32
    A32 = A.astype(np.float32).astype(np.float64)  # the values shipped
    want = (A32 @ A32.T).toarray()
    err = np.abs(K[:n, :n].astype(np.float64) - want)
    assert np.all(err <= 2.0**-24 * np.abs(want) + 1e-300), \
        f"max err {err.max():.3g}: K is not the rounded exact Gram"
    np.testing.assert_array_equal(K[n:], 0)


def test_gram_crn_matches_standard_cg(gram_problem):
    """Gram-space CRN-CG tracks the d-space CRN-CG solver."""
    from krylov_crn_tpu.solvers.crn_gram import GramCRN

    A, b, x0 = gram_problem
    it_max = 6

    from krylov_crn_tpu import CubicNewton

    loss_std = LogisticRegression(A, b, want_dense=False)
    std = CubicNewton(loss=loss_std, reg_coef=1e-3, cubic_solver="CG",
                      tolerance=1e-8, tqdm=False, label="std")
    std.run(x0=x0, it_max=it_max)

    loss_gram = LogisticRegression(A, b)
    gram = GramCRN(loss=loss_gram, reg_coef=1e-3, tolerance=1e-8,
                   tqdm=False, label="gram")
    gram.run(x0=x0, it_max=it_max)

    assert abs(float(gram.state.value) - float(std.state.value)) < 1e-8
    assert abs(float(gram.state.grad_norm) - float(std.state.grad_norm)) \
        < 1e-6 * max(1.0, float(std.state.grad_norm))


def test_candidate_df_extreme_margins_fp32():
    """The fp32 difference-form loss change must stay finite and accurate
    at extreme margins/increments (advisor round-3 finding: the log1p
    form returns -inf for m<=-17 with inc>=+17, and expm1 overflows for
    inc<=-88 — a -inf candidate is unconditionally accepted and corrupts
    the committed value chain)."""
    from krylov_crn_tpu.ops.gram import GramData
    from krylov_crn_tpu.solvers.krylov_gram import _candidate_df

    n = 8
    rng = np.random.default_rng(3)
    margins = np.array([-20.0, -17.5, 30.0, 0.3, -0.2, 5.0, -90.0, 2.0])
    incs = np.array([+20.0, +17.0, -100.0, 0.01, -0.05, -3.0, +4.0, 1.0])
    b = (rng.random(n) < 0.5).astype(np.float64)

    gd = GramData(
        K=jnp.zeros((n, n), jnp.float32),
        Ax0=jnp.asarray(margins, jnp.float32),
        b=jnp.asarray(b, jnp.float32),
        mask=jnp.ones(n, jnp.float32),
        x0_sqnorm=jnp.asarray(1.0, jnp.float32),
        K_lr=None, n=n, d=n, nnz=n,
    )
    hi, lo = _candidate_df(gd, jnp.asarray(margins, jnp.float32),
                           jnp.asarray(incs, jnp.float32), jnp.float32)
    got = float(hi) + float(lo)
    assert np.isfinite(got), "difference-form change overflowed to inf/nan"

    def f64(m):
        ls = np.where(m < 0, m - np.log1p(np.exp(m)), -np.log1p(np.exp(-m)))
        return float(np.mean((1.0 - b) * m - ls))

    want = f64(margins + incs) - f64(margins)
    # fp32 difference-form: accurate relative to the CHANGE
    assert abs(got - want) < 1e-5 * max(1.0, abs(want))


def test_build_gram_fused_matches_plain(gram_problem):
    """The fused build+finalize+init path (one device program) must
    produce the same GramData and initial state as the plain
    build_gram + _init_state_packed route."""
    import jax

    from krylov_crn_tpu.ops.gram import build_gram_fused
    from krylov_crn_tpu.models.logistic import LogisticRegression
    from krylov_crn_tpu.solvers.krylov_gram import GramKrylov

    A, b, x0 = gram_problem
    n = A.shape[0]
    dtype = np.float64
    loss = LogisticRegression(A, b, dtype=dtype)
    alg = GramKrylov(loss=loss, reg_coef=1e-3, tqdm=False, label="g")
    st_plain = alg.init_state(jnp.asarray(x0, dtype), 0)
    gd_plain = alg.gd

    # reconstruct the same init buffer the solver built
    from scipy.special import expit

    npad = gd_plain.n_padded
    x0h = np.asarray(x0, np.float64)
    m64 = loss.A_host.dot(x0h)
    b64 = np.asarray(loss.b, np.float64)[:n]
    w64 = (expit(m64) - b64) / n
    uK64 = loss.A_host.dot(loss.A_host.T.dot(w64))
    ls = np.where(m64 < 0, m64 - np.log1p(np.exp(m64)),
                  -np.log1p(np.exp(-m64)))
    v64 = float(np.mean((1.0 - b64) * m64 - ls))
    buf = np.zeros(3 * npad + 3, dtype)
    buf[:n] = (m64 - m64.astype(dtype).astype(np.float64)).astype(dtype)
    buf[npad:npad + n] = w64.astype(dtype)
    buf[2 * npad:2 * npad + n] = uK64.astype(dtype)
    cd = np.dtype(dtype)
    vhi = cd.type(v64)
    buf[3 * npad:3 * npad + 3] = (vhi, cd.type(v64 - float(vhi)), 1e-3)

    for seg_p in (64, 2):  # single-program path and the segmented path
        gd_f, flat = build_gram_fused(loss.A_host, np.asarray(loss.b)[:n],
                                      x0h, buf, dtype, jnp.dtype(dtype),
                                      seg_p=seg_p)
        _check_fused(gd_f, flat, gd_plain, st_plain)


def _check_fused(gd_f, flat, gd_plain, st_plain):
    # different panel decompositions change fp64 addition order
    np.testing.assert_allclose(np.asarray(gd_f.K),
                               np.asarray(gd_plain.K), rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_allclose(np.asarray(gd_f.Ax0),
                               np.asarray(gd_plain.Ax0), rtol=1e-12)
    st_f = type(st_plain)(*flat)
    for name in st_plain._fields:
        a = np.asarray(getattr(st_f, name))
        bb = np.asarray(getattr(st_plain, name))
        np.testing.assert_allclose(a, bb, rtol=1e-12, atol=0,
                                   err_msg=name)


def test_build_gram_fused_multisegment():
    """The multi-segment fused build (seg0 + continuation + fused
    finalize executables) must reproduce the host Gram exactly. The
    module fixture has d=700 -> ONE 1024-wide panel, so only this test
    reaches the seg0/seg/fin programs: d=7000 gives four 2048-wide
    panels, and seg_p=1 routes one panel per segment."""
    from scipy.special import expit

    from krylov_crn_tpu.models.logistic import LogisticRegression
    from krylov_crn_tpu.ops.gram import (
        _pack_flat_panels,
        build_gram_fused,
        pad_rows,
        warm_build_gram_fused,
    )
    from krylov_crn_tpu.solvers.krylov_gram import GramKrylov

    rng = np.random.default_rng(5)
    n, d = 150, 7000
    Ad = rng.standard_normal((n, d)) * (rng.random((n, d)) < 0.01)
    A = sp.csr_matrix(Ad)
    b = np.where(rng.random(n) > 0.5, 1.0, -1.0)
    x0 = np.ones(d) * 0.5
    dtype = np.float64

    assert _pack_flat_panels(A, pad_rows(n), np.dtype(dtype)) is not None
    nblk = _pack_flat_panels(A, pad_rows(n), np.dtype(dtype))[7]
    assert nblk >= 3, "fixture must span several panels"

    loss = LogisticRegression(A, b, dtype=dtype)
    alg = GramKrylov(loss=loss, reg_coef=1e-3, tqdm=False, label="g")
    st_plain = alg.init_state(jnp.asarray(x0, dtype), 0)
    gd_plain = alg.gd

    npad = gd_plain.n_padded
    m64 = loss.A_host.dot(x0)
    b64 = np.asarray(loss.b, np.float64)[:n]
    w64 = (expit(m64) - b64) / n
    uK64 = loss.A_host.dot(loss.A_host.T.dot(w64))
    ls = np.where(m64 < 0, m64 - np.log1p(np.exp(m64)),
                  -np.log1p(np.exp(-m64)))
    v64 = float(np.mean((1.0 - b64) * m64 - ls))
    buf = np.zeros(3 * npad + 3, dtype)
    buf[:n] = (m64 - m64.astype(dtype).astype(np.float64)).astype(dtype)
    buf[npad:npad + n] = w64.astype(dtype)
    buf[2 * npad:2 * npad + n] = uK64.astype(dtype)
    cd = np.dtype(dtype)
    vhi = cd.type(v64)
    buf[3 * npad:3 * npad + 3] = (vhi, cd.type(v64 - float(vhi)), 1e-3)

    # warm path must accept the same shapes the real build dispatches
    assert warm_build_gram_fused(A, dtype, jnp.dtype(dtype), seg_p=1)
    gd_f, flat = build_gram_fused(A, b, x0, buf, dtype, jnp.dtype(dtype),
                                  seg_p=1)
    _check_fused(gd_f, flat, gd_plain, st_plain)
    K_host = (Ad @ Ad.T)
    np.testing.assert_allclose(np.asarray(gd_f.K)[:n, :n], K_host,
                               rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("col_block", [64, 256])
def test_split_panel_accum_K_bitwise_symmetric(col_block):
    """The SYMV kernel's premise is that K is EXACTLY symmetric, so
    reading only the upper triangle loses nothing. A GEMM's (i, j) and
    (j, i) entries need not round alike; the build therefore rounds
    0.5 * (K + K^T) (ops/gram._round_K) — pinned bitwise here over many
    panels of the production fp32 route."""
    from krylov_crn_tpu.ops.gram import _build_K_device

    rng = np.random.default_rng(7)
    n, d = 256, 1000
    A = sp.random(n, d, density=0.05, random_state=rng, format="csr",
                  dtype=np.float64)
    K = np.asarray(_build_K_device(A, n, np.float32, col_block=col_block))
    assert np.array_equal(K, K.T), "fp32 K build is not bitwise symmetric"
