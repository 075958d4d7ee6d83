"""Compensated (two-float) fp32 numerics vs fp64 ground truth.

BASELINE.md's convergence-parity row requires the fp32 device solver to
resolve the reference's 1e-8/1e-9 suboptimality gaps. Plain fp32 sums of
~20k O(1) loss terms carry ~1e-4..1e-6 absolute error — these tests prove
the two-float pipeline (ops/math.py) recovers the missing precision and
that the pure-fp32 Gram solver (accum_dtype=float32, exactly the GPU
configuration with x64 off) tracks the fp64 run's optimum to <1e-8.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from krylov_crn_tpu.ops.math import (
    accum_sum_pair,
    dot2,
    pair_diff,
    sum2,
    two_sum,
)


def test_sum2_beats_plain_fp32(rng):
    x = (rng.standard_normal(19996) * 0.7 + 0.69).astype(np.float32)
    true = np.sum(x.astype(np.float64))
    plain = float(jnp.sum(jnp.asarray(x)))
    hi, lo = jax.jit(sum2)(jnp.asarray(x))
    comp = float(hi) + float(lo)
    assert abs(comp - true) < 1e-9 * abs(true)
    assert abs(comp - true) < abs(plain - true) / 100


def test_dot2_beats_plain_fp32(rng):
    x = rng.standard_normal(12345).astype(np.float32)
    y = rng.standard_normal(12345).astype(np.float32)
    true = np.dot(x.astype(np.float64), y.astype(np.float64))
    hi, lo = jax.jit(dot2)(jnp.asarray(x), jnp.asarray(y))
    comp = float(hi) + float(lo)
    assert abs(comp - true) < 1e-9 * np.dot(np.abs(x), np.abs(y))


def test_two_sum_exact():
    # the error term must be the exact rounding residue
    a = jnp.float32(0.69314718)
    b = jnp.float32(3.7e-9)
    s, e = jax.jit(two_sum)(a, b)
    got = np.float64(s) + np.float64(e)
    want = np.float64(a) + np.float64(b)
    assert got == want


def test_pair_diff_resolves_tiny_gaps():
    # two values ~0.69 apart by 3.7e-9: far below fp32 eps at that scale
    a64 = 0.6931471805599453
    b64 = a64 + 3.7e-9
    ah = np.float32(a64)
    al = np.float32(a64 - np.float64(ah))
    bh = np.float32(b64)
    bl = np.float32(b64 - np.float64(bh))
    d = float(jax.jit(pair_diff)(jnp.float32(bh), jnp.float32(bl),
                                 jnp.float32(ah), jnp.float32(al)))
    assert abs(d - 3.7e-9) < 1e-15


def test_pair_diff_nan_propagates():
    nan = jnp.float32(np.nan)
    z = jnp.float32(0.0)
    d = jax.jit(pair_diff)(nan, z, jnp.float32(1.0), z)
    assert bool(jnp.isnan(d))
    # NaN gap must never satisfy the accept test
    assert not bool(d <= jnp.float32(0.0))


def test_accum_sum_pair_fp64_path_has_zero_lo(rng):
    x = rng.standard_normal(1000)  # fp64 under x64
    hi, lo = accum_sum_pair(jnp.asarray(x, jnp.float32), jnp.float64)
    assert float(lo) == 0.0
    assert abs(float(hi) - np.sum(x.astype(np.float32).astype(np.float64))) \
        < 1e-12


def test_gram_value_pair_fp32_tracks_fp64(small_problem):
    """f computed from fp32 margins: the pair must agree with fp64
    evaluation of the same margins to ~n*eps^2, far below 1e-8."""
    from krylov_crn_tpu.models.logistic import LogisticRegression
    from krylov_crn_tpu.solvers.krylov_gram import GramKrylov, _gram_value

    A, b, x0 = small_problem
    loss = LogisticRegression(A, b, dtype=np.float32)
    alg = GramKrylov(loss=loss, reg_coef=1e-3, subspace_dim=5, tolerance=0,
                     tqdm=False, label="g32")
    st = alg.init_state(jnp.asarray(x0, jnp.float32), 42)
    gd = alg.gd

    hi, lo = _gram_value(gd, st.Ax, jnp.float32(0.0), 0.0, jnp.float32)
    comp = float(hi) + float(lo)

    # the same fp32 terms, exact (fp64) summation: isolates the compensated
    # reduction (per-term fp32 rounding is identical on both sides)
    terms32 = (((1.0 - gd.b) * st.Ax - jax.nn.log_sigmoid(st.Ax))
               * (gd.mask / gd.n))
    assert terms32.dtype == jnp.float32
    want = np.sum(np.asarray(terms32, np.float64))
    assert abs(comp - want) < 1e-10

    # and the fp64 evaluation of the same margins stays within the
    # accumulated per-term rounding envelope (~sqrt(n) * eps * |term|)
    Ax64 = np.asarray(st.Ax, np.float64)
    b64 = np.asarray(gd.b, np.float64)
    m64 = np.asarray(gd.mask, np.float64)
    terms = ((1.0 - b64) * Ax64 + np.logaddexp(0.0, -Ax64)) * m64
    assert abs(comp - terms.sum() / gd.n) < 2e-7


def test_fp32_pair_solver_matches_fp64_optimum(small_problem):
    """Pure-fp32 Gram Krylov-CRN (accum_dtype=float32 — the exact GPU
    configuration) must reach the fp64 run's optimum to <1e-8."""
    from krylov_crn_tpu.models.logistic import LogisticRegression
    from krylov_crn_tpu.solvers.krylov_gram import (
        GramKrylov,
        gram_krylov_multistep,
    )

    A, b, x0 = small_problem
    iters = 40

    # fp64 run (plain pipeline, lo = 0) — the verification baseline
    loss64 = LogisticRegression(A, b, dtype=np.float64)
    alg64 = GramKrylov(loss=loss64, reg_coef=1e-3, subspace_dim=10,
                       tolerance=0, tqdm=False, label="g64")
    st64 = alg64.init_state(jnp.asarray(x0, jnp.float64), 42)
    kw64 = dict(m=10, l2=0.0, beta=0.5, solver_eps=1e-8, solver_it_max=100,
                ls_max=20, reorth_passes=1, accum_dtype=jnp.float64)
    st64, _ = gram_krylov_multistep(alg64.gd, st64, chunk=iters, **kw64)
    f64 = float(st64.value) + float(st64.value_lo)

    # fp32 run with fp32 accumulation: pairs carry the missing precision
    loss32 = LogisticRegression(A, b, dtype=np.float32)
    alg32 = GramKrylov(loss=loss32, reg_coef=1e-3, subspace_dim=10,
                       tolerance=0, tqdm=False, label="g32")
    st32 = alg32.init_state(jnp.asarray(x0, jnp.float32), 42)
    # under x64 init_state accumulates in fp64; split-cast the scalars to
    # fp32 pairs (hi = fl32(v), lo = fl32(v - hi)) — exactly the state a
    # real x64-off GPU run starts from
    def pair32(hi, lo):
        v = float(hi) + float(lo)
        h = np.float32(v)
        return jnp.float32(h), jnp.float32(v - np.float64(h))

    vh, vl = pair32(st32.value, st32.value_lo)
    st32 = st32._replace(value=vh, value_lo=vl, f_best=vh, f_best_lo=vl)
    kw32 = dict(kw64, accum_dtype=jnp.float32)
    # pure fp32 K (the fp32-tail configuration of GramKrylov)
    import dataclasses
    gd32 = dataclasses.replace(alg32.gd, K_lr=None)
    st32, (vpairs, _, _, _) = gram_krylov_multistep(
        gd32, st32, chunk=iters, **kw32)
    f32 = float(st32.value) + float(st32.value_lo)

    # correction-less device floor: with no host boundary corrections the
    # incremental margin/image drift accumulates step-sized GEMM rounding
    # and the run freezes ~1e-8 above the optimum (measured 1.2e-8 here)
    # — this is why run_fused's exact fp64 corrections exist
    zeta = np.asarray(st32.zeta, np.float64)[: A.shape[0]]
    x32 = float(st32.gamma) * np.asarray(x0, np.float64) + A.T @ zeta
    margins = A @ x32
    b01 = np.asarray(loss64.b, np.float64)[: A.shape[0]]
    f32_true = np.mean((1.0 - b01) * margins + np.logaddexp(0.0, -margins))
    assert f32_true - f64 < 5e-8

    # THE claim (BASELINE.md convergence-parity row): the PRODUCTION fp32
    # path — run_fused with exact fp64 boundary corrections, the exact
    # GPU configuration — reaches the fp64 optimum below the reference's
    # 1e-8 gap target (exact host-verified values, not device readouts)
    loss32b = LogisticRegression(A, b, dtype=np.float32)
    alg32b = GramKrylov(loss=loss32b, reg_coef=1e-3, subspace_dim=10,
                        tolerance=0, tqdm=False, label="g32f")
    tr = alg32b.run_fused(np.asarray(x0), it_max=iters, chunk=8)
    f_fused = min(tr.metrics["exact_fs"])
    assert f_fused - f64 < 1e-8
    # the device-side pair value agrees with the fp64 host value up to the
    # fp32 K-matvec rounding in the margins (well below plain-fp32 error)
    assert abs(f32 - f32_true) < 5e-6
    # the pair-resolved trajectory is sane: ends at least 1e-4 below start
    vals = (np.asarray(vpairs[0], np.float64)
            + np.asarray(vpairs[1], np.float64))
    assert vals[-1] < vals[0] - 1e-4


def _scale_problem(own_frac):
    from krylov_crn_tpu.data.synthetic import synthetic_logreg

    # R=24 << conflict twins (2% * 4096 / 2 = 40): the twins span the
    # row space and the optimum is attained
    A, b = synthetic_logreg((4096, 8192, 131072), seed=2, profile="topic",
                            topic_params=dict(R=24, n_clusters=8,
                                              own_frac=own_frac,
                                              pop_exp=1.1))
    return A, b, np.ones(A.shape[1]) * 0.5


def _run_pair(A, b, x0, it_max):
    from krylov_crn_tpu.models.logistic import LogisticRegression
    from krylov_crn_tpu.solvers.krylov_gram import GramKrylov

    loss64 = LogisticRegression(A, b, dtype=np.float64)
    a64 = GramKrylov(loss=loss64, reg_coef=1e-3, subspace_dim=10,
                     tolerance=0, tqdm=False, label="s64")
    t64 = a64.run_fused(x0, it_max=it_max, chunk=16)
    loss32 = LogisticRegression(A, b, dtype=np.float32)
    a32 = GramKrylov(loss=loss32, reg_coef=1e-3, subspace_dim=10,
                     tolerance=0, tqdm=False, label="s32")
    t32 = a32.run_fused(x0, it_max=it_max, chunk=16)
    return float(np.min(t64.loss_vals)), t32


def test_fp32_production_path_at_scale_fast_tail():
    """n~4k topic problem with an interior optimum (the benchmark
    datasets' class): the production fp32 path must reach the fp64 run's
    value below the 1e-8 gap target. Round 2's 400-row-only coverage
    hid n-scaled noise floors."""
    A, b, x0 = _scale_problem(own_frac=0.45)
    f64, t32 = _run_pair(A, b, x0, it_max=64)
    f32 = min(t32.metrics["exact_fs"])  # exact fp64 host-verified
    assert f32 - f64 < 1e-8


def test_fp32_at_scale_slow_tail_monotone_verified():
    """n~4k problem with a slow-linear tail (curvature directions >> m):
    fp32 cannot resolve the last ~1e-6 that fp64 grinds out (documented
    envelope, PERF.md round 3) — but the trust-but-verify loop must
    guarantee a MONOTONE exact boundary curve (no wandering: round 3
    found device-value selection bias walking the iterate sideways while
    'decreasing'), and the verified floor must stay within 5e-6 of the
    equal-budget fp64 value."""
    A, b, x0 = _scale_problem(own_frac=0.6)
    f64, t32 = _run_pair(A, b, x0, it_max=48)
    fs = t32.metrics["exact_fs"]
    assert all(b2 < a2 for a2, b2 in zip(fs, fs[1:]))  # strictly monotone
    assert min(fs) - f64 < 5e-6
