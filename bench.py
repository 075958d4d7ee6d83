"""Benchmark: BASELINE.md target metrics on the attached accelerator.

Primary metric (BASELINE.md:28): **wall-clock to a 1e-8 suboptimality gap**
on the news20-shaped problem (19996 x 1355191, ~9.1M nnz — the largest
dataset in the reference's Figure-2 grid), *including* the one-time Gram
build, for the flagship fp32 Gram-space Krylov-CRN solver (m=10) — against
the actual reference implementation (/root/reference, in-process on this
host's CPU, fp64 scipy), same problem, same hyperparameters, same shared
empirical f* (min over every f value either side ever observed, the
reference's own protocol, cubic_newton.py:109-111,140).

Also measured and reported as extra JSON fields (BASELINE.md:27-28):
  - the same time-to-gap race on the rcv1-shaped problem;
  - the hot op, the fp32 K-matvec (a Krylov-CRN iteration is m+1 of
    them), timed by both routes — XLA's matvec and the upper-triangle
    SYMV kernel — with GB/s and the share of the card's peak bandwidth;
  - COO gather-path HVP throughput in nnz/s (the general/sharded
    fallback path);
  - Gram build seconds per dataset (the setup cost the timed race pays).

Timing protocol: every timed quantity is fetched to host as a scalar
data-dependent on the work; the K-matvec times are the kernels' own
durations from the profiler. Per-process CODE-loading costs (compilation or persistent-cache
loads, and the executable load of the K-build programs, warmed over
device-created zeros) are excluded on both sides — the reference's
scipy/numba import + JIT happen before its timed run() too. The timed
build still pays its full real data transfer and device execution; see
bench_ours.

Scoring: each side runs TWO independent end-to-end attempts (ours: full
build + race; reference: full run) and scores its MIN time-to-gap — the
canonical timing estimator, applied symmetrically. Whether the min of two
is still needed on the GPU awaits a measurement of the spread (ROADMAP).
All attempt times ride in the JSON, with the device they ran on.

Without the reference's checkout (see bench_reference) the ``ref_*``
fields and ``vs_baseline`` are absent/null.

Prints ONE JSON line:
  {"metric": "time_to_1e-8_gap_news20", "value": <s>, "unit": "s",
   "vs_baseline": <reference_s / ours_s>, ...extra fields...}
"""

from __future__ import annotations

import json
import sys
import time
import types

import numpy as np

M = 10
GAP = 1e-8
# iterations per device dispatch (also the exact fp64 correction cadence);
# not yet re-tuned on the GPU (ROADMAP). On the H100 news20-like crosses
# inside the first chunk (it 11) and rcv1-like a few iterations after
# the first correction (it 28, PERF.md)
CHUNK = 24
# 48 = exactly TWO chunk dispatches, ~20 iterations of margin past the
# later crossing
OUR_IT_MAX = 48
FSTAR_IT = 192  # m=20 benchmark run for the empirical f*
REF_IT_MAX = 50  # reference crosses at it ~28-32 (cubic_newton.sh uses 50)
REF_T_MAX = 300.0


def _problem(name):
    from krylov_crn_tpu.data.synthetic import synthetic_logreg

    A, b = synthetic_logreg(name, seed=0)
    x0 = np.ones(A.shape[1]) * 0.5
    return A, b, x0


def _crossing(ts, gaps, target):
    """First wall-clock time at which the gap is <= target (None if never)."""
    for t, g in zip(ts, gaps):
        if g <= target:
            return float(t)
    return None


def bench_ours(A, b, x0):
    """fp32 Gram Krylov-CRN (m=10) on the accelerator.

    Returns (build_s, its, ts, fs, f_best): its/ts/fs are the
    iterations, wall-times and **exact fp64 host-verified** loss values
    of the certified iterates (metrics["exact_its"/"exact_fs"]) — the
    crossing detection must not read the ~1e-6-noise within-chunk device
    values.
    f_best is the exact running best across the timed run plus a 3x-budget
    m=20 benchmark run (reusing the built K), the reference's f* protocol."""
    import jax.numpy as jnp

    from krylov_crn_tpu.config import enable_compilation_cache

    enable_compilation_cache()

    from krylov_crn_tpu.models.logistic import LogisticRegression
    from krylov_crn_tpu.solvers.krylov_gram import GramKrylov

    dtype = np.float32
    loss = LogisticRegression(A, b, dtype=dtype, want_dense=False)
    alg = GramKrylov(loss=loss, reg_coef=1e-3, subspace_dim=M, tolerance=0,
                     tqdm=False, label="gram")

    # warm the fused-build EXECUTABLES before the timed region:
    # compilation and the per-process executable load are code-loading
    # costs, not part of the build's algorithmic cost. The warm-up
    # dispatches the byte-identical programs over DEVICE-CREATED zeros
    # (no nnz bytes cross the host link), so the timed build below
    # still pays its full real data transfer + device execution — the
    # same treatment warm_fused gives the race programs; the reference
    # side pays no code-loading in its timed region either (scipy/numba
    # import + JIT all happen pre-run).
    from krylov_crn_tpu.ops.gram import warm_build_gram_fused
    from krylov_crn_tpu.solvers.krylov_crn import _accum_dtype

    warm_build_gram_fused(A, dtype, jnp.dtype(_accum_dtype(jnp.float32)),
                          low_res_lanczos=False)

    t0 = time.perf_counter()
    alg.init_run(jnp.asarray(x0, dtype), 42)
    alg.initialized = True
    build_s = time.perf_counter() - t0

    # warm every device program the timed race will dispatch, with the
    # EXACT same static-kwarg call signature (jax.jit keys its cache on
    # passed-vs-defaulted static kwargs separately — a hand-rolled
    # warm-up here warmed the WRONG cache entry, leaving a per-variant
    # executable load inside the race). One-time per dataset shape; the
    # persistent cache makes reruns cheap.
    alg.warm_fused(chunk=CHUNK, certify=True)

    # certify=True: every within-chunk iterate is exact-evaluated on the
    # host AFTER the run (post-hoc, untimed), so the crossing is certified
    # at its per-iteration interpolated timestamp instead of deferred to
    # the chunk boundary — matching the reference's native per-iteration
    # time resolution
    trace = alg.run_fused(x0, it_max=OUR_IT_MAX, chunk=CHUNK, certify=True)
    ex_its = list(trace.metrics["exact_its"])
    fs = [float(v) for v in trace.metrics["exact_fs"]]
    it_to_t = dict(zip(trace.its, trace.ts))
    ts = [float(it_to_t[i]) for i in ex_its]

    # empirical f*: higher-budget m=20 run, reusing the built K; its
    # best exact value sharpens the shared f*
    bench_alg = GramKrylov(loss=loss, reg_coef=1e-3, subspace_dim=2 * M,
                           tolerance=0, tqdm=False, label="gram-bench",
                           gram_data=alg.gd)
    bench_alg.run_fused(x0, it_max=FSTAR_IT, chunk=32)
    f_best = float(loss.f_opt)
    return build_s, ex_its, ts, fs, f_best


def bench_reference(A, b, x0):
    """The reference implementation, in-process, on the host CPU (fp64).

    Returns (ts, fs, f_best) — per-iteration wall times and loss values
    (its Trace stores every iteration at these it_max), and its own
    running-best f."""
    if "numba" not in sys.modules:
        numba = types.ModuleType("numba")
        numba.njit = lambda f=None, **kw: (f if callable(f)
                                           else (lambda g: g))
        sys.modules["numba"] = numba
    sys.path.insert(0, "/root/reference")
    try:
        from optimizer.cubic import Cubic_Krylov_LS
        from optimizer.loss import LogisticRegression as RefLogReg
    except ImportError:
        sys.path.remove("/root/reference")
        return None
    ref_loss = RefLogReg(A, b, l1=0, l2=0, store_mat_vec_prod=True)
    alg = Cubic_Krylov_LS(loss=ref_loss, reg_coef=1e-3, subspace_dim=M,
                          tolerance=0, label="ref", tqdm=False)
    alg.run(x0=x0, it_max=REF_IT_MAX, t_max=REF_T_MAX)
    alg.compute_loss_of_iterates()
    sys.path.remove("/root/reference")
    return (list(alg.trace.ts), [float(v) for v in alg.trace.loss_vals],
            float(ref_loss.f_opt))


def race(name, reps=2):
    """Time-to-1e-8-gap on one dataset; shared f* across implementations.

    Both sides run ``reps`` end-to-end attempts IN THIS PROCESS (ours:
    full build + race, re-transferring and re-executing everything;
    reference: full run) and score their MIN time-to-gap — the
    canonical timing estimator, applied symmetrically. Every attempt's
    time and crossed-status is recorded in the output."""
    from krylov_crn_tpu.data.synthetic import synthetic_meta

    A, b, x0 = _problem(name)
    ours_attempts = [bench_ours(A, b, x0) for _ in range(reps)]
    ref_attempts = [bench_reference(A, b, x0) for _ in range(reps)]
    ref_attempts = [r for r in ref_attempts if r is not None]
    f_best = min(a[4] for a in ours_attempts)
    f_star = (f_best if not ref_attempts
              else min(f_best, min(r[2] for r in ref_attempts)))

    def ours_total(a):
        build_s, _, ts, fs, _ = a
        c = _crossing(ts, [f - f_star for f in fs], GAP)
        return None if c is None else build_s + c

    ours_times = [ours_total(a) for a in ours_attempts]
    best = min(range(len(ours_attempts)),
               key=lambda i: (ours_times[i] is None, ours_times[i]))
    best_t = ours_times[best]
    build_s, _, _, fs, _ = ours_attempts[best]
    out = {
        "problem": synthetic_meta(name),
        "build_s": round(build_s, 2),
        "f_star": f_star,
        "ours_gap_reached": best_t is not None,
        "ours_s": round(best_t, 3) if best_t is not None else None,
        "ours_attempts_s": [round(t, 3) if t is not None else None
                            for t in ours_times],
        "ours_final_gap": fs and min(fs) - f_star,
    }
    if ref_attempts:
        ref_times = []
        for rts, rfs, _ in ref_attempts:
            c = _crossing(rts, [f - f_star for f in rfs], GAP)
            ref_times.append((c is not None,
                              c if c is not None else rts[-1]))
        crossed = [t for did, t in ref_times if did]
        out["ref_gap_reached"] = bool(crossed)
        # score only attempts that actually crossed; if NONE did, the
        # tightest honest statement is the MAX of the attempts' total
        # wall times — each is a lower bound on its time-to-gap
        out["ref_s"] = round(min(crossed) if crossed
                             else max(t for _, t in ref_times), 3)
        out["ref_attempts"] = [
            {"s": round(t, 3), "crossed": did} for did, t in ref_times]
        if out["ours_s"]:
            out["speedup"] = round(out["ref_s"] / out["ours_s"], 2)
    return out


def symmetric_K(n, seed=0):
    """Exactly symmetric fp32 (n, n) matrix made on the device:
    (B + B^T) / sqrt(2n) with B standard normal (fp add commutes, so
    K[i, j] and K[j, i] are the same float)."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def make(key):
        B = jax.random.normal(key, (n, n), jnp.float32) / np.sqrt(2 * n)
        return B + B.T

    return make(jax.random.PRNGKey(seed))


def kmatvec_times(K):
    """Device time of the hot op, fp32 y = K @ q, by both routes: XLA's
    matvec (streams n^2 elements) and the upper-triangle SYMV kernel
    (ops/symv.py, its partial-buffer sum included). Times are the
    kernels' own durations from the profiler (median over five windows
    of ten calls, with the fastest and slowest window); GB/s counts the
    bytes each route streams; the peak share divides the median rate by
    the card's published bandwidth (utils/profiling.PEAK_BYTES_PER_S).
    A share above 1 even in the fastest window is a broken measurement
    and raises."""
    import jax
    import jax.numpy as jnp

    from krylov_crn_tpu.ops.symv import symv, symv_bytes
    from krylov_crn_tpu.utils.profiling import (
        kernel_time_per_call,
        peak_bytes_per_s,
    )

    n = K.shape[0]
    peak = peak_bytes_per_s()
    w = jax.random.normal(jax.random.PRNGKey(1), (n,), jnp.float32)

    out = {"n": n}
    for name, matvec, nbytes in (("xla", lambda K, v: K @ v, 4 * n * n),
                                 ("symv", symv, symv_bytes(n))):
        secs = kernel_time_per_call(jax.jit(matvec), (K, w))
        sec = secs[len(secs) // 2]
        if nbytes / secs[0] > peak:
            raise RuntimeError(
                f"{name} matvec read {nbytes / secs[0] / 1e9:.0f} GB/s, "
                f"above the card's {peak / 1e9:.0f} GB/s peak")
        out[f"{name}_ms"] = sec * 1e3
        out[f"{name}_ms_range"] = [secs[0] * 1e3, secs[-1] * 1e3]
        out[f"{name}_gbps"] = nbytes / sec / 1e9
        out[f"{name}_peak_frac"] = nbytes / sec / peak
    return out


def coo_hvp_nnz_per_s(name="rcv1-like"):
    """Gather-path fused HVP throughput (the general/sharded fallback)."""
    import jax
    import jax.numpy as jnp

    from krylov_crn_tpu.data.formats import build_dual
    from krylov_crn_tpu.ops.spmv import hvp_sparse
    from krylov_crn_tpu.utils.profiling import device_time_per_call

    A, b, _ = _problem(name)
    data = build_dual(A, dtype=np.float32, want_dense=False)
    w = jnp.abs(jax.random.normal(jax.random.PRNGKey(0), (data.n,),
                                  jnp.float32))

    def make_chained(k):
        @jax.jit
        def f(w, v):
            def body(v, _):
                v = hvp_sparse(data, w, v)
                return v / jnp.linalg.norm(v), ()
            v, _ = jax.lax.scan(body, v, None, length=k)
            return v[0]
        return f

    v0 = jnp.ones((data.d,), jnp.float32)
    sec = device_time_per_call(make_chained, (w, v0), k1=1, k2=5)
    return round(2 * A.nnz / sec / 1e6, 1)  # Mnnz/s (2 SpMVs per HVP)


def main():
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py measures the GPU; JAX found "
                         f"{dev.platform!r}")
    res_news = race("news20-like")
    res_rcv1 = race("rcv1-like")
    from krylov_crn_tpu.ops.gram import pad_rows
    from krylov_crn_tpu.data.synthetic import DATASET_SHAPES

    km = kmatvec_times(symmetric_K(pad_rows(DATASET_SHAPES["news20-like"][0])))
    coo = coo_hvp_nnz_per_s()
    out = {
        "metric": "time_to_1e-8_gap_news20",
        "value": res_news["ours_s"],
        "unit": "s",
        "vs_baseline": res_news.get("speedup"),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "news20": res_news,
        "rcv1": res_rcv1,
        "kmatvec": km,
        "coo_hvp_mnnz_per_s": coo,
        "gap_target": GAP,
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
