"""Smoke run of the system on one GPU: the Gram-space Krylov-CRN path end
to end at the full width of the bench problems, with every device code
path checked against a plain reference.

    python chip_smoke.py              # one GPU: all phases below
    python chip_smoke.py --four-gpu   # four GPUs: the row-sharded routes

Phases (one process, one card; any failure raises and exits non-zero):

  device     JAX's first device must be a GPU — never carries on on the CPU;
  precision  fp32 matrix products stay fp32 (no TF32) under the package's
             pinned default precision;
  kernel     the upper-triangle SYMV kernel (ops/symv.py) against XLA's
             matvec at HIGHEST and the fp64 host product, and timed;
  build      the fused device K build on rcv1-like against scipy fp64;
  race       bench.py's certified race on news20-like and rcv1-like;
  solvers    three steps of GramCRN, SSCN, COO CubicKrylov and dense-A
             CubicNewton at their datasets' full width.

The last line of standard output is one JSON object,
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent


def card_line() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            check=True, capture_output=True, text=True, timeout=60,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"unavailable ({type(e).__name__})"


def phase(name):
    """Decorator: print the phase's start, result and wall time."""
    def wrap(fn):
        def run(*a, **kw):
            print(f"[{name}] start", flush=True)
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            print(f"[{name}] ok in {time.perf_counter() - t0:.1f} s",
                  flush=True)
            return out
        return run
    return wrap


def rel(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def host_loss(A, b01, x) -> float:
    """Exact fp64 logistic loss mean((1-b) m - log sigmoid(m)), m = A x."""
    m = A @ np.asarray(x, np.float64)
    ls = np.where(m < 0, m - np.log1p(np.exp(m)), -np.log1p(np.exp(-m)))
    return float(np.mean((1.0 - b01) * m - ls))


def problem(name):
    from krylov_crn_tpu.data.synthetic import synthetic_logreg

    A, b = synthetic_logreg(name, seed=0)
    return A.tocsr(), b, np.full(A.shape[1], 0.5)


@phase("device")
def check_device(jax, card, count):
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"chip_smoke needs a GPU; JAX found "
                         f"{devs[0].platform!r}")
    if card.startswith("unavailable"):
        raise SystemExit("nvidia-smi did not report the card")
    if len(devs) < count:
        raise SystemExit(f"need {count} GPUs, JAX found {len(devs)}")


@phase("precision")
def check_precision(jax, jnp):
    rng = np.random.default_rng(0)
    a = rng.standard_normal((21, 10)).astype(np.float32)
    b = rng.standard_normal((10, 20480)).astype(np.float32)
    want = a.astype(np.float64) @ b.astype(np.float64)
    pinned = rel(jax.jit(jnp.matmul)(a, b), want)
    with jax.default_matmul_precision("default"):
        default = rel(jax.jit(jnp.matmul)(a, b), want)
    print(f"  (21x10)@(10x20480) fp32 rel err vs fp64: pinned "
          f"{pinned:.3g}, DEFAULT precision {default:.3g}")
    assert pinned <= 1e-6, f"fp32 product not fp32-accurate: {pinned:.3g}"


@phase("kernel")
def check_kernel(jax, jnp):
    from bench import kmatvec_times, symmetric_K
    from krylov_crn_tpu.data.synthetic import DATASET_SHAPES
    from krylov_crn_tpu.ops.gram import pad_rows
    from krylov_crn_tpu.ops.symv import symv, symv_supported

    for n in sorted({20480, pad_rows(DATASET_SHAPES["news20-like"][0])}):
        assert symv_supported(n, jnp.float32), f"symv not enabled at {n}"
        K = symmetric_K(n)
        q = jax.random.normal(jax.random.PRNGKey(2), (n,), jnp.float32)
        y_symv = np.asarray(symv(K, q), np.float64)
        y_xla = np.asarray(jnp.matmul(K, q, precision="highest"),
                           np.float64)
        Kh, qh = np.asarray(K), np.asarray(q, np.float64)
        y64 = np.concatenate([Kh[r:r + 2048].astype(np.float64) @ qh
                              for r in range(0, n, 2048)])
        del Kh
        e_symv, e_xla = rel(y_symv, y64), rel(y_xla, y64)
        t = kmatvec_times(K)
        print(f"  n={n}: rel err vs fp64 symv {e_symv:.3g}, XLA "
              f"{e_xla:.3g}; device time (profiler, median "
              f"[fastest, slowest window]):", flush=True)
        for route in ("symv", "xla"):
            lo, hi = t[f"{route}_ms_range"]
            print(f"    {route} {t[f'{route}_ms']:.4f} ms [{lo:.4f}, "
                  f"{hi:.4f}] {t[f'{route}_gbps']:.1f} GB/s "
                  f"({t[f'{route}_peak_frac']:.3f} of peak)", flush=True)
        assert e_symv <= 2e-6, f"symv rel err {e_symv:.3g} at n={n}"
        assert e_xla <= 2e-6, f"XLA matvec rel err {e_xla:.3g} at n={n}"
        del K


@phase("build")
def check_build(jax, jnp):
    from krylov_crn_tpu.models.logistic import canonicalize_labels
    from krylov_crn_tpu.ops.gram import build_gram_fused, pad_rows
    from krylov_crn_tpu.solvers.krylov_crn import _accum_dtype

    A, b, x0 = problem("rcv1-like")
    b = canonicalize_labels(b)
    n = A.shape[0]
    npad = pad_rows(n)
    ibuf = np.zeros(3 * npad + 3, np.float32)
    t0 = time.perf_counter()
    gd, _ = build_gram_fused(A, b, x0, ibuf, np.float32,
                             jnp.dtype(_accum_dtype(jnp.float32)))
    float(gd.K[0, 0])
    print(f"  rcv1-like fused build (incl. compile) "
          f"{time.perf_counter() - t0:.2f} s, n_pad {npad}, "
          f"symv={gd.symv}")
    sym = bool(jax.jit(lambda K: jnp.array_equal(K, K.T))(gd.K))
    rng = np.random.default_rng(3)
    errs = []
    for _ in range(3):
        q = np.zeros(npad, np.float32)
        q[:n] = rng.standard_normal(n)
        y = np.asarray(jnp.matmul(gd.K, jnp.asarray(q), precision="highest"),
                       np.float64)[:n]
        q64 = q[:n].astype(np.float64)
        errs.append(rel(y, A @ (A.T @ q64)))
    # sampled rows against the exact Gram of the stored fp32 values: the
    # build accumulates in fp64 and rounds once, so every entry is the
    # exact one correctly rounded (a biased fp32 accumulation reads
    # ~1e-6 relative here)
    A64 = A.astype(np.float64)
    rows = rng.choice(n, 16, replace=False)
    want = (A64[rows] @ A64.T).toarray()
    got = np.asarray(gd.K[rows, :n], np.float64)
    ulp = np.abs(got - want) / np.maximum(np.abs(want), 1e-300)
    bias = float(np.sum(got - want) / np.sum(np.abs(want)))
    print(f"  K @ q vs scipy fp64 A (A^T q): max rel err {max(errs):.3g}; "
          f"16 rows vs exact: max rel err {ulp.max():.3g} (half an fp32 "
          f"ulp is {2.0**-24:.3g}), mean signed {bias:.3g}; bitwise "
          f"symmetric: {sym}")
    assert sym, "device K is not bitwise symmetric"
    assert max(errs) <= 1e-6, f"K build rel err {max(errs):.3g}"
    assert ulp.max() <= 2.0**-24, "device K is not the rounded exact Gram"
    return gd


@phase("race")
def check_race(name):
    import bench

    A, b, x0 = problem(name)
    build_s, its, ts, fs, f_best = bench.bench_ours(A, b, x0)
    gaps = [f - f_best for f in fs]
    cross = next((k for k, g in enumerate(gaps) if g <= bench.GAP), None)
    print(f"  {name}: build {build_s:.3f} s, f* {f_best:.15g}, final gap "
          f"{gaps[-1]:.3g}, crossing "
          + (f"it {its[cross]} at race {ts[cross]:.3f} s"
             if cross is not None else "none"), flush=True)
    assert cross is not None, f"{name}: gap never reached {bench.GAP}"
    # up to the certified crossing every iterate's exact value is at or
    # below its predecessor's; after it, each stays certified (within
    # GAP of f*) — the fp32 floor leaves ~1e-9 wobbles there (PERF.md)
    rises = [(its[k + 1], fs[k + 1] - fs[k]) for k in range(len(fs) - 1)
             if fs[k + 1] > fs[k]]
    print(f"  {name}: {len(rises)} exact rises, largest "
          f"{max((r for _, r in rises), default=0.0):.3g} (iterations "
          f"{[it for it, _ in rises]}); largest gap after the crossing "
          f"{max(gaps[cross:]):.3g}")
    assert all(it > its[cross] for it, _ in rises), \
        f"{name}: exact values rose before the crossing"
    assert max(gaps[cross:]) <= bench.GAP, \
        f"{name}: an iterate after the crossing left the certified gap"


@phase("solvers")
def check_solvers(gd):
    from krylov_crn_tpu.models.logistic import (
        LogisticRegression,
        canonicalize_labels,
    )
    from krylov_crn_tpu.solvers import SSCN, CubicKrylov, CubicNewton
    from krylov_crn_tpu.solvers.crn_gram import GramCRN

    A, b, x0 = problem("rcv1-like")
    b01 = canonicalize_labels(b).astype(np.float64)
    runs = []
    loss = LogisticRegression(A, b, dtype=np.float32, want_dense=False)
    f0 = host_loss(A, b01, x0)
    crn = GramCRN(loss=loss, reg_coef=1e-3, tqdm=False, label="crn",
                  gram_data=gd)
    runs.append(("GramCRN rcv1-like", [f0] + _exact_fs(crn, x0)))
    sscn = SSCN(loss=LogisticRegression(A, b, dtype=np.float32,
                                        want_dense=False),
                reg_coef=1e-3, subspace_dim=10, tqdm=False, label="sscn")
    runs.append(("SSCN m=10 rcv1-like", _host_fs(sscn, A, b01, x0)))
    kry = CubicKrylov(loss=LogisticRegression(A, b, dtype=np.float32,
                                              want_dense=False),
                      reg_coef=1e-3, subspace_dim=10, tqdm=False,
                      label="coo")
    runs.append(("CubicKrylov COO rcv1-like", _host_fs(kry, A, b01, x0)))
    Aw, bw, xw = problem("w8a-like")
    lw = LogisticRegression(Aw, bw, dtype=np.float32, want_dense=True)
    crn_d = CubicNewton(loss=lw, reg_coef=1e-3, cubic_solver="full",
                        tqdm=False, label="crn-dense")
    runs.append(("CubicNewton dense w8a-like",
                 _host_fs(crn_d, Aw, canonicalize_labels(bw), xw)))
    for name, fs in runs:
        print(f"  {name}: exact f " + " -> ".join(f"{f:.12g}" for f in fs),
              flush=True)
        assert len(fs) == 4, f"{name}: expected 4 values, got {len(fs)}"
        assert all(b_ <= a_ for a_, b_ in zip(fs, fs[1:])), \
            f"{name}: exact loss rose"


def _exact_fs(alg, x0, steps=3):
    alg.run(x0=x0, it_max=steps)
    return list(alg.trace.metrics["exact_fs"])


def _host_fs(alg, A, b01, x0, steps=3):
    import jax.numpy as jnp

    alg.run(x0=jnp.asarray(x0, jnp.float32), it_max=steps)
    return [host_loss(A, b01, x) for x in alg.trace.xs]


@phase("four-gpu")
def check_four_gpu(jax, jnp):
    """Row-sharded routes over make_mesh(4) against one device."""
    from krylov_crn_tpu.models.logistic import (
        LogisticRegression,
        canonicalize_labels,
    )
    from krylov_crn_tpu.parallel.mesh import make_mesh
    from krylov_crn_tpu.parallel.sharded import build_sharded_dual
    from krylov_crn_tpu.solvers import CubicKrylov
    from krylov_crn_tpu.solvers.krylov_gram import GramKrylov

    import bench

    mesh = make_mesh(4)
    A, b, x0 = problem("news20-like")
    results = {}
    for label, m in (("sharded", mesh), ("single", None)):
        loss = LogisticRegression(A, b, dtype=np.float32, want_dense=False)
        alg = GramKrylov(loss=loss, reg_coef=1e-3, subspace_dim=bench.M,
                         tolerance=0, tqdm=False, label=label, mesh=m)
        t0 = time.perf_counter()
        alg.init_run(jnp.asarray(x0, np.float32), 42)
        alg.initialized = True
        float(alg.gd.K[0, 0])
        build_s = time.perf_counter() - t0
        if m is not None:
            devs = {s.device for s in alg.gd.K.addressable_shards}
            rows = {s.data.shape[0] for s in alg.gd.K.addressable_shards}
            print(f"  K shards on {len(devs)} devices, rows per shard "
                  f"{sorted(rows)}")
            assert len(devs) == 4, "K not spread over the four cards"
            assert rows == {alg.gd.K.shape[0] // 4}, "uneven K shards"
        alg.warm_fused(chunk=bench.CHUNK, certify=True)
        tr = alg.run_fused(x0, it_max=bench.OUR_IT_MAX, chunk=bench.CHUNK,
                           certify=True)
        results[label] = (list(tr.metrics["exact_its"]),
                          list(tr.metrics["exact_fs"]), build_s,
                          dict(zip(tr.its, tr.ts)))
        del alg, loss
    f_star = min(min(r[1]) for r in results.values())
    for label, (its, fs, build_s, it_to_t) in results.items():
        cross = next((it for it, f in zip(its, fs)
                      if f - f_star <= bench.GAP), None)
        results[label] += (cross,)
        print(f"  news20-like GramKrylov {label}: build {build_s:.2f} s "
              f"(incl. compile), race after warm-up: crossing it {cross} "
              f"at {it_to_t.get(cross, float('nan')):.4f} s, "
              f"{bench.OUR_IT_MAX} its in {it_to_t[max(it_to_t)]:.4f} s, "
              f"final exact f {fs[-1]:.15g}", flush=True)
    s, one = results["sharded"], results["single"]
    assert s[4] is not None and s[4] == one[4], \
        f"certified crossings differ: sharded {s[4]} vs single {one[4]}"
    assert abs(s[1][-1] - one[1][-1]) <= 1e-8, "final exact f differs"

    A, b, x0 = problem("rcv1-like")
    fs = {}
    for label, m in (("sharded", mesh), ("single", None)):
        data = (build_sharded_dual(A, m, dtype=np.float32) if m is not None
                else A)
        kry = CubicKrylov(loss=LogisticRegression(data, b, dtype=np.float32,
                                                  want_dense=False),
                          reg_coef=1e-3, subspace_dim=bench.M, tqdm=False,
                          label=label)
        kry.run(x0=jnp.asarray(x0, jnp.float32), it_max=1)
        fs[label] = host_loss(A, canonicalize_labels(b),
                              np.asarray(kry.trace.xs[-1])[:A.shape[1]])
        print(f"  rcv1-like COO CubicKrylov step {label}: exact f "
              f"{fs[label]:.15g}")
    assert abs(fs["sharded"] - fs["single"]) <= 1e-6 * abs(fs["single"]), \
        "sharded COO step disagrees with the single-device step"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-gpu", action="store_true",
                    help="run only the row-sharded routes on four GPUs")
    args = ap.parse_args(argv)
    count = 4 if args.four_gpu else 1

    import jax
    import jax.numpy as jnp

    import krylov_crn_tpu
    from krylov_crn_tpu.config import (
        compilation_cache_dir,
        enable_compilation_cache,
    )

    pkg_root = Path(krylov_crn_tpu.__file__).resolve().parent.parent
    if pkg_root != HERE:
        raise SystemExit(f"krylov_crn_tpu imported from {pkg_root}, "
                         f"not from this checkout ({HERE})")
    enable_compilation_cache()
    dev = jax.devices()[0]
    card = card_line()
    print(f"card: {card}")
    print(f"jax {jax.__version__}, device {dev.platform} "
          f"{dev.device_kind!r} x{len(jax.devices())}, compile cache "
          f"{compilation_cache_dir()}", flush=True)
    check_device(jax, card, count)
    if args.four_gpu:
        check_four_gpu(jax, jnp)
    else:
        check_precision(jax, jnp)
        check_kernel(jax, jnp)
        gd = check_build(jax, jnp)
        for name in ("news20-like", "rcv1-like"):
            check_race(name)
        check_solvers(gd)
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices()[:count])}}))


if __name__ == "__main__":
    sys.exit(main())
