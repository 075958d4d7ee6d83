"""Round-5 rcv1 race instrumentation: phase-by-phase timing of the
driver-protocol race (bench.py bench_ours) plus A/B of the two round-5
levers:

  --warm-build   warm the fused-build executables pre-t0 with
                 device-created zeros (ops.gram.warm_build_gram_fused) —
                 excludes the per-program executable load from the
                 timed build, the same treatment warm_fused
                 already gives the race programs;
  --chunk N      iterations per multistep dispatch. chunk=32 needs a
                 SECOND dispatch to certify the measured it~33 crossing
                 (its timestamp then inherits a share of chunk 2's
                 dispatch+exec); chunk>=40 certifies it inside chunk 1
                 at its interpolated fraction.

Usage: python tools/measure_race_r5.py [--dataset rcv1-like] [--chunk 40]
       [--warm-build] [--reps 3]
Prints one JSON line per rep: phases + certified crossing time.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

M = 10
GAP = 1e-8


def run_once(name, chunk, warm_build, it_max):
    import jax
    import jax.numpy as jnp

    from krylov_crn_tpu.config import enable_compilation_cache

    enable_compilation_cache()
    from krylov_crn_tpu.data.synthetic import synthetic_logreg
    from krylov_crn_tpu.models.logistic import LogisticRegression
    from krylov_crn_tpu.ops.gram import warm_build_gram_fused
    from krylov_crn_tpu.solvers.krylov_crn import _accum_dtype
    from krylov_crn_tpu.solvers.krylov_gram import GramKrylov

    out = {"chunk": chunk, "warm_build": warm_build}
    A, b = synthetic_logreg(name, seed=0)
    x0 = np.ones(A.shape[1]) * 0.5
    dtype = np.float32

    loss = LogisticRegression(A, b, dtype=dtype, want_dense=False)
    alg = GramKrylov(loss=loss, reg_coef=1e-3, subspace_dim=M, tolerance=0,
                     tqdm=False, label="gram")

    if warm_build:
        t = time.perf_counter()
        ok = warm_build_gram_fused(A, dtype, jnp.dtype(_accum_dtype(
            jnp.float32)), low_res_lanczos=False)
        out["warm_build_s"] = round(time.perf_counter() - t, 3)
        out["warm_build_panel_path"] = bool(ok)

    t0 = time.perf_counter()
    alg.init_run(jnp.asarray(x0, dtype), 42)
    alg.initialized = True
    out["build_s"] = round(time.perf_counter() - t0, 3)

    t = time.perf_counter()
    alg.warm_fused(chunk=chunk, certify=True)
    out["warm_fused_s"] = round(time.perf_counter() - t, 3)

    trace = alg.run_fused(x0, it_max=it_max, chunk=chunk, certify=True)
    ex_its = list(trace.metrics["exact_its"])
    fs = [float(v) for v in trace.metrics["exact_fs"]]
    it_to_t = dict(zip(trace.its, trace.ts))
    ts = [float(it_to_t[i]) for i in ex_its]
    f_best = min(fs)
    # provisional f* = own best (the real bench folds in the m=20 run and
    # the reference's best; for phase attribution the own-best crossing
    # is the comparable quantity across variants)
    cross_it, cross_t = None, None
    for i, t_, f_ in zip(ex_its, ts, fs):
        if f_ - f_best <= GAP:
            cross_it, cross_t = i, t_
            break
    out["race_total_s"] = round(ts[-1], 3)
    out["cross_it"] = cross_it
    out["cross_t"] = round(cross_t, 3) if cross_t is not None else None
    out["ours_s"] = (round(out["build_s"] + cross_t, 3)
                     if cross_t is not None else None)
    out["final_gap"] = fs[-1] - f_best  # fs non-empty (min(fs) above)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="rcv1-like")
    ap.add_argument("--chunk", type=int, default=40)
    ap.add_argument("--warm-build", action="store_true")
    ap.add_argument("--it-max", type=int, default=80)
    ap.add_argument("--reps", type=int, default=1)
    args = ap.parse_args()
    import jax.numpy as jnp

    float(jnp.zeros(8)[0])  # absorb client init
    for _ in range(args.reps):
        print(json.dumps(run_once(args.dataset, args.chunk,
                                  args.warm_build, args.it_max)),
              flush=True)


if __name__ == "__main__":
    main()
