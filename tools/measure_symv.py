"""Tune the upper-triangle SYMV kernel (ops/symv.py) on the GPU: time each
(tile, rows, num_warps, num_stages) configuration against XLA's matvec
at one n, and check each against the fp64 product.

The op is bandwidth-bound; the kernel streams n(n+1)/2 elements instead
of n^2, so the speed-of-light ratio is ~2x. Timing: the kernels' own
durations from the profiler, median of five windows of ten calls
(utils/profiling.kernel_time_per_call).

Usage: python tools/measure_symv.py [--n 20480] [--configs 256,32,4,3 ...]
       python tools/measure_symv.py --race [news20-like rcv1-like]
Prints one JSON line per configuration, then the best. ``--race`` instead
runs bench.py's certified race (bench_ours) with the kernel on and off in
turns (on, off, off, on) and prints each attempt's build, crossing
iteration and time to the 1e-8 gap against the shared f*.
"""
from __future__ import annotations

import argparse
import functools
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

DEFAULT_CONFIGS = [
    (256, 32, 4, 3), (256, 16, 4, 3), (256, 64, 8, 3), (256, 32, 8, 2),
    (128, 32, 4, 3), (128, 16, 4, 4), (128, 64, 8, 3), (512, 16, 8, 3),
]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=20480)
    ap.add_argument("--configs", nargs="*", default=None,
                    help="tile,rows,num_warps,num_stages tuples")
    ap.add_argument("--race", nargs="*", default=None,
                    help="end-to-end A/B on these datasets")
    args = ap.parse_args()
    if args.race is not None:
        return race_ab(args.race or ["news20-like", "rcv1-like"])

    import jax
    import jax.numpy as jnp

    from bench import symmetric_K
    from krylov_crn_tpu.config import enable_compilation_cache
    from krylov_crn_tpu.ops import symv as symv_mod
    from krylov_crn_tpu.utils.profiling import (
        kernel_time_per_call,
        peak_bytes_per_s,
    )

    enable_compilation_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"measure_symv needs the GPU; JAX found "
                         f"{dev.platform!r}")
    peak = peak_bytes_per_s()
    n = args.n
    K = symmetric_K(n)
    w = jax.random.normal(jax.random.PRNGKey(1), (n,), jnp.float32)
    y64 = np.zeros(n)
    Kh = np.asarray(K)
    wh = np.asarray(w, np.float64)
    for r in range(0, n, 2048):
        y64[r:r + 2048] = Kh[r:r + 2048].astype(np.float64) @ wh
    del Kh

    def median(secs):
        return secs[len(secs) // 2]

    xla_s = median(kernel_time_per_call(jax.jit(lambda K, v: K @ v),
                                        (K, w)))
    print(json.dumps({"route": "xla", "n": n, "ms": xla_s * 1e3,
                      "gbps": 4 * n * n / xla_s / 1e9,
                      "peak_frac": 4 * n * n / xla_s / peak}), flush=True)
    configs = ([tuple(int(v) for v in c.split(",")) for c in args.configs]
               if args.configs else DEFAULT_CONFIGS)
    defaults = symv_mod.NUM_WARPS, symv_mod.NUM_STAGES
    best = None
    for tile, rows, nw, ns in configs:
        if n % (2 * tile):
            continue
        rec = {"route": "symv", "n": n, "tile": tile, "rows": rows,
               "num_warps": nw, "num_stages": ns}
        # the launch parameters are module constants read at trace time:
        # set them, and trace the unjitted body afresh for each config
        symv_mod.NUM_WARPS, symv_mod.NUM_STAGES = nw, ns
        f = jax.jit(functools.partial(symv_mod.symv.__wrapped__, tile=tile,
                                      rows=rows))
        try:
            y = np.asarray(f(K, w), np.float64)
            rec["rel_err_fp64"] = float(np.linalg.norm(y - y64)
                                        / np.linalg.norm(y64))
            sec = median(kernel_time_per_call(f, (K, w)))
        except Exception as e:  # a config the compiler refuses is data
            rec["error"] = f"{type(e).__name__}: {str(e)[:300]}"
            print(json.dumps(rec), flush=True)
            continue
        finally:
            symv_mod.NUM_WARPS, symv_mod.NUM_STAGES = defaults
        nbytes = symv_mod.symv_bytes(n, tile)
        rec.update(ms=sec * 1e3, gbps=nbytes / sec / 1e9,
                   peak_frac=nbytes / sec / peak,
                   speedup_vs_xla=xla_s / sec)
        print(json.dumps(rec), flush=True)
        if best is None or sec < best[0]:
            best = (sec, rec)
    print(json.dumps({"best": best[1] if best else None,
                      "device_kind": dev.device_kind}))


def race_ab(names):
    """The certified race with the SYMV kernel on and off, in turns."""
    import jax

    import bench
    from krylov_crn_tpu.ops import symv as symv_mod

    supported = symv_mod.symv_supported
    for name in names:
        A, b, x0 = bench._problem(name)
        runs = []
        # the first attempt of a process runs slow whatever the route
        # (bench.race scores min-of-two for it): one discarded warm-up
        bench.bench_ours(A, b, x0)
        for on in (True, False, False, True):
            symv_mod.symv_supported = (supported if on
                                       else lambda n, dtype: False)
            try:
                build_s, its, ts, fs, f_best = bench.bench_ours(A, b, x0)
            finally:
                symv_mod.symv_supported = supported
            runs.append((on, build_s, its, ts, fs, f_best))
        f_star = min(r[5] for r in runs)
        for on, build_s, its, ts, fs, _ in runs:
            k = next((k for k, f in enumerate(fs)
                      if f - f_star <= bench.GAP), None)
            print(json.dumps({
                "dataset": name, "symv": on, "build_s": build_s,
                "crossing_it": None if k is None else its[k],
                "race_s": None if k is None else ts[k],
                "total_s": None if k is None else build_s + ts[k],
                "device_kind": jax.devices()[0].device_kind}), flush=True)


if __name__ == "__main__":
    main()
